"""PyTorch port's host modules against the JAX package: TPS and PTN
codecs, the `Game` facade, move-rejection diagnosis, the analysis
renderer, and the TEI / analysis command lines on the CPU.

The inputs are those of tests/test_tps.py, test_ptn.py, test_errors.py
and test_analysis.py; strings and states must be exactly equal (a port
state is a batch of one: its fields are compared with the batch axis
dropped).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from tak_tpu import analysis as jax_analysis
from tak_tpu import errors as jax_errors
from tak_tpu.actions import parse_move
from tak_tpu.engine import ptn as jax_ptn
from tak_tpu.engine import tps as jax_tps
from tak_tpu.engine.core import get_engine as jax_engine
from tak_tpu.game import Game as JaxGame
from tak_tpu.game import IllegalMove as JaxIllegalMove
from tak_tpu_torch import analysis as port_analysis
from tak_tpu_torch import errors as port_errors
from tak_tpu_torch.engine import ptn as port_ptn
from tak_tpu_torch.engine import tps as port_tps
from tak_tpu_torch.engine.core import get_engine as port_engine
from tak_tpu_torch.game import Game, IllegalMove
from tak_tpu_torch.types import FIELDS, ONGOING

from tests.test_errors import CASES as ERROR_CASES
from tests.test_ptn import PTN_FILE
from tests.test_tps import SEEDS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_state_equal(jax_state, port_state, msg=""):
    got = port_state.to_numpy()
    for f in FIELDS:
        assert got[f].shape[0] == 1, f
        np.testing.assert_array_equal(
            got[f][0], np.asarray(getattr(jax_state, f)),
            err_msg=f"{msg}: {f}")


def both_games(n, moves, half_komi=0):
    return (JaxGame.from_ptn_moves(n, moves, half_komi),
            Game.from_ptn_moves(n, moves, half_komi, device="cpu"))


# -- TPS -----------------------------------------------------------------

COMPLICATED = [
    "e1", "f2", "Sb5", "Cd6", "d3", "d4", "Sc1", "c3", "Ca6", "f6",
    "b1", "Sb4", "b3", "b2", "d5", "e1>", "d3>", "b2<", "Se2", "f4",
    "f2-", "c3-", "e4", "Sa5", "c3", "c5", "b5>", "a2-", "Sb5", "e6",
    "2c5-11", "d6>", "d5<", "b2", "b3-", "b3", "e3+", "e6>", "a4",
    "Sf5", "d6", "e6-", "f1+", "d4<", "d3", "d4", "b2>", "e3",
    "2e4+11", "a1>", "2c3>11", "Sc6", "d3-", "e4", "d5", "a2", "d5-",
    "a2+", "2c2+11", "c2", "d1", "c3>", "3c4-", "2d3-11", "Sa2", "c4",
    "2d2<11", "Sd2", "d3", "b3-", "f2+", "b3", "a1", "e4+", "d5",
    "2e5<11", "2d4>", "2b2>", "d5-", "d2+", "e4+", "d2", "c3<", "c3<",
    "e2<", "c2+", "c2<", "e2", "d5>", "c3<", "b2>", "d5", "d4>",
    "d5+", "c2<", "d5", "b2-", "d5>", "c2+", "b3>", "2d2<", "d2",
    "3c2+21", "d4", "e4<", "d5", "c2",
]


def test_tps_complicated_board():
    jg, pg = both_games(6, COMPLICATED)
    want = ("1C,x,2S,12,1,22C/2S,1S,12,2,2112,2S/1,2S,21S,21,2,2/"
            "2,212,21222,12S,21S,1/1S,2,1,2,2,x/1,121,1S,12,x,2 2 54")
    assert str(pg) == str(jg) == want
    assert_state_equal(jg.state, pg.state, "played")
    assert_state_equal(jax_tps.tps_to_state(jg.engine, want, 3),
                       port_tps.tps_to_state(pg.engine, want, 3, "cpu"),
                       "parsed")


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_tps_playout(seed):
    """The deterministic playouts of test_tps.py (40 plies of each), both
    packages in lockstep: equal legal move lists, states and TPS at every
    ply, and TPS -> state -> TPS round trips."""
    jg, pg = JaxGame(5), Game(5, device="cpu")
    for _ in range(40):
        if jg.result != ONGOING:
            break
        acts = pg.legal_actions()
        np.testing.assert_array_equal(acts, jg.legal_actions())
        a = int(acts[seed % len(acts)])
        jg.play_action(a, check=False)
        pg.play_action(a, check=False)
        tps = str(pg)
        assert tps == str(jg)
        assert_state_equal(jg.state, pg.state, tps)
        back = port_tps.tps_to_state(pg.engine, tps, device="cpu")
        assert port_tps.state_to_tps(pg.engine, back) == tps
        assert_state_equal(jax_tps.tps_to_state(jg.engine, tps), back, tps)
    assert pg.result == jg.result == pg.compute_result()


@pytest.mark.parametrize("bad", ["x5/x5/x5/x5 1 1", "x5/x5/x5/x5/x4 1 1",
                                 "x5/x5/x5/x5/x5 1"])
def test_tps_malformed(bad):
    with pytest.raises(ValueError):
        jax_tps.tps_to_state(jax_engine(5), bad)
    with pytest.raises(ValueError):
        port_tps.tps_to_state(port_engine(5), bad, device="cpu")


# -- PTN -----------------------------------------------------------------

def _tps_after(moves):
    return str(JaxGame.from_ptn_moves(5, moves))


PTN_TEXTS = {
    "headers_and_moves": PTN_FILE,
    "tps_start": (f'[Size "5"]\n[TPS "{_tps_after(["a1", "e5", "c3"])}"]\n'
                  "2. -- d3\n3. c4 b4\n"),
    "bare": "1. a1 e5\n2. Cc3 Sd4 0-1\n",
}


@pytest.mark.parametrize("case", list(PTN_TEXTS))
def test_parse_ptn(case):
    text = PTN_TEXTS[case]
    jstate, jmoves = jax_ptn.parse_ptn(jax_engine(5), text)
    pstate, pmoves = port_ptn.parse_ptn(port_engine(5), text, "cpu")
    assert_state_equal(jstate, pstate, case)
    assert [str(m) for m in pmoves] == [str(m) for m in jmoves]
    assert len(pmoves) >= 3
    # replaying from the parsed state stays equal
    jg, pg = JaxGame(5, state=jstate), Game(5, state=pstate)
    for m in pmoves:
        jg.play(str(m))
        pg.play(str(m))
    assert_state_equal(jg.state, pg.state, case + " replayed")


def test_parse_ptn_size_mismatch():
    with pytest.raises(ValueError, match="size mismatch"):
        port_ptn.parse_ptn(port_engine(6), '[Size "5"]\n1. a1 b1\n', "cpu")


@pytest.mark.parametrize("suffix", [";10;1;11;0;3", ""])
def test_parse_position(suffix):
    text = _tps_after(["a1", "e5"]) + suffix
    jstate = jax_ptn.parse_position(jax_engine(5), text)
    pstate = port_ptn.parse_position(port_engine(5), text, "cpu")
    assert_state_equal(jstate, pstate, text)
    assert int(pstate.half_komi[0]) == (3 if suffix else 4)


# -- Game and errors ---------------------------------------------------------

def test_game_facade():
    jg, pg = both_games(5, ["a1", "e5", "c3", "Cc4", "c3>"], half_komi=4)
    assert (pg.ply, pg.to_move, pg.result) == (jg.ply, jg.to_move, jg.result)
    assert [str(m) for m in pg.possible_moves()] == [
        str(m) for m in jg.possible_moves()]
    np.testing.assert_array_equal(pg.legal_mask(), jg.legal_mask())
    clone = pg.clone()
    clone.play("a2")
    assert clone.ply == pg.ply + 1 and str(pg) == str(jg)
    assert str(Game.with_komi(5, 2, "cpu").state.half_komi.tolist()) == "[4]"
    # a finished game rejects further moves
    jw, pw = both_games(3, ["a1", "c3", "c2", "a2", "c1"])
    assert pw.result == jw.result != ONGOING
    with pytest.raises(IllegalMove, match="game is over"):
        pw.play("a2")
    with pytest.raises(ValueError):
        pg.play("z9")


@pytest.mark.parametrize("setup,move,err", ERROR_CASES,
                         ids=[c[2].name for c in ERROR_CASES])
def test_diagnosis(setup, move, err):
    jg, pg = both_games(5, setup)
    got = port_errors.diagnose(pg, parse_move(move))
    assert got is not None and got.name == err.name
    assert got.value == jax_errors.diagnose(jg, parse_move(move)).value
    with pytest.raises(JaxIllegalMove) as jerr:
        jg.play(move)
    with pytest.raises(IllegalMove) as perr:
        pg.play(move)
    assert str(perr.value) == str(jerr.value)


def test_no_capstone_and_legal_move():
    jg, pg = both_games(5, ["a1", "e5", "Cc3", "Cc4"])
    assert (port_errors.diagnose(pg, parse_move("Cd4")).name
            == jax_errors.diagnose(jg, parse_move("Cd4")).name
            == "NO_CAPSTONE")
    assert port_errors.diagnose(pg, parse_move("d4")) is None
    assert [e.name for e in port_errors.PlayError] == [
        e.name for e in jax_errors.PlayError]
    assert [e.value for e in port_errors.PlayError] == [
        e.value for e in jax_errors.PlayError]


# -- analysis renderer ---------------------------------------------------------

def _start_as_black(mod):
    a = mod.Analysis(6, 4, start_ply=5)
    a.add_move("Se4", mod.MoveInfo(mov="Se4", visits=0, reward=-1.0,
                                   policy=1.0), 0.0)
    a.add_move_without_info("c6")
    a.add_move_without_info("e4+")
    return a


def _marks_and_branches(mod):
    a = mod.Analysis(6, 5)
    a.add_setting("Player1", "x")
    a.update(mod.NodeDebugInfo([
        mod.MoveInfo("a1", 100, 0.1, 0.5, [("f6", 20_000), ("b2", 11_000),
                                            ("c3", 5)]),
        mod.MoveInfo("b1", 95, 0.05, 0.3, [("f1", 12_000), ("e2", 10_001)]),
    ]), "a1")
    a.update(mod.NodeDebugInfo([
        mod.MoveInfo("f6", 90, 0.8, 0.4),
        mod.MoveInfo("e6", 89, 0.7, 0.2, [("a2", 30_000)]),
    ]), "f6")
    a.update(mod.NodeDebugInfo([mod.MoveInfo("b2", 10, -0.9, 0.1)]), "c3")
    return a


def _graph_contract(mod):
    a = mod.Analysis(6, 4)
    a.add_move("a1", mod.MoveInfo("a1", 10, 0.0, 0.1), 0.123)
    a.add_move("f6", mod.MoveInfo("f6", 10, 0.0, 0.1), -0.456)
    a.add_move("b2", mod.MoveInfo("b2", 10, 0.0, 0.1), 0.789)
    return a


@pytest.mark.parametrize("build", [_start_as_black, _marks_and_branches,
                                   _graph_contract])
def test_analysis_text(build):
    want = str(build(jax_analysis))
    assert str(build(port_analysis)) == want
    assert want.startswith('[Size "6"]')
    if build is _marks_and_branches:
        assert "a1??" in want and "{0_b1}" in want and "{1_e6}" in want
        info = port_analysis.NodeDebugInfo(
            [port_analysis.MoveInfo("a1", 3, 0.5, 0.25, [("b2", 2)])])
        ref = jax_analysis.NodeDebugInfo(
            [jax_analysis.MoveInfo("a1", 3, 0.5, 0.25, [("b2", 2)])])
        assert info.format(10) == ref.format(10)
        assert info.maybe_flip(True).eval() == ref.maybe_flip(True).eval()
        assert (port_analysis.NodeDebugInfo([]).format()
                == jax_analysis.NodeDebugInfo([]).format())


# -- command lines on the CPU ----------------------------------------------------

def test_tei_dialogue_over_pipe():
    """A TEI dialogue with `python -m tak_tpu_torch.cli.tei --cpu`
    through a process pipe: handshake -> position -> go -> bestmove ->
    quit.  Protocol shape only, no timing."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "tak_tpu_torch.cli.tei", "random", "--size",
         "3", "--cpu", "-b", "8"],
        cwd=REPO, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
    )
    script = (
        "tei\n"
        "isready\n"
        "teinewgame 3\n"
        "setoption name HalfKomi value 2\n"
        "position startpos moves a1 c3\n"
        "go wtime 1000 btime 1000 winc 100 binc 100\n"
        "position tps x3/x,1,x/2,x2 2 2\n"
        "go wtime 500 btime 500 winc 0 binc 0\n"
        "quit\n"
    )
    try:
        out, err = proc.communicate(script, timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, err[-2000:]
    lines = out.splitlines()
    assert any(l.startswith("id name") for l in lines), out
    assert "teiok" in lines and "readyok" in lines, out
    info = [l for l in lines if l.startswith("info")]
    assert info and any("nps" in l for l in info), out
    best = [l.split()[1] for l in lines if l.startswith("bestmove ")]
    assert len(best) == 2, out
    g = Game.from_ptn_moves(3, ["a1", "c3"], device="cpu")
    assert best[0] in [str(m) for m in g.possible_moves()], out
    g = Game(3, state=port_tps.tps_to_state(port_engine(3),
                                            "x3/x,1,x/2,x2 2 2", 2, "cpu"))
    assert best[1] in [str(m) for m in g.possible_moves()], out


def test_analysis_cli_ptn_file(tmp_path):
    """`analysis_cli --ptn-file --cpu` replays a PTN file, prints a table
    per move and writes the annotated PTN."""
    ptn = tmp_path / "game.ptn"
    ptn.write_text('[Size "3"]\n[Komi "2"]\n\n1. a1 c3\n2. b2 a2\n')
    out_file = tmp_path / "analysis.ptn"
    proc = subprocess.run(
        [sys.executable, "-m", "tak_tpu_torch.cli.analysis_cli", "3",
         "random", "--cpu", "-b", "8", "--ptn-file", str(ptn),
         "--think-seconds", "0", "--out", str(out_file)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.count("playing ") == 4, proc.stdout
    assert "turn      visited   reward   policy | continuation" in proc.stdout
    text = out_file.read_text()
    assert text.startswith('[Size "3"]\n[Komi "2"]\n1. a1')
    assert "2. b2" in text and "{r: " in text and " a2" in text
    # the written file parses back to the same four moves
    _, moves = port_ptn.parse_ptn(port_engine(3), text, "cpu")
    assert [str(m) for m in moves[:4]] == ["a1", "c3", "b2", "a2"]
