"""The port's search-strength guardrails (`tak_tpu_torch/tools/`) against
the JAX package and against the repository's committed A/B records.

  (a) `wilson_ci` and `sprt_llr` against `runs/strength_ab_r5.jsonl`;
  (b) each preset's (A, B) `SearchConfig`s against a table written out
      from `tools/strength_ab.py:205-222`;
  (c) `quality.root_policies` against the JAX search on the same
      numpy-seeded 4x4 midgame positions with the exact fake network of
      `tests/test_torch_search.exact_eval_pair`, 64 sims in waves of 4:
      the recycled pool tier (the JAX side's Pallas kernels in interpret
      mode), the large-tree tier ("pallas_hbm") and the "xla" path; the
      root visits equal (tolerance 0), so the normalized policies too;
  (d) the port's `pit` with `search_b` (the pool tier against the
      large-tree tier) against the JAX `pit`: equal moves at every search
      and equal `PitResult`;
  (e) `strength_ab.main` on the CPU: a record with the reference's keys,
      `--sprt` stopping at a decision or `--max-games`, and
      `--subprocess-rounds` writing one line a round and printing their
      sum;
  (f) each `quality_*` main on the CPU at a tiny size prints its lines.

The JAX side is built inline, as `tools/quality_recycle.py:33-48` builds
it: importing `tools/*.py` would set `jax_default_prng_impl="rbg"` for the
rest of the worker.
"""

import dataclasses
import json
import math
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tak_tpu.engine.core import get_engine as jax_engine
from tak_tpu.mcts.search import MCTS as JaxMCTS
from tak_tpu.mcts.search import SearchConfig as JaxSearchConfig
from tak_tpu.mcts.tree import root_visit_counts as jax_root_visit_counts
from tak_tpu.pit import PitConfig as JaxPitConfig
from tak_tpu.pit import pit as jax_pit
from tak_tpu.types import ONGOING
from tak_tpu_torch.engine.core import get_engine
from tak_tpu_torch.mcts.search import MCTS, SearchConfig
from tak_tpu_torch.mcts.tree import root_visit_counts
from tak_tpu_torch.pit import PitConfig, pit
from tak_tpu_torch.tools import (
    quality,
    quality_control,
    quality_k,
    quality_recycle,
    strength_ab,
)
from tak_tpu_torch.types import FIELDS, GameState

from tests.test_torch_search import exact_eval_pair

REPO = Path(__file__).resolve().parents[1]
RECORD_KEYS = {"preset", "size", "sims", "sims_b", "games", "seed", "model",
               "max_plies", "wins", "losses", "draws", "unfinished",
               "win_rate", "ci95", "seconds"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the tier-1 run
    shares the host's cores among its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- (a) the statistics ---------------------------------------------------

def test_wilson_and_sprt_match_the_r5_record():
    """r5's round 1 (14-7-11): CI95 [0.454, 0.828], LLR 1.40 (1.405 to
    three places) between p0 0.45 and p1 0.55, thresholds +-2.944 at
    alpha = beta = 0.05; no decisive game gives the whole interval."""
    rec = json.loads((REPO / "runs" / "strength_ab_r5.jsonl")
                     .read_text().splitlines()[0])
    w, l = rec["wins"], rec["losses"]
    lo, hi = strength_ab.wilson_ci(w, w + l)
    assert [round(lo, 3), round(hi, 3)] == rec["ci95"] == [0.454, 0.828]
    assert round(w / (w + l), 3) == rec["win_rate"]
    sprt = rec["sprt"]
    llr = strength_ab.sprt_llr(w, l, sprt["p0"], sprt["p1"])
    assert round(llr, 3) == 1.405 and round(llr, 2) == sprt["llr"]
    upper, lower = strength_ab.sprt_bounds(sprt["alpha"], sprt["beta"])
    assert round(upper, 3) == 2.944 and round(lower, 3) == -2.944
    assert lower < llr < upper
    assert strength_ab.wilson_ci(0, 0) == (0.0, 1.0)
    assert strength_ab.wilson_ci(5, 5)[1] == 1.0
    assert strength_ab.wilson_ci(0, 5)[0] == 0.0


# -- (b) the presets ------------------------------------------------------

# (preset, side): the fields `tools/strength_ab.py:205-222` sets, at
# sims 2000, sims_b 1000, budget 1280, waves 64/8
REC = dict(max_children=32, recycle=True, node_budget=1280, scan_chunk=512)
PRESET_TABLE = {
    ("recycle", "a"): dict(num_sims=2000, wave_size=16, **REC),
    ("recycle", "b"): dict(num_sims=1000, wave_size=16, max_children=128,
                           node_budget=2002, backend="pallas_hbm"),
    ("wave", "a"): dict(num_sims=2000, wave_size=32, **REC),
    ("wave", "b"): dict(num_sims=1000, wave_size=16, **REC),
    ("waves", "a"): dict(num_sims=2000, wave_size=64, **REC),
    ("waves", "b"): dict(num_sims=1000, wave_size=8, **REC),
    ("wave1", "a"): dict(num_sims=2000, wave_size=16, **REC),
    ("wave1", "b"): dict(num_sims=1000, wave_size=1, **REC),
}


@pytest.mark.parametrize("preset", strength_ab.PRESETS)
def test_preset_configs(preset):
    a, b = strength_ab.preset_configs(preset, 2000, 1000, 1280, 64, 8)
    assert a == SearchConfig(**PRESET_TABLE[(preset, "a")])
    assert b == SearchConfig(**PRESET_TABLE[(preset, "b")])
    # every field the table leaves out keeps SearchConfig's default
    for side, cfg in (("a", a), ("b", b)):
        for f in dataclasses.fields(SearchConfig):
            if f.name not in PRESET_TABLE[(preset, side)]:
                assert getattr(cfg, f.name) == f.default, (side, f.name)
    with pytest.raises(ValueError):
        strength_ab.preset_configs("nope", 1, 1, 1)


# -- (c) root policies against the JAX search ---------------------------------

N, GAMES, PLIES, SIMS, WAVE = 4, 3, 6, 64, 4
SETUPS = {
    # the recycled pool, two chunks of 8 waves, the pool full after 6
    "pool": dict(k=8, budget=24, recycle=True, backend="pallas", chunk=32),
    "hbm": dict(k=16, budget=2 * SIMS + 2, backend="pallas_hbm"),
    "xla": dict(k=8, backend="xla"),
}


def midgame_states(engine, games, plies, seed):
    """JAX `GameState`s after `plies` numpy-seeded random legal moves,
    finished games frozen (`tools/quality_recycle.py:63-75` with numpy
    draws)."""
    rng = np.random.default_rng(seed)
    states = engine.initial_batch(games, 4)
    for _ in range(plies):
        legal = np.asarray(jax.vmap(engine.legal_mask)(states))
        acts = np.array([rng.choice(np.nonzero(row)[0]) for row in legal],
                        np.int32)
        nxt = engine.batched_step(states, jnp.asarray(acts))
        live = states.result == ONGOING
        states = jax.tree.map(
            lambda new, old: jnp.where(
                live.reshape((-1,) + (1,) * (new.ndim - 1)), new, old),
            nxt, states)
    return states


@pytest.mark.parametrize("setup", list(SETUPS))
def test_root_policies_match_jax(setup):
    s = SETUPS[setup]
    engine = jax_engine(N)
    jax_eval, torch_eval = exact_eval_pair(engine.num_actions)
    states = midgame_states(engine, GAMES, PLIES, seed=11)
    assert (np.asarray(states.ply) == PLIES).all()

    jm = JaxMCTS(engine, jax_eval, JaxSearchConfig(
        num_sims=SIMS, wave_size=WAVE, max_children=s["k"],
        node_budget=s.get("budget"), recycle=s.get("recycle", False),
        backend=s["backend"], scan_chunk=s.get("chunk"), topk_impl="exact"))
    jt = jm.run_sims(None, jm.prepare_root(None, jm.init_batch(states)))
    want = np.asarray(jax.vmap(jax_root_visit_counts)(jt))

    port = get_engine(N)
    kw = {k: v for k, v in s.items()}
    _, tree = quality.search(port, torch_eval, None,
                             GameState.from_numpy(states), SIMS, WAVE, **kw)
    np.testing.assert_array_equal(root_visit_counts(tree).numpy(), want)
    net = types.SimpleNamespace(policy_eval_states=torch_eval)
    got = quality.root_policies(port, net, None, GameState.from_numpy(states),
                                SIMS, WAVE, **kw)
    v = want.astype(np.float64)
    np.testing.assert_array_equal(got, v / v.sum(-1, keepdims=True))
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=1e-12)
    if setup == "pool":   # the pool was full: the search recycled
        assert (tree.next_free.numpy() == s["budget"]).all()
    # a probe against itself: TV 0, top-1 agreement 1
    assert quality.tv_top1(got, got) == (0.0, 0.0, 1.0)


def test_tv_top1():
    p = np.array([[0.5, 0.5, 0.0], [1.0, 0.0, 0.0]])
    q = np.array([[0.5, 0.0, 0.5], [0.0, 0.25, 0.75]])
    assert quality.tv_top1(p, q) == (0.75, 1.0, 0.5)


def test_random_midgame_states_are_seeded_and_frozen():
    """The same seed gives the same positions; a game that ended stays as
    it ended while the others play on (the first 12 plies of a 16-ply run
    draw the same words)."""
    engine = get_engine(3)

    def run(plies):
        return quality.random_midgame_states(
            engine, 16, plies, torch.Generator().manual_seed(42), "cpu")

    a, b, longer = run(12), run(12), run(16)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    done = a.result != ONGOING
    assert bool(done.any())   # 3x3 games end within 12 random plies
    assert bool((a.ply[~done] == 12).all()) and bool((a.ply[done] < 12).all())
    for f in FIELDS:
        assert torch.equal(getattr(longer, f)[done], getattr(a, f)[done]), f
    assert bool((longer.ply[~done] > 12).any())
    pieces = a.heights.sum(-1)   # a placement adds one, a spread none
    assert bool((pieces >= 1).all()) and bool((pieces <= a.ply).all())


# -- (d) the pit with a search per side, against the JAX pit ------------------

def test_pit_with_search_b_matches_jax(monkeypatch):
    """The `recycle` preset's shape at 3x3: side A on the recycled pool
    tier (K=8, a 20-node pool, chunks of 8 sims), side B on the large-tree
    tier (K=16, budget 2*16+2); 4 games, 16 sims in waves of 4, tree
    reuse; the moves of every search, the result and the carried root
    visits equal."""
    n = 3
    a = dict(num_sims=16, wave_size=4, max_children=8, node_budget=20,
             recycle=True, scan_chunk=8, backend="pallas")
    b = dict(num_sims=16, wave_size=4, max_children=16, node_budget=34,
             backend="pallas_hbm")
    pit_args = dict(games=4, komi=0, max_plies=16)
    jax_eval, torch_eval = exact_eval_pair(get_engine(n).num_actions)
    moves = {"jax": [], "torch": []}

    def recorded(side, fn, mcts):
        def run(*args):
            out = fn(*args)
            moves[side].append((mcts.config.backend,
                                np.asarray(out).tolist()))
            return out

        return run

    jax_select = JaxMCTS.__dict__["select_moves"]
    monkeypatch.setattr(JaxMCTS, "select_moves", property(
        lambda self: recorded("jax", jax_select.__get__(self, JaxMCTS),
                              self)))
    torch_select = MCTS.select_moves
    monkeypatch.setattr(MCTS, "select_moves", lambda self, *args: recorded(
        "torch", torch_select, self)(self, *args))
    want_stats, got_stats = {}, {}
    want = jax_pit(jax_engine(n), jax_eval, None, None,
                   JaxPitConfig(search=JaxSearchConfig(**a),
                                search_b=JaxSearchConfig(**b), **pit_args),
                   seed=7, stats=want_stats, log=lambda *_: None)
    got = pit(get_engine(n), torch_eval, None, None,
              PitConfig(search=SearchConfig(**a), search_b=SearchConfig(**b),
                        **pit_args),
              seed=7, stats=got_stats, device="cpu", log=lambda *_: None)
    assert moves["torch"] == moves["jax"]
    assert {m[0] for m in moves["torch"]} == {"pallas", "pallas_hbm"}
    assert vars(got) == vars(want)
    assert got_stats == want_stats and got_stats["carried_n0"] > 0
    assert got.wins + got.losses + got.draws + got.unfinished == 4


# -- (e) strength_ab's command line on the CPU --------------------------------

AB_ARGS = ["--cpu", "--size", "3", "--blocks", "1", "--sims", "16",
           "--games", "2", "--max-plies", "12"]
TOTAL = re.compile(r"subprocess-SPRT total: (\d+)-(\d+)-(\d+)(?:-(\d+)u)?  "
                   r"decision=(\w+)")


def test_strength_ab_writes_one_record(tmp_path, capsys):
    out = tmp_path / "ab.jsonl"
    rec = strength_ab.main(AB_ARGS + ["--json-out", str(out), "--seed", "3"])
    lines = out.read_text().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == rec
    assert set(rec) == RECORD_KEYS
    assert rec["games"] == 2 == (rec["wins"] + rec["losses"] + rec["draws"]
                                 + rec["unfinished"])
    assert rec["preset"] == "recycle" and rec["seed"] == 3
    n = rec["wins"] + rec["losses"]
    assert rec["ci95"] == [round(x, 4) for x in strength_ab.wilson_ci(
        rec["wins"], n)]
    printed = capsys.readouterr().out
    assert "[round 1/1] total" in printed
    assert "A (changed) vs B:" in printed


def test_strength_ab_sprt_stops(tmp_path):
    """--sprt rounds stop at a decision or at --max-games; the record
    carries the SPRT block, and `waves` its wave sizes."""
    out = tmp_path / "ab.jsonl"
    rec = strength_ab.main(AB_ARGS + [
        "--sprt", "--max-games", "4", "--preset", "waves", "--wave-a", "8",
        "--wave-b", "4", "--json-out", str(out)])
    assert set(rec) == RECORD_KEYS | {"sprt", "wave_a", "wave_b"}
    assert (rec["wave_a"], rec["wave_b"]) == (8, 4)
    s = rec["sprt"]
    assert s["decision"] in ("H0", "H1", "inconclusive")
    if s["decision"] == "inconclusive":
        assert rec["games"] == 4
    llr = (strength_ab.sprt_llr(rec["wins"], rec["losses"], 0.45, 0.55)
           if rec["wins"] + rec["losses"] else 0.0)
    assert s["llr"] == round(llr, 3)
    assert len(out.read_text().splitlines()) == 1


def test_strength_ab_subprocess_rounds(tmp_path, capsys):
    """Two rounds in two child processes: two lines (seeds 0 and 1000),
    the printed total their sum, a peak RSS printed for each child."""
    out = tmp_path / "ab.jsonl"
    totals = strength_ab.main(AB_ARGS + [
        "--subprocess-rounds", "--max-games", "4", "--json-out", str(out)])
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(recs) == 2 == totals["rounds"]
    assert [r["seed"] for r in recs] == [0, 1000]
    for r in recs:
        assert set(r) == RECORD_KEYS and r["games"] == 2
    keys = ("wins", "losses", "draws", "unfinished")
    printed = capsys.readouterr().out
    m = TOTAL.search(printed)
    assert m, printed
    got = [int(x or 0) for x in m.groups()[:4]]
    assert got == [sum(r[k] for r in recs) for k in keys]
    assert got == [totals[k] for k in keys]
    assert len(totals["child_rss_mib"]) == 2
    assert all(x > 0 for x in totals["child_rss_mib"])
    assert printed.count("child peak RSS") == 2


# -- (f) the quality probes' command lines on the CPU -------------------------

PROBE_ARGS = ["--cpu", "--size", "3", "--sims", "24", "--wave", "4",
              "--games", "2", "--plies", "2"]


@pytest.mark.parametrize("probe", [quality_recycle, quality_control,
                                   quality_k])
def test_quality_probe_prints_its_lines(probe, capsys):
    extra = {quality_recycle: ["--budget", "12", "--k", "8"],
             quality_control: ["--k-b", "8"],
             quality_k: ["--k", "4", "--ref-k", "32"]}[probe]
    probe.main(PROBE_ARGS + extra)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3, lines
    assert "24 sims" in lines[0]
    tv = re.fullmatch(r"  TV distance: mean (\S+)  max (\S+)", lines[1])
    top1 = re.fullmatch(r"  top-1 agreement: (\S+)", lines[2])
    assert tv and top1, lines
    mean, worst = float(tv.group(1)), float(tv.group(2))
    assert 0.0 <= mean <= worst <= 1.0
    assert 0.0 <= float(top1.group(1)) <= 1.0
    assert math.isfinite(mean)
