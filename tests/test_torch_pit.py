"""PyTorch port's `pit` and Elo ladder against `tak_tpu.pit` / `tak_tpu.elo`.

The parity match: 3x3, 4 games (2 paired openings), 16 sims a move in
waves of 4, K=8, tree reuse on (a 34-node pool per tree, re-rooted every
ply and blanked when the carry crowds it), both sides on the pool-tier
tree kernels (`backend="pallas"`: the JAX side runs its Pallas kernels in
interpret mode, the port its kernels' plain versions), and the same
deterministic fake network on both sides
(`tests/test_torch_search.exact_eval_pair`).  `max_plies` is cut to 16 so
that interpret mode stays fast (these games end by road before it).  The
moves of every search, the results and the visits carried into the
searches must be equal.  The rest mirrors
`tests/test_pit.py` and `tests/test_elo.py` on the port.
"""

import numpy as np
import pytest
import torch

from tak_tpu.elo import bradley_terry_elo as jax_bradley_terry_elo
from tak_tpu.engine.core import get_engine as jax_engine
from tak_tpu.mcts.search import MCTS as JaxMCTS
from tak_tpu.mcts.search import SearchConfig as JaxSearchConfig
from tak_tpu.pit import PitConfig as JaxPitConfig
from tak_tpu.pit import _make_opening as jax_make_opening
from tak_tpu.pit import pit as jax_pit
from tak_tpu_torch.elo import (
    LadderConfig,
    bradley_terry_elo,
    elo_ladder,
    expected_score,
)
from tak_tpu_torch.engine.core import get_engine
from tak_tpu_torch.mcts.search import MCTS, SearchConfig
from tak_tpu_torch.model.network import Network
from tak_tpu_torch.model.resnet import NetConfig
from tak_tpu_torch.pit import PitConfig, PitResult, _make_opening, pit

from tests.test_torch_search import exact_eval_pair

QUIET = dict(log=lambda *_: None)
MAX_PLIES = 16


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the tier-1 run
    shares the host's cores among its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("threshold", [None, 0.55])
def test_pit_matches_jax(threshold, monkeypatch):
    """Equal moves at every search, PitResult and carried root visits,
    with and without the decide_threshold early exit."""
    n = 3
    search = dict(num_sims=16, wave_size=4, max_children=8)
    pit_args = dict(games=4, komi=0, max_plies=MAX_PLIES,
                    decide_threshold=threshold)
    jax_eval, torch_eval = exact_eval_pair(get_engine(n).num_actions)
    moves = {"jax": [], "torch": []}

    def recorded(side, fn):
        def run(*a):
            out = fn(*a)
            moves[side].append(np.asarray(out).tolist())
            return out

        return run

    # the JAX package's select_moves is a cached property holding a jitted
    # function; the port's a method
    jax_select = JaxMCTS.__dict__["select_moves"]
    monkeypatch.setattr(JaxMCTS, "select_moves", property(
        lambda self: recorded("jax", jax_select.__get__(self, JaxMCTS))))
    torch_select = MCTS.select_moves
    monkeypatch.setattr(MCTS, "select_moves", lambda self, *a: recorded(
        "torch", torch_select)(self, *a))
    want_stats, got_stats = {}, {}
    want = jax_pit(jax_engine(n), jax_eval, None, None,
                   JaxPitConfig(search=JaxSearchConfig(backend="pallas",
                                                       **search), **pit_args),
                   seed=5, stats=want_stats, **QUIET)
    got = pit(get_engine(n), torch_eval, None, None,
              PitConfig(search=SearchConfig(backend="pallas", **search),
                        **pit_args),
              seed=5, stats=got_stats, device="cpu", **QUIET)
    assert moves["torch"] == moves["jax"]
    assert vars(got) == vars(want)
    assert str(got) == str(want)
    assert got_stats == want_stats
    assert got_stats["carried_n0"] > 0
    assert got.wins + got.losses + got.draws + got.unfinished == 4


def test_openings_match_jax():
    for n in (3, 6):
        rng_j, rng_t = np.random.default_rng(n), np.random.default_rng(n)
        for _ in range(3):
            assert (_make_opening(get_engine(n), rng_t, 2, device="cpu")
                    == jax_make_opening(jax_engine(n), rng_j, 2))


def test_pit_result_accounting():
    r = PitResult(wins=11, losses=9, draws=4)
    assert abs(r.win_rate() - 11 / 20) < 1e-9
    assert PitResult().win_rate() == 0.0
    assert str(PitResult(1, 2, 3, 4)) == ("PitResult { wins: 1, losses: 2, "
                                          "draws: 3, unfinished: 4 }")


def _uniform_eval(A):
    def run(params, states):
        b = states.ply.shape[0]
        return torch.ones((b, A)), torch.zeros(b)

    return run


def test_pit_runs_and_tallies():
    engine = get_engine(3)
    cfg = PitConfig(games=4, komi=0,
                    search=SearchConfig(num_sims=32, wave_size=8,
                                        max_children=32),
                    max_plies=80)
    stats = {}
    res = pit(engine, _uniform_eval(engine.num_actions), None, None, cfg,
              seed=7, stats=stats, device="cpu", **QUIET)
    assert res.wins + res.losses + res.draws == 4
    # tree reuse is on by default (pit.rs:66-92): searches after the first
    # ply start from carried subtrees with real root visits
    assert stats["carried_n0"] > 0


def test_pit_no_reuse_carries_nothing():
    engine = get_engine(3)
    cfg = PitConfig(games=2, komi=0,
                    search=SearchConfig(num_sims=16, wave_size=8,
                                        max_children=32),
                    max_plies=30, tree_reuse=False)
    stats = {}
    res = pit(engine, _uniform_eval(engine.num_actions), None, None, cfg,
              seed=3, stats=stats, device="cpu", **QUIET)
    assert res.wins + res.losses + res.draws == 2
    assert stats["carried_n0"] == 0


def _records():
    """Synthetic ladders: players 0 < 1 < 2 at 75% each; all draws with an
    unplayed player; a sweep."""
    score = np.zeros((3, 3))
    games = np.zeros((3, 3))
    for i, j, sij in [(1, 0, 75), (2, 1, 75), (2, 0, 93)]:
        score[i, j] = sij
        score[j, i] = 100 - sij
        games[i, j] = games[j, i] = 100
    return [
        (score, games),
        (np.array([[0, 5.0, 0], [5.0, 0, 0], [0, 0, 0]]),
         np.array([[0, 10.0, 0], [10.0, 0, 0], [0, 0, 0]])),
        (np.array([[0, 10.0], [0.0, 0]]), np.array([[0, 10.0], [10.0, 0]])),
    ]


@pytest.mark.parametrize("case", range(3))
def test_bradley_terry_matches_jax(case):
    score, games = _records()[case]
    np.testing.assert_array_equal(bradley_terry_elo(score, games),
                                  jax_bradley_terry_elo(score, games))


def test_bt_recovers_ordering():
    elo = bradley_terry_elo(*_records()[0])
    assert elo[0] == 0.0  # anchored
    assert elo[0] < elo[1] < elo[2]
    assert 150 < elo[1] - elo[0] < 240
    assert 150 < elo[2] - elo[1] < 240
    elo = bradley_terry_elo(*_records()[1])
    assert abs(elo[1] - elo[0]) < 1.0 and elo[2] == 0.0
    elo = bradley_terry_elo(*_records()[2])
    assert np.isfinite(elo).all() and elo[0] > elo[1] + 300
    assert abs(expected_score(0.0) - 0.5) < 1e-12
    assert 0.74 < expected_score(191) < 0.76


def test_tiny_ladder_runs():
    engine = get_engine(3)
    network = Network(engine, NetConfig(n=3, filters=8, blocks=1),
                      device="cpu")
    players = [(f"ckpt{i}", network.init_variables(i)) for i in range(3)]
    cfg = LadderConfig(
        pit=PitConfig(
            games=2, komi=2, random_plies=2, max_plies=30,
            search=SearchConfig(num_sims=8, wave_size=2, max_children=16),
        ),
        schedule="adjacent",
    )
    result = elo_ladder(engine, network.policy_eval_states, players, cfg,
                        seed=3, device="cpu", **QUIET)
    assert set(result.ratings) == {"ckpt0", "ckpt1", "ckpt2"}
    assert len(result.matches) == 2
    for m in result.matches:
        assert m.wins + m.losses + m.draws == 2
    assert np.isfinite(list(result.ratings.values())).all()
    assert "elo" in result.table()
    assert "ratings" in result.to_json()
