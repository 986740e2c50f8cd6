"""The port's Gumbel root search against `tak_tpu`'s.

`jax.random.gumbel` cannot be reproduced in PyTorch, so the JAX search's
own sample (returned by its `run_sims_gumbel`) is fed to the port's
internal entry `_run_sims_gumbel`; with `exact_eval_pair` on both sides
the trees must be equal in every field (tolerance 0), the Gumbel moves
equal, and `gumbel_policy_weights` within 1e-6 (float32 exp and sums in
another order).  Then mirrors of `tests/test_gumbel.py` on the port, its
draws coming from a seeded `torch.Generator`.
"""

import jax
import numpy as np
import pytest
import torch

from tak_tpu.engine.core import get_engine as jax_engine
from tak_tpu.mcts.search import MCTS as JaxMCTS
from tak_tpu.mcts.search import SearchConfig as JaxSearchConfig
from tak_tpu_torch.engine.core import Engine
from tak_tpu_torch.game import Game
from tak_tpu_torch.mcts.search import MCTS, SearchConfig
from tak_tpu_torch.types import ONGOING, WHITE_ROAD, GameState

from tests.test_torch_search import (
    assert_node_states_equal,
    assert_trees_equal,
    exact_eval_pair,
    start_states,
)
from tests.test_torch_train import one_torch_thread  # noqa: F401

CASES = {
    "3x3": dict(n=3, moves=["a3", "c3"], num_sims=32, wave_size=2,
                max_children=16, gumbel_m=8),
    "4x4-recycle": dict(n=4, moves=["a4", "d4", "b2"], num_sims=48,
                        wave_size=4, max_children=8, gumbel_m=16,
                        node_budget=20, recycle=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gumbel_search_equals_jax(case):
    kw = dict(CASES[case])
    n, moves = kw.pop("n"), kw.pop("moves")
    engine = jax_engine(n)
    jax_eval, torch_eval = exact_eval_pair(engine.num_actions)
    want_seq = JaxMCTS(engine, jax_eval, JaxSearchConfig(**kw))._considered_seq
    jm = JaxMCTS(engine, jax_eval, JaxSearchConfig(**kw))
    states = start_states(n, moves, 2)
    jt, g = jm.run_sims_gumbel(
        None, jm.prepare_root(None, jm.init_batch(states)),
        jax.random.PRNGKey(7))
    tm = MCTS(Engine(n), torch_eval, SearchConfig(**kw))
    assert tm.tier == "xla"
    assert tm._considered_seq == tuple(np.asarray(want_seq).tolist())
    gumbel = torch.as_tensor(np.array(g))
    tt = tm.prepare_root(None, tm.init_batch(GameState.from_numpy(states)))
    tt = tm._run_sims_gumbel(None, tt, gumbel)
    assert_trees_equal(jt, tt, case)
    assert_node_states_equal(jt, tt, case)
    np.testing.assert_array_equal(
        tm.select_moves_gumbel(tt, gumbel).numpy(),
        np.asarray(jm.select_moves_gumbel(jt, g)))
    np.testing.assert_allclose(tm.gumbel_policy_weights(tt).numpy(),
                               np.asarray(jm.gumbel_policy_weights(jt)),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        tm._gumbel_scores(tt, gumbel).numpy(),
        np.asarray(jax.vmap(jm._gumbel_scores)(jt, g)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("m,sims,V", [(8, 32, 1), (16, 10_240, 256),
                                      (4, 100, 8), (400, 64, 4)])
def test_considered_seq_equals_jax(m, sims, V):
    kw = dict(num_sims=sims, wave_size=V, gumbel_m=m)
    want = JaxMCTS(jax_engine(6), None, JaxSearchConfig(**kw))._considered_seq
    got = MCTS(Engine(6), None, SearchConfig(**kw))._considered_seq
    assert got == tuple(np.asarray(want).tolist())


def uniform_eval(num_actions):
    def eval_fn(params, states):
        b = states.ply.shape[0]
        return torch.ones((b, num_actions)), torch.zeros(b)

    return eval_fn


def make(n, num_sims, wave_size=1, m=16, **kw):
    engine = Engine(n)
    return MCTS(engine, uniform_eval(engine.num_actions), SearchConfig(
        num_sims=num_sims, wave_size=wave_size, max_children=32, gumbel_m=m,
        **kw))


def run(mcts, game, seed):
    tree = mcts.prepare_root(None, mcts.init_batch(game.state))
    gen = torch.Generator().manual_seed(seed)
    return mcts.run_sims_gumbel(None, tree, gen)


def test_schedule_is_sequential_halving():
    seq = np.asarray(make(3, 32, 1, m=8)._considered_seq)
    assert seq.shape == (32,) and seq[0] == 0 and (np.diff(seq) >= 0).all()
    assert (seq[:8] == 0).all() and seq[-1] > 0


def test_gumbel_finds_win_in_one():
    mcts = make(3, 128, 1, m=16)
    moves = ["a3", "c3", "c2", "a2"]
    for seed in range(3):
        g = Game.from_ptn_moves(3, moves, device="cpu")
        tree, gumbel = run(mcts, g, seed)
        assert gumbel.shape == (1, mcts.engine.num_actions)
        assert bool(torch.isfinite(gumbel).all())
        g.play_action(int(mcts.select_moves_gumbel(tree, gumbel)[0]))
        assert g.result == WHITE_ROAD, seed


def test_gumbel_prevents_win_in_two():
    mcts = make(3, 1024, 2, m=8)
    g = Game.from_ptn_moves(3, ["a3", "c3", "c2"], device="cpu")
    for seed in (1, 2):
        tree, gumbel = run(mcts, g, seed)
        g.play_action(int(mcts.select_moves_gumbel(tree, gumbel)[0]))
        assert g.result == ONGOING


def test_gumbel_policy_weights_normalized_and_draws_seeded():
    mcts = make(3, 32, 2, m=8)
    g = Game.from_ptn_moves(3, ["a3", "c3"], device="cpu")
    tree, gumbel = run(mcts, g, 0)
    pi = mcts.gumbel_policy_weights(tree)[0].numpy()
    legal = g.legal_mask()
    assert abs(pi.sum() - 1.0) < 1e-5
    assert (pi[~legal] == 0).all() and (pi[legal] > 0).any()
    assert int(tree.n0[0]) == 33
    _, again = run(mcts, g, 0)
    assert torch.equal(again, gumbel)
    _, other = run(mcts, g, 1)
    assert not torch.equal(other, gumbel)


def test_gumbel_rejects_kernel_tiers():
    for backend in ("pallas", "pallas_hbm"):
        with pytest.raises(ValueError):
            make(3, 8, 2, m=4, backend=backend)
    with pytest.raises(ValueError):
        make(3, 8, 2, m=0).run_sims_gumbel(None, None, None)
