"""PyTorch port's large-tree tier against the JAX package's "pallas_hbm".

The JAX side runs `tak_tpu/mcts/pallas_hbm.py` in interpret mode on the
CPU; the port runs the plain PyTorch versions of its CUDA kernels
(`tak_tpu_torch/mcts/tree_kernels_hbm.py`).  Both sides see a fake
network whose outputs are exact in both frameworks, so whole trees must
match bit for bit, every field, node states included: no tolerance.
"""

import numpy as np
import pytest

from tak_tpu.engine.core import get_engine as jax_engine
from tak_tpu.mcts.search import MCTS as JaxMCTS
from tak_tpu.mcts.search import SearchConfig as JaxSearchConfig
from tak_tpu_torch.engine.core import Engine
from tak_tpu_torch.mcts.search import MCTS, SearchConfig
from tak_tpu_torch.mcts.tree_kernels_hbm import (
    MAX_HBM_NODES,
    descend_wave_hbm_plain,
    expand_backup_wave_hbm_plain,
    fits_hbm,
)
from tak_tpu_torch.mcts.tree import Tree
from tak_tpu_torch.types import FIELDS, GameState

from tests.test_torch_search import (
    assert_trees_equal,
    exact_eval_pair,
    pending_of,
    start_states,
)


def run_both(n, moves, num_sims, wave_size, k, budget=None, batch=2):
    engine = jax_engine(n)
    jax_eval, torch_eval = exact_eval_pair(engine.num_actions)
    jcfg = JaxSearchConfig(num_sims=num_sims, wave_size=wave_size,
                           max_children=k, node_budget=budget,
                           backend="pallas_hbm")
    jm = JaxMCTS(engine, jax_eval, jcfg)
    assert jm._pallas_kind == "hbm"
    states = start_states(n, moves, batch)
    jt = jm.run_sims(None, jm.prepare_root(None, jm.init_batch(states)))

    tcfg = SearchConfig(num_sims=num_sims, wave_size=wave_size,
                        max_children=k, node_budget=budget,
                        backend="pallas_hbm")
    tm = MCTS(Engine(n), torch_eval, tcfg)
    assert tm.tier == "hbm"
    tt = tm.init_batch(GameState.from_numpy(states))
    tt = tm.run_sims(None, tm.prepare_root(None, tt))
    return jt, tt


def assert_whole_trees_equal(jt, tt, msg):
    assert_trees_equal(jt, tt, msg)
    got = tt.state.to_numpy()
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jt.state, f)),
                                      err_msg=f"{msg}: state.{f}")


# the cases of tests/test_pallas_hbm.py
CASES = {
    "wave1_3x3_k32": dict(n=3, moves=["a3", "c3", "c2"], num_sims=48,
                          wave_size=1, k=32),
    "wave1_4x4_k24": dict(n=4, moves=["a4", "d4", "b2"], num_sims=40,
                          wave_size=1, k=24),
    "wave8_4x4_k48": dict(n=4, moves=["a4", "d4", "b2"], num_sims=96,
                          wave_size=8, k=48),
    "pool_exhaustion": dict(n=3, moves=["a3", "c3"], num_sims=64,
                            wave_size=1, k=16, budget=20),
}


@pytest.mark.parametrize("case", list(CASES))
def test_run_sims_bitwise(case):
    jt, tt = run_both(**CASES[case])
    assert_whole_trees_equal(jt, tt, case)
    sims = CASES[case]["num_sims"]
    assert (tt.n0.numpy() == sims + 1).all()
    if case == "pool_exhaustion":
        assert (tt.next_free.numpy() == 20).all()
    # the recycling fields are never touched on this tier
    for f in ("node_n", "node_virt", "child_count"):
        assert not getattr(tt, f).any(), f


def test_cold_rows_bitwise(monkeypatch):
    """With the reference's hot-row cache cut to 8 rows, its cold branch
    (per-row fetch and write-back) walks and expands most of the tree; the
    split must stay invisible.  Wave 4 on 4x4, 64 sims: ~60 nodes."""
    monkeypatch.setattr("tak_tpu.mcts.pallas_hbm.CACHE_ROWS", 8)
    jt, tt = run_both(4, ["a4", "d4", "b2"], num_sims=64, wave_size=4, k=16)
    assert int(jt.next_free[0]) > 3 * 8
    cold_expanded = np.asarray(jt.expanded)[:, 8:]
    assert cold_expanded.any()
    assert (np.asarray(jt.edge_n)[:, 8:].sum() > 0)
    assert_whole_trees_equal(jt, tt, "cold rows")


def test_single_waves_vs_pallas_interpret():
    """One descend wave and one expand+backup wave against the Pallas
    kernels on an identical mid-search tree, fed the JAX wave's own
    pending evaluation (B=2, V=4, K=8 on 4x4, pool 14: the descents of the
    last waves run out of nodes inside the wave)."""
    n, V, K, budget = 4, 4, 8, 14
    engine = jax_engine(n)
    jax_eval, _ = exact_eval_pair(engine.num_actions)
    cfg = JaxSearchConfig(num_sims=V, wave_size=V, max_children=K,
                          node_budget=budget, backend="pallas_hbm")
    mcts = JaxMCTS(engine, jax_eval, cfg)
    tree = mcts.prepare_root(None, mcts.init_batch(
        start_states(n, ["a4", "d1", "b2"], 2)))
    exhausted = False
    for wave in range(5):
        want, w_leaves, w_created = mcts._descend(tree)
        got = Tree.from_numpy(tree)
        leaves, created = descend_wave_hbm_plain(
            got, V, base=cfg.exploration_base, init=cfg.exploration_init)
        assert_trees_equal(want, got, f"descend, wave {wave}")
        np.testing.assert_array_equal(leaves.numpy(), np.asarray(w_leaves))
        np.testing.assert_array_equal(created.numpy(), np.asarray(w_created))
        exhausted |= bool((np.asarray(want.next_free) == budget).all()
                          and not np.asarray(w_created).all())

        want, pending = mcts._eval_and_topk(None, want, w_leaves, w_created)
        got = Tree.from_numpy(want)
        tree = mcts._expand_backup(want, *pending)
        expand_backup_wave_hbm_plain(got, pending_of(pending))
        assert_trees_equal(tree, got, f"expand_backup, wave {wave}")
    assert exhausted  # some create found the pool full inside a wave


def test_tier_rules():
    """`recycle` with the large tier raises in both packages; "auto" picks
    the tier the reference's rule gives (its TPU branch, which the CPU
    never takes, is `fits_in_vmem` then `fits_hbm`) for the Player's
    default and for the self-play config."""
    from tak_tpu.mcts import pallas_hbm, pallas_ops

    engine, jengine = Engine(6), jax_engine(6)
    A = engine.num_actions
    with pytest.raises(ValueError):
        MCTS(engine, None, SearchConfig(backend="pallas_hbm", recycle=True,
                                        node_budget=64))
    with pytest.raises(ValueError):
        JaxMCTS(jengine, None, JaxSearchConfig(
            backend="pallas_hbm", recycle=True, node_budget=64))
    with pytest.raises(NotImplementedError):
        MCTS(engine, None, SearchConfig(backend="xla"))
    with pytest.raises(ValueError):
        MCTS(engine, None, SearchConfig(backend="mosaic"))

    player = SearchConfig(num_sims=64, wave_size=64, max_children=128,
                          node_budget=131_072)
    selfplay = SearchConfig(num_sims=10_240, wave_size=256, max_children=32,
                            node_budget=1280, recycle=True)
    for cfg, tier in ((player, "hbm"), (selfplay, "pool")):
        assert MCTS(engine, None, cfg).tier == tier
        in_vmem = pallas_ops.fits_in_vmem(cfg.max_nodes, cfg.max_children, A)
        in_hbm = (not cfg.recycle
                  and pallas_hbm.fits_hbm(cfg.max_nodes, cfg.max_children))
        assert ("pool" if in_vmem else "hbm" if in_hbm else None) == tier

    assert MAX_HBM_NODES == pallas_hbm.MAX_HBM_NODES
    assert fits_hbm(MAX_HBM_NODES) and not fits_hbm(MAX_HBM_NODES + 1)
    # a recycling tree too big for the pool tier has no tier in the port
    with pytest.raises(NotImplementedError):
        MCTS(engine, None, SearchConfig(recycle=True, node_budget=20_000))
