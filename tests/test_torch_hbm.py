"""PyTorch port's large-tree tier against the JAX package's "pallas_hbm".

The JAX side runs `tak_tpu/mcts/pallas_hbm.py` in interpret mode on the
CPU; the port runs the plain PyTorch versions of its CUDA kernels
(`tak_tpu_torch/mcts/tree_kernels_hbm.py`).  Both sides see a fake
network whose outputs are exact in both frameworks, so whole trees must
match bit for bit, every field, node states included: no tolerance.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tak_tpu.engine.core import get_engine as jax_engine
from tak_tpu.mcts.search import MCTS as JaxMCTS
from tak_tpu.mcts.search import SearchConfig as JaxSearchConfig
from tak_tpu_torch.engine.core import Engine
from tak_tpu_torch.mcts import tree_cases
from tak_tpu_torch.mcts.search import MCTS, SearchConfig
from tak_tpu_torch.mcts.tree_kernels import Pending
from tak_tpu_torch.mcts.tree_kernels_hbm import (
    MAX_HBM_NODES,
    _dims,
    child_chase,
    descend_wave_hbm_plain,
    expand_backup_wave_hbm_plain,
    fits_hbm,
    parent_chase,
    wave_paths,
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


# ---- hand-built trees: the cases that the CUDA kernels' layout puts at risk

HAND_V = 8
HAND_CONFIGS = {
    # A = 944 and 243: neither a multiple of 1,024 (nor of 128)
    "4x4_k32": dict(n=4, k=32),
    "3x3_k128": dict(n=3, k=128),
}
HAND_CASES = ([(case, "4x4_k32") for case in tree_cases.CASES]
              + [(case, "3x3_k128")
                 for case in ("shared_prefix", "dups_twice", "pool_full")])
_hand_searches = {}


def hand_search(config):
    """(JAX MCTS on "pallas_hbm" in interpret mode, port MCTS, start states)
    for one shape; every case of that shape shares the compiled kernels."""
    if config not in _hand_searches:
        n, k = HAND_CONFIGS[config]["n"], HAND_CONFIGS[config]["k"]
        budget = tree_cases.nodes_needed(HAND_V) + 8
        kw = dict(num_sims=HAND_V, wave_size=HAND_V, max_children=k,
                  node_budget=budget, backend="pallas_hbm")
        jm = JaxMCTS(jax_engine(n), None, JaxSearchConfig(**kw))
        tm = MCTS(Engine(n), None, SearchConfig(**kw))
        assert jm._pallas_kind == "hbm" and tm.tier == "hbm"
        _hand_searches[config] = (jm, tm, start_states(n, [], 2))
    return _hand_searches[config]


def hand_trees(case, config, seed):
    """The same hand-built tree as a JAX tree and as a port tree."""
    jm, tm, states = hand_search(config)
    cfg = tm.config
    fields = tree_cases.hand_tree(case, 2, cfg.max_nodes, cfg.max_children,
                                  tm.engine.num_actions, HAND_V, seed)
    jt = jm.init_batch(states).replace(
        **{f: jnp.asarray(a) for f, a in fields.items()})
    tt = tm.init_batch(GameState.from_numpy(states))
    for f, a in fields.items():
        getattr(tt, f).copy_(torch.as_tensor(a))
    return jt, tt


@pytest.mark.parametrize("case,config", HAND_CASES)
def test_hand_built_waves_bitwise(case, config):
    """One descend wave and one expand+backup wave on a hand-built tree:
    the plain versions against the Pallas kernels in interpret mode, every
    tree field bitwise (tolerance 0).  The pending evaluation is made from
    a seed: rows that differ between the occurrences of a repeated leaf,
    values that are not dyadic, every third leaf terminal."""
    jm, tm, _ = hand_search(config)
    cfg = tm.config
    K, A, V = cfg.max_children, tm.engine.num_actions, HAND_V
    jt, tt = hand_trees(case, config, seed=3)
    jt, w_leaves, w_created = jm._descend(jt)
    leaves, created = descend_wave_hbm_plain(
        tt, V, base=cfg.exploration_base, init=cfg.exploration_init)
    assert_trees_equal(jt, tt, f"{case} descend")
    np.testing.assert_array_equal(leaves.numpy(), np.asarray(w_leaves))
    np.testing.assert_array_equal(created.numpy(), np.asarray(w_created))

    # the wave is the hard case it was built to be
    lv = leaves.numpy()
    spec = tree_cases.CASES[case]
    if case == "one_leaf":
        assert (lv == spec["chain"]).all() and not created.any()
    elif case == "dups_twice":
        assert all((np.bincount(row)[row] == 2).all() for row in lv)
    elif case == "root_creates":
        assert created.all() and (tt.parent.numpy()[0, lv[0]] == 0).all()
    elif case == "pool_full":
        assert (lv[:, V // 2:] == 0).all() and (lv[:, :V // 2] > 0).all()
        assert (tt.next_free.numpy() == cfg.max_nodes).all()
    else:
        depth = parent_chase(tt, leaves).numpy() / V - 1
        assert (depth >= spec["chain"]).all()

    pending = tree_cases.hand_pending(lv, K, A, seed=5)
    order = ("leaves", "topk_vals", "topk_aidx", "results", "values",
             "to_move")
    jt = jm._expand_backup(jt, *(jnp.asarray(pending[f]) for f in order))
    expand_backup_wave_hbm_plain(
        tt, Pending(**{f: torch.as_tensor(a) for f, a in pending.items()},
                    valid=1))
    assert_trees_equal(jt, tt, f"{case} expand_backup")
    assert not tt.virt0.any()
    if case in ("shared_prefix", "deep_chain"):
        # the chain's edges took every leaf's value, in leaf order
        assert (np.abs(tt.edge_n.numpy()).max((1, 2)) == 1000 + V).all()


def test_repeated_leaf_takes_first_row():
    """A leaf that occurs V times installs the row of its first ongoing
    occurrence and no other; a terminal occurrence installs none."""
    _, tm, _ = hand_search("4x4_k32")
    cfg = tm.config
    K, A, V = cfg.max_children, tm.engine.num_actions, HAND_V
    _, tt = hand_trees("one_leaf", "4x4_k32", seed=9)
    leaves, _ = descend_wave_hbm_plain(
        tt, V, base=cfg.exploration_base, init=cfg.exploration_init)
    pending = tree_cases.hand_pending(leaves.numpy(), K, A, seed=11)
    pending["results"][:, 0] = 1        # the first occurrence is terminal
    expand_backup_wave_hbm_plain(
        tt, Pending(**{f: torch.as_tensor(a) for f, a in pending.items()},
                    valid=1))
    leaf = int(leaves[0, 0])
    assert (pending["results"][:, 1] == 0).all()
    for g in range(2):
        vals = pending["topk_vals"][g, 1]
        want = np.where(vals >= 0, pending["topk_aidx"][g, 1], -1)
        np.testing.assert_array_equal(tt.edge_action[g, leaf].numpy(), want)
        np.testing.assert_array_equal(tt.edge_prior[g, leaf].numpy(),
                                      np.maximum(vals, 0))


def test_chase_aids_follow_the_wave():
    """`wave_paths` + `child_chase` end in the wave's leaves, and
    `parent_chase` counts depth + 1 levels per leaf (CPU versions)."""
    _, tm, _ = hand_search("4x4_k32")
    cfg = tm.config
    for case in ("deep_chain", "pool_full"):
        _, tt = hand_trees(case, "4x4_k32", seed=13)
        leaves, _ = descend_wave_hbm_plain(
            tt, HAND_V, base=cfg.exploration_base, init=cfg.exploration_init)
        actions, slots = wave_paths(tt, leaves)
        np.testing.assert_array_equal(
            child_chase(tt, actions, slots).numpy(), leaves.numpy())
        depth = (actions != -1).int() + (slots != -1).sum(-1).int()
        np.testing.assert_array_equal(parent_chase(tt, leaves).numpy(),
                                      (depth + 1).sum(1).numpy())


@pytest.mark.parametrize("M,K,V", [(2 ** 22, 1024, 64), (1024, 2048, 64),
                                   (1024, 128, 2 ** 24), (1024, 128, 0)])
def test_wrapper_refuses_shapes(M, K, V):
    """Shapes the CUDA kernels do not take raise with a message instead of
    running wrong or slow (a wave's row slots, V x K, count in 32 bits)."""
    fake = types.SimpleNamespace(
        edge_n=torch.empty((1, M, K), device="meta"),
        root_n=torch.empty((1, 9036), device="meta"))
    with pytest.raises(ValueError):
        _dims(fake, V)
    assert _dims(types.SimpleNamespace(
        edge_n=torch.empty((1, 131_072, 128), device="meta"),
        root_n=fake.root_n), 64)["K"] == 128


@pytest.mark.parametrize("V", [385, 512, 4096])
def test_wrapper_takes_wide_waves(V):
    """Any wave the reference's large tier takes: the backup kernel keeps
    the recorded paths of a wave too wide for shared memory in a global
    buffer, so `_dims` takes V = 512 (`-b 512` of the command lines) on a
    small tree, as the JAX package's tier does."""
    _, tt = hand_trees("shared_prefix", "4x4_k32", seed=3)
    d = _dims(tt, V)
    assert (d["V"], d["K"]) == (V, tt.edge_n.shape[2])
