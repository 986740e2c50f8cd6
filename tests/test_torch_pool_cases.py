"""PyTorch port's pool tier (node recycling) against the JAX package's
"pallas" kernels on hand-built trees.

The JAX side runs `tak_tpu/mcts/pallas_ops.py` in interpret mode on the
CPU; the port runs the plain PyTorch versions of its CUDA kernels
(`tak_tpu_torch/mcts/tree_kernels.py`).  The trees come from
`tak_tpu_torch/mcts/tree_cases.py`: the recycling cases that a search
rarely reaches (the create's own parent as the coldest candidate, a victim
hanging from the root, a full pool without a candidate, tied and clamped
keys, a pending leaf unpinned and evicted inside one merged wave) and the
large tier's shared-prefix, repeated-leaf and deep-chain trees with
recycling on.  Every case runs the three kernels in turn: a descend wave
(the merged kernel with nothing pending), a merged backup+descend wave of
a seeded evaluation of its leaves, and the expand+backup flush of the
next; every tree field, the leaves and the created flags must agree bit
for bit (tolerance 0).
"""

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
from tak_tpu_torch.mcts.tree import NONE
from tak_tpu_torch.mcts.tree_kernels import (
    Pending,
    backup_descend_plain,
    expand_backup_plain,
)
from tak_tpu_torch.types import GameState

from tests.test_torch_search import assert_trees_equal, start_states

V = 8
M = tree_cases.pool_nodes(V)
SHAPES = {
    # A = 944 and 243: neither a multiple of 128
    "4x4_k8": dict(n=4, k=8),
    "3x3_k32": dict(n=3, k=32),
}
HAND = ("shared_prefix", "dups_twice", "one_leaf", "deep_chain")
CASES = ([(case, "4x4_k8") for case in (*tree_cases.POOL_CASES, *HAND)]
         + [(case, "3x3_k32") for case in tree_cases.POOL_CASES])
PENDING = ("leaves", "topk_vals", "topk_aidx", "results", "values", "to_move")
_searches = {}


def searches(shape):
    """(JAX MCTS on "pallas" with recycling, in interpret mode; port MCTS;
    start states) for one shape: every case of the shape shares the
    compiled kernels."""
    if shape not in _searches:
        n, k = SHAPES[shape]["n"], SHAPES[shape]["k"]
        kw = dict(num_sims=V, wave_size=V, max_children=k, node_budget=M,
                  recycle=True, backend="pallas")
        jm = JaxMCTS(jax_engine(n), None, JaxSearchConfig(**kw))
        tm = MCTS(Engine(n), None, SearchConfig(**kw))
        assert jm._pallas_kind == "vmem" and tm.tier == "pool"
        _searches[shape] = (jm, tm, start_states(n, [], 2))
    return _searches[shape]


def trees(case, shape, seed):
    """The same hand-built tree as a JAX tree and as a port tree, and the
    case's leaves in flight ([2, V], NONE where there are none)."""
    jm, tm, states = searches(shape)
    fields = tree_cases.hand_tree(case, 2, M, tm.config.max_children,
                                  tm.engine.num_actions, V, seed)
    in_flight = fields.pop("pending_leaves", None)
    jt = jm.init_batch(states).replace(
        **{f: jnp.asarray(a) for f, a in fields.items()})
    tt = tm.init_batch(GameState.from_numpy(states))
    for f, a in fields.items():
        getattr(tt, f).copy_(torch.as_tensor(a))
    return jt, tt, in_flight


def evaluation(leaves, K, A, seed):
    """A seeded evaluation of `leaves` for both sides."""
    p = tree_cases.hand_pending(leaves, K, A, seed)
    jp = tuple(jnp.asarray(p[f]) for f in PENDING)
    tp = Pending(**{f: torch.as_tensor(a) for f, a in p.items()}, valid=1)
    return jp, tp


def merged(jm, jt, tt, jp, tp, what):
    """One merged backup+descend wave on both sides, held bitwise."""
    cfg = SearchConfig()
    jt, w_leaves, w_created = jm._backup_descend(
        jt, jp + (jnp.int32(tp.valid),))
    leaves, created = backup_descend_plain(
        tt, tp, base=cfg.exploration_base, init=cfg.exploration_init,
        recycle=True)
    assert_trees_equal(jt, tt, what)
    np.testing.assert_array_equal(leaves.numpy(), np.asarray(w_leaves))
    np.testing.assert_array_equal(created.numpy(), np.asarray(w_created))
    return jt, leaves.numpy(), created.numpy()


@pytest.mark.parametrize("case,shape", CASES)
def test_pool_case_bitwise(case, shape):
    """The three pool-tier kernels in turn on a hand-built tree: the plain
    versions against the Pallas kernels in interpret mode, bitwise; and the
    wave is the case it was built to be."""
    jm, tm, _ = searches(shape)
    K, A = tm.config.max_children, tm.engine.num_actions
    jt, tt, in_flight = trees(case, shape, seed=3)
    before = tt.clone()

    # the first wave: descend alone, or the merged kernel on the wave in
    # flight
    if in_flight is not None and (in_flight != NONE).all():
        jp, tp = evaluation(in_flight, K, A, seed=4)
    else:
        jp = tuple(jnp.asarray(x) for x in (
            np.zeros((2, V), np.int32), np.zeros((2, V, K), np.float32),
            np.zeros((2, V, K), np.int32), np.zeros((2, V), np.int32),
            np.zeros((2, V), np.float32), np.zeros((2, V), np.int32)))
        tp = Pending.zeros(2, V, K, "cpu")
    jt, lv, cr = merged(jm, jt, tt, jp, tp, f"{case} first wave")

    # the wave is the hard case it was built to be
    tree_cases.check_first_wave(case, before.to_numpy(), tt.to_numpy(), lv,
                                cr, in_flight)

    # the merged kernel on an evaluation of those leaves, then the flush
    jp, tp = evaluation(lv, K, A, seed=5)
    jt, lv2, _ = merged(jm, jt, tt, jp, tp, f"{case} merged wave")
    jp, tp = evaluation(lv2, K, A, seed=6)
    jt = jm._expand_backup(jt, *jp)
    expand_backup_plain(tt, tp, recycle=True)
    assert_trees_equal(jt, tt, f"{case} flush")
    # every pin of the three waves was released
    assert (tt.node_virt.numpy() <= before.node_virt.numpy()).all()


def test_kernel_shapes():
    """The CUDA wrapper's rule, checked before a launch: the wave's paths
    and, with recycling, the node mirrors must fit shared memory."""
    from tak_tpu_torch.mcts.tree import init_tree
    from tak_tpu_torch.mcts.tree_kernels import (
        MAX_RECYCLE_NODES,
        MAX_WAVE,
        _dims,
    )

    engine = Engine(3)
    roots = engine.initial_batch(1, 4, "cpu")
    big = init_tree(engine, roots, MAX_RECYCLE_NODES + 1, 2)
    assert _dims(big, MAX_WAVE, recycle=False)["M"] == MAX_RECYCLE_NODES + 1
    with pytest.raises(ValueError, match="recycling pool"):
        _dims(big, V, recycle=True)
    small = init_tree(engine, roots, M, 8)
    assert _dims(small, V, recycle=True) == {
        "B": 1, "M": M, "K": 8, "A": engine.num_actions, "V": V}
    for bad in (0, MAX_WAVE + 1):
        with pytest.raises(ValueError, match="wave size"):
            _dims(small, bad, recycle=True)
    with pytest.raises(ValueError, match="max_children"):
        _dims(init_tree(engine, roots, 4, 1025), V, recycle=True)
