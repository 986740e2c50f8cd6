"""PyTorch port's tree waves and search against the JAX package.

The JAX side runs its Pallas tree kernels in interpret mode on the CPU
(`backend="pallas"`); the port runs the plain PyTorch versions of its
CUDA kernels.  Both sides see identical priors and values (the kernel
test feeds the JAX wave's own pending evaluation to both; the searches
use a fake network whose outputs are exact on both sides), so the trees
must match bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tak_tpu.engine.core import get_engine as jax_engine
from tak_tpu.game import Game
from tak_tpu.mcts.search import MCTS as JaxMCTS
from tak_tpu.mcts.search import SearchConfig as JaxSearchConfig
from tak_tpu_torch.engine.core import Engine
from tak_tpu_torch.mcts.search import MCTS, SearchConfig
from tak_tpu_torch.mcts.tree import TENSOR_FIELDS, Tree
from tak_tpu_torch.mcts.tree_kernels import (
    Pending,
    backup_descend_plain,
    expand_backup_plain,
)
from tak_tpu_torch.types import FIELDS, GameState

from tests.test_pallas_mcts import varied_eval


def exact_eval_pair(num_actions):
    """(jax eval_fn, torch eval_fn): a deterministic fake network with
    state-dependent, non-uniform priors and values on a dyadic grid, so
    both frameworks produce the same float bits.  (`varied_eval`'s
    sin/softmax are not reproducible bit for bit outside the JAX search's
    own jitted programs: XLA fuses them differently there.)  Its repeating
    priors also exercise the tie rules of the top-K and of PUCT."""
    A = num_actions

    def jax_eval(params, states):
        feat = (states.ply + 2 * jnp.sum(states.heights, -1)
                + states.to_move)
        k = (feat[:, None] * 7 + jnp.arange(A)[None, :] * 13) % 61
        policy = (k + 1).astype(jnp.float32) / 4096.0
        value = ((feat * 5) % 17 - 8).astype(jnp.float32) / 16.0
        return policy, value

    def torch_eval(params, states):
        feat = (states.ply + 2 * states.heights.sum(-1)
                + states.to_move).long()
        k = (feat[:, None] * 7
             + torch.arange(A, device=feat.device)[None, :] * 13) % 61
        policy = (k + 1).float() / 4096.0
        value = ((feat * 5) % 17 - 8).float() / 16.0
        return policy, value

    return jax_eval, torch_eval


def assert_trees_equal(jax_tree, torch_tree, msg=""):
    got = torch_tree.to_numpy()
    for f in TENSOR_FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jax_tree, f)),
                                      err_msg=f"{msg}: {f}")


def pending_of(p) -> Pending:
    leaves, vals, aidx, results, values, to_move = (np.array(x) for x in p[:6])
    valid = int(p[6]) if len(p) > 6 else 1
    t = torch.as_tensor
    return Pending(t(leaves), t(vals), t(aidx), t(results), t(values),
                   t(to_move), valid=valid)


def start_states(n, moves, batch):
    g = Game.from_ptn_moves(n, moves)
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (batch,) + x.shape),
                        g.state)


def test_tree_waves_vs_pallas_interpret():
    """backup_descend (valid=1), descend (valid=0) and expand_backup against
    the Pallas kernels on identical mid-search trees whose pool is full,
    so every create evicts (n=4, B=2, V=4, K=8, pool 16)."""
    n, V, K, budget = 4, 4, 8, 16
    engine = jax_engine(n)
    cfg = JaxSearchConfig(num_sims=64, wave_size=V, max_children=K,
                          node_budget=budget, recycle=True, backend="pallas")
    mcts = JaxMCTS(engine, varied_eval(engine), cfg)
    tree = mcts.prepare_root(None, mcts.init_batch(
        start_states(n, ["a4", "d1", "b2"], 2)))
    zero = (jnp.zeros((2, V), jnp.int32), jnp.zeros((2, V, K), jnp.float32),
            jnp.zeros((2, V, K), jnp.int32), jnp.zeros((2, V), jnp.int32),
            jnp.zeros((2, V), jnp.float32), jnp.zeros((2, V), jnp.int32),
            jnp.int32(0))
    pending = zero
    for _ in range(6):
        tree, pending = mcts._wave_pipelined(None, tree, pending)
    assert (np.asarray(tree.next_free) == budget).all()  # pool is full
    args = dict(base=cfg.exploration_base, init=cfg.exploration_init,
                recycle=True)

    # merged backup + descend of the pending wave
    want, w_leaves, w_created = mcts._backup_descend(tree, pending)
    got = Tree.from_numpy(tree)
    leaves, created = backup_descend_plain(got, pending_of(pending), **args)
    assert_trees_equal(want, got, "backup_descend")
    np.testing.assert_array_equal(leaves.numpy(), np.asarray(w_leaves))
    np.testing.assert_array_equal(created.numpy(), np.asarray(w_created))
    # the pool was full, so a slot that changed parent was recycled
    assert ((np.asarray(want.parent) != np.asarray(tree.parent))
            | (np.asarray(want.parent_action)
               != np.asarray(tree.parent_action))).any()

    # descend alone: the merged kernel with valid=0 == build_descend_wave
    want, w_leaves, w_created = mcts._descend(tree)
    got = Tree.from_numpy(tree)
    leaves, created = backup_descend_plain(
        got, pending_of(zero[:6] + (0,)), **args)
    assert_trees_equal(want, got, "descend")
    np.testing.assert_array_equal(leaves.numpy(), np.asarray(w_leaves))
    np.testing.assert_array_equal(created.numpy(), np.asarray(w_created))

    # expand + backup flush of the pending wave
    want = mcts._expand_backup(tree, *pending[:6])
    got = Tree.from_numpy(tree)
    expand_backup_plain(got, pending_of(pending), recycle=True)
    assert_trees_equal(want, got, "expand_backup")


def run_both(n, moves, num_sims, wave_size, k, budget, batch=2,
             scan_chunk=None, backend="pallas", **options):
    """The same search in both packages; `options` (`fused_leaf_legal`,
    `topk_impl`) go to both configs.  The pool tier recycles."""
    engine = jax_engine(n)
    jax_eval, torch_eval = exact_eval_pair(engine.num_actions)
    common = dict(num_sims=num_sims, wave_size=wave_size, max_children=k,
                  node_budget=budget, recycle=backend == "pallas",
                  backend=backend, scan_chunk=scan_chunk, **options)
    jm = JaxMCTS(engine, jax_eval, JaxSearchConfig(**common))
    states = start_states(n, moves, batch)
    jt = jm.run_sims(None, jm.prepare_root(None, jm.init_batch(states)))
    if options.get("fused_leaf_legal"):
        # the reference takes its fused leaf step only at B*V % 128 == 0
        assert jm._leaf_step_emits_legal and (batch * wave_size) % 128 == 0

    tm = MCTS(Engine(n), torch_eval, SearchConfig(**common))
    tt = tm.init_batch(GameState.from_numpy(states))
    tt = tm.run_sims(None, tm.prepare_root(None, tt))
    return jt, tt


def assert_node_states_equal(jt, tt, msg=""):
    got = tt.state.to_numpy()
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jt.state, f)),
                                      err_msg=f"{msg} state.{f}")


def test_run_sims_wave1_bitwise():
    """V=1: the whole tree, node states included, matches bit for bit
    after a recycled search with a chunk boundary."""
    jt, tt = run_both(3, ["a3", "c3", "c2"], num_sims=48, wave_size=1, k=16,
                      budget=20, scan_chunk=24)
    assert_trees_equal(jt, tt, "wave1")
    assert_node_states_equal(jt, tt)


def test_run_sims_wave4_root_stats():
    """V=4 on 4x4 with a recycled pool: root statistics and the move agree
    exactly (and here the whole tree does too: both sides run the same
    sequential kernel semantics)."""
    jt, tt = run_both(4, ["a4", "d4", "b2"], num_sims=32, wave_size=4, k=8,
                      budget=16)
    for f in ("n0", "virt0", "next_free", "root_n", "root_virt", "root_w",
              "root_child"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)), err_msg=f)
    assert int(tt.n0[0]) == 32 + 1
    assert_trees_equal(jt, tt, "wave4")


def test_run_sims_large_tier_whole_chunks():
    """With `scan_chunk` set, the large-tree tier runs whole chunks as the
    reference does: 40 sims at wave 8 are 5 waves, a chunk of 24 sims is 3
    waves, so both run 2 chunks = 6 waves (48 rollouts) on each game."""
    jt, tt = run_both(4, ["a4", "d4", "b2"], num_sims=40, wave_size=8, k=16,
                      budget=None, backend="pallas_hbm", scan_chunk=24)
    assert int(np.asarray(jt.n0)[0]) == 49
    assert int(np.asarray(jt.next_free)[0]) == 42
    for f in ("n0", "next_free"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)), err_msg=f)
    assert_trees_equal(jt, tt, "large tier, scan_chunk=24")


def test_reroot_matches_jax():
    """Tree reuse on a recycled 4x4 search, with and without carry
    compaction (`keep`), matches `tak_tpu.mcts.reuse.reroot` field for
    field, node states included."""
    from tak_tpu.mcts.reuse import reroot as jax_reroot
    from tak_tpu_torch.mcts.reuse import reroot

    n, k = 4, 8
    jt, tt = run_both(n, ["a4", "d4", "b2"], num_sims=32, wave_size=4, k=k,
                      budget=16)
    jeng = jax_engine(n)
    actions = np.array(jax.vmap(lambda r: r.shape[0] - 1 - jnp.argmax(
        r[::-1]))(jt.root_n), np.int32)
    new_states = jeng.batched_step(jax.tree.map(lambda x: x[:, 0], jt.state),
                                   jnp.asarray(actions))
    for keep in (None, 5):
        want = jax.vmap(lambda t, a, s: jax_reroot(jeng, t, a, s, k, keep=keep)
                        )(jt, jnp.asarray(actions), new_states)
        got = reroot(Engine(n), tt, torch.as_tensor(actions),
                     GameState.from_numpy(new_states), k, keep=keep)
        assert_trees_equal(want, got, f"keep={keep}")
        state = got.state.to_numpy()
        for f in FIELDS:
            np.testing.assert_array_equal(
                state[f], np.asarray(getattr(want.state, f)),
                err_msg=f"keep={keep} state.{f}")
        if keep is not None:
            assert (got.next_free.numpy() <= keep).all()


FUSED_CASES = {
    # 2 games x 64 leaves = 128 rows per wave; the 96-node pool is full
    # after the first wave, so the later ones recycle
    "pool": dict(n=4, moves=["a4", "d4", "b2"], num_sims=256, wave_size=64,
                 k=8, budget=96, backend="pallas"),
    "hbm": dict(n=4, moves=["a4", "d4", "b2"], num_sims=128, wave_size=64,
                k=16, budget=None, backend="pallas_hbm"),
}


@pytest.mark.parametrize("tier", list(FUSED_CASES))
def test_fused_leaf_legal_trees_bitwise(tier):
    """With `fused_leaf_legal=True` on both sides the whole tree, node
    states included, equals the JAX package's bit for bit, on both tiers;
    and it equals the port's own tree with the option off."""
    case = FUSED_CASES[tier]
    jt, tt = run_both(**case, fused_leaf_legal=True)
    assert_trees_equal(jt, tt, f"fused {tier}")
    assert_node_states_equal(jt, tt, f"fused {tier}")
    assert (tt.n0.numpy() == case["num_sims"] + 1).all()
    if tier == "pool":
        assert (tt.next_free.numpy() == case["budget"]).all()

    _, torch_eval = exact_eval_pair(Engine(case["n"]).num_actions)
    cfg = SearchConfig(
        num_sims=case["num_sims"], wave_size=case["wave_size"],
        max_children=case["k"], node_budget=case["budget"],
        recycle=tier == "pool", backend=case["backend"])
    assert not cfg.fused_leaf_legal
    tm = MCTS(Engine(case["n"]), torch_eval, cfg)
    off = tm.init_batch(GameState.from_numpy(
        start_states(case["n"], case["moves"], 2)))
    off = tm.run_sims(None, tm.prepare_root(None, off))
    want, got = off.to_numpy(), tt.to_numpy()
    for f in TENSOR_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"off/on {f}")
    for f in FIELDS:
        assert torch.equal(getattr(off.state, f), getattr(tt.state, f)), f


@pytest.mark.parametrize("impl", ["packed", "packedq"])
def test_packed_topk_trees(impl):
    """With the one-key top-K on both sides the trees agree on every
    field: both packages quantize, select and decode the same integers, so
    the priors too are equal bit for bit (tolerance 0; the fake network's
    repeating priors make many equal quanta, which both resolve to the
    higher id)."""
    jt, tt = run_both(4, ["a4", "d4", "b2"], num_sims=32, wave_size=4, k=8,
                      budget=16, topk_impl=impl)
    assert_trees_equal(jt, tt, impl)
    assert_node_states_equal(jt, tt, impl)
