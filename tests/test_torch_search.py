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
             scan_chunk=None):
    engine = jax_engine(n)
    jax_eval, torch_eval = exact_eval_pair(engine.num_actions)
    jcfg = JaxSearchConfig(num_sims=num_sims, wave_size=wave_size,
                           max_children=k, node_budget=budget, recycle=True,
                           backend="pallas", scan_chunk=scan_chunk)
    jm = JaxMCTS(engine, jax_eval, jcfg)
    states = start_states(n, moves, batch)
    jt = jm.run_sims(None, jm.prepare_root(None, jm.init_batch(states)))

    tcfg = SearchConfig(num_sims=num_sims, wave_size=wave_size,
                        max_children=k, node_budget=budget, recycle=True,
                        scan_chunk=scan_chunk)
    tm = MCTS(Engine(n), torch_eval, tcfg)
    tt = tm.init_batch(GameState.from_numpy(states))
    tt = tm.run_sims(None, tm.prepare_root(None, tt))
    return jt, tt


def test_run_sims_wave1_bitwise():
    """V=1: the whole tree, node states included, matches bit for bit
    after a recycled search with a chunk boundary."""
    jt, tt = run_both(3, ["a3", "c3", "c2"], num_sims=48, wave_size=1, k=16,
                      budget=20, scan_chunk=24)
    assert_trees_equal(jt, tt, "wave1")
    got = tt.state.to_numpy()
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jt.state, f)),
                                      err_msg=f"state.{f}")


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
