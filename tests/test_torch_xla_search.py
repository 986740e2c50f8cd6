"""The port's "xla" search path (staggered descents in plain PyTorch)
against `tak_tpu`'s XLA path (`backend="xla"`).

Both sides use `tests.test_torch_search.exact_eval_pair`, whose dyadic
priors and values are exact in both frameworks and make any order of
float additions exact, so the trees must be equal in every field, node
states included (tolerance 0), after 1, 2 and N waves, with recycling off
and on (tiny pools that evict every create).  Then mirrors of
`tests/test_mcts.py` and `tests/test_recycle.py` on the port, the V=1
tree against the port's own pool tier (bitwise, as
`tests/test_recycle.py::test_pallas_recycle_wave1_bitwise_vs_xla`), and
the tier rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tak_tpu.engine.core import get_engine as jax_engine
from tak_tpu.mcts.search import MCTS as JaxMCTS
from tak_tpu.mcts.search import SearchConfig as JaxSearchConfig
from tak_tpu_torch.engine.core import Engine
from tak_tpu_torch.game import Game
from tak_tpu_torch.mcts.search import MCTS, SearchConfig
from tak_tpu_torch.mcts.tree import root_visit_counts
from tak_tpu_torch.types import ONGOING, WHITE_ROAD, GameState

from tests.test_recycle import check_invariants
from tests.test_torch_search import (
    assert_node_states_equal,
    assert_trees_equal,
    exact_eval_pair,
    start_states,
)
from tests.test_torch_train import one_torch_thread  # noqa: F401


def run_both(n, moves, waves, wave_size, k, budget, recycle, batch=2,
             **extra):
    engine = jax_engine(n)
    jax_eval, torch_eval = exact_eval_pair(engine.num_actions)
    common = dict(num_sims=waves * wave_size, wave_size=wave_size,
                  max_children=k, node_budget=budget, recycle=recycle,
                  backend="xla", **extra)
    jm = JaxMCTS(engine, jax_eval, JaxSearchConfig(**common))
    states = start_states(n, moves, batch)
    jt = jm.run_sims(None, jm.prepare_root(None, jm.init_batch(states)))
    tm = MCTS(Engine(n), torch_eval, SearchConfig(**common))
    assert tm.tier == "xla"
    tt = tm.init_batch(GameState.from_numpy(states))
    tt = tm.run_sims(None, tm.prepare_root(None, tt))
    return jt, tt


CASES = {
    # 4x4, V=4, K=8: a 16-node pool fills in the first waves, then every
    # create evicts
    "recycle": dict(n=4, moves=["a4", "d4", "b2"], wave_size=4, k=8,
                    budget=16, recycle=True),
    "no-recycle": dict(n=4, moves=["a4", "d4", "b2"], wave_size=4, k=8,
                       budget=100, recycle=False),
    # a pool so small that creates fail once it is full: parent re-evals
    "pool-full": dict(n=3, moves=["a3", "c3"], wave_size=4, k=16,
                      budget=12, recycle=False),
}


@pytest.mark.parametrize("waves", [1, 2, 10])
@pytest.mark.parametrize("case", list(CASES))
def test_trees_equal_jax(case, waves):
    jt, tt = run_both(waves=waves, **CASES[case])
    assert_trees_equal(jt, tt, f"{case}, {waves} waves")
    assert_node_states_equal(jt, tt, f"{case}, {waves} waves")
    if case == "recycle" and waves == 10:
        assert (tt.next_free.numpy() == 16).all()


def test_wave1_and_scan_chunk_equal_jax():
    """V=1 on 3x3 with a recycled 20-node pool and chunked waves."""
    jt, tt = run_both(3, ["a3", "c3", "c2"], waves=48, wave_size=1, k=16,
                      budget=20, recycle=True, scan_chunk=20)
    assert_trees_equal(jt, tt, "wave1")
    assert_node_states_equal(jt, tt)


def test_pick_victims_ties_equal_jax():
    """`_pick_victims` on a full recycled pool whose node_n is rewritten
    into many ties (and one clamped-high value): the same victims in the
    same order, ties to the lowest index, with protected nodes skipped."""
    n, V, budget = 4, 4, 16
    jt, tt = run_both(n, ["a4", "d4", "b2"], waves=6, wave_size=V, k=8,
                      budget=budget, recycle=True)
    jm = JaxMCTS(jax_engine(n), None, JaxSearchConfig(
        num_sims=V, wave_size=V, max_children=8, node_budget=budget,
        recycle=True, backend="xla"))
    tm = MCTS(Engine(n), None, SearchConfig(
        num_sims=V, wave_size=V, max_children=8, node_budget=budget,
        recycle=True, backend="xla"))
    node_n = (np.arange(budget) % 3).astype(np.int32)
    node_n[5] = 2 ** 29
    cc = np.asarray(jt.child_count).copy()
    cc[:, ::2] = 0          # make half the pool childless candidates
    jt = jt.replace(node_n=jnp.asarray(np.broadcast_to(node_n, (2, budget))),
                    child_count=jnp.asarray(cc))
    tt.node_n.copy_(torch.as_tensor(node_n))
    tt.child_count.copy_(torch.as_tensor(cc))
    protect = np.array([[2, 6, budget, 9], [0, budget, 4, 12]], np.int32)
    for k in (1, V):
        want_v, want_ok = jax.vmap(lambda t, p: jm._pick_victims(t, p, k))(
            jt, jnp.asarray(protect))
        got_v, got_ok = tm._pick_victims(tt, torch.as_tensor(protect), k)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))


def test_wave1_xla_bitwise_vs_pool_tier():
    """V=1: the staggered descent and the pool tier's sequential kernel
    semantics coincide, so the recycled trees are equal field for field
    (the port's own pool tier, plain versions on the CPU)."""
    n, moves = 3, ["a3", "c3", "c2"]
    _, torch_eval = exact_eval_pair(Engine(n).num_actions)
    trees = {}
    for backend in ("xla", "pallas"):
        cfg = SearchConfig(num_sims=96, wave_size=1, max_children=32,
                           node_budget=24, recycle=True, backend=backend)
        m = MCTS(Engine(n), torch_eval, cfg)
        t = m.init_batch(GameState.from_numpy(start_states(n, moves, 2)))
        trees[backend] = m.run_sims(None, m.prepare_root(None, t)).to_numpy()
    for f, want in trees["pallas"].items():
        if f != "state":
            np.testing.assert_array_equal(trees["xla"][f], want, err_msg=f)


def uniform_eval(num_actions):
    def eval_fn(params, states):
        b = states.ply.shape[0]
        return torch.ones((b, num_actions)), torch.zeros(b)

    return eval_fn


def search(game, num_sims, wave_size=1, k=128, budget=None, recycle=False,
           batch=1):
    engine = Engine(game.n)
    m = MCTS(engine, uniform_eval(engine.num_actions), SearchConfig(
        num_sims=num_sims, wave_size=wave_size, max_children=k,
        node_budget=budget, recycle=recycle, backend="xla"))
    states = game.state.map(lambda x: x.expand((batch,) + x.shape[1:]).clone())
    return m.run_sims(None, m.prepare_root(None, m.init_batch(states)))


def best(tree):
    v = root_visit_counts(tree)[0].numpy()
    return int(len(v) - 1 - np.argmax(v[::-1]))


def test_win_in_one_and_bigger_waves():
    """`tests/test_mcts.py`: the wave-1 and wave-8 searches find the
    road."""
    for sims, V in ((200, 1), (256, 8)):
        g = Game.from_ptn_moves(3, ["a3", "c3", "c2", "a2"], device="cpu")
        g.play_action(best(search(g, sims, V)))
        assert g.result == WHITE_ROAD, (sims, V)


def test_prevent_win_in_two_recycled():
    """`tests/test_recycle.py`: with a 64-node recycled pool, black
    blocks the road and white then has no win."""
    g = Game.from_ptn_moves(3, ["a3", "c3", "c2"], device="cpu")
    for _ in range(2):
        g.play_action(best(search(g, 512, 4, k=16, budget=64, recycle=True)))
        assert g.result == ONGOING


def test_visit_conservation_and_full_pool():
    """`tests/test_mcts.py`: n0 = sims + 1 with no virtual residue; a pool
    that fills almost at once leaks no root virtual visits."""
    g = Game.from_ptn_moves(3, ["a3", "c3", "c2", "a2"], device="cpu")
    t = search(g, 128, 4)
    assert int(t.n0[0]) == 129 and int(t.root_n.sum()) == 128
    assert int(t.virt0[0]) == 0 and not t.root_virt.any()
    assert not t.edge_virt.any()
    t = search(g, 96, 4, k=16, budget=12)
    assert int(t.next_free[0]) == 12 and int(t.virt0[0]) == 0
    assert not t.root_virt.any() and not t.edge_virt.any()
    assert int(t.root_n.sum()) > 0


def test_recycle_invariants_tiny_pool():
    """`tests/test_recycle.py`'s structural invariants on the port's
    recycled xla trees (40-node pool, 256 sims, 2 games); with recycling
    off its bookkeeping fields stay zero."""
    g = Game.from_ptn_moves(3, ["a3", "c3"], device="cpu")
    t = search(g, 256, 8, k=16, budget=40, recycle=True, batch=2)
    assert int(t.next_free[0]) == 40
    fields = t.to_numpy()
    view = type("T", (), {f: fields[f] for f in fields})
    for game in range(2):
        check_invariants(view, 256, game)
    t = search(g, 64, 4, k=16, budget=32)
    assert not t.node_n.any() and not t.node_virt.any()
    assert not t.child_count.any()


def test_tier_rule():
    """"xla" when asked; `auto` onto "xla" only when neither kernel tier
    fits; `gumbel_m` forces "xla" and refuses the kernel tiers; recycling
    refuses the large-tree tier."""
    engine = Engine(6)

    def tier(**kw):
        return MCTS(engine, None, SearchConfig(**kw)).tier

    assert tier(backend="xla") == "xla"
    assert tier(num_sims=256, wave_size=256, max_children=32,
                node_budget=1280, recycle=True) == "pool"
    assert tier(num_sims=64, wave_size=64, node_budget=131_072) == "hbm"
    # a recycled pool beyond the pool tier, or any pool beyond both tiers
    assert tier(num_sims=64, max_children=32, node_budget=20_000,
                recycle=True) == "xla"
    assert tier(num_sims=64, node_budget=200_000) == "xla"
    assert tier(num_sims=64, gumbel_m=16) == "xla"
    for backend in ("pallas", "pallas_hbm"):
        with pytest.raises(ValueError):
            tier(num_sims=64, gumbel_m=16, backend=backend)
    with pytest.raises(ValueError):
        tier(recycle=True, backend="pallas_hbm")
    with pytest.raises(ValueError):
        tier(backend="tpu")


def test_helpers_equal_jax():
    """`types.result_is_road` / `result_is_draw` over every result code and
    `tree.root_child_rewards` on a searched tree equal the JAX package's."""
    from tak_tpu import types as jax_types
    from tak_tpu.mcts.tree import root_child_rewards as jax_rewards
    from tak_tpu_torch import types
    from tak_tpu_torch.mcts.tree import root_child_rewards

    codes = np.arange(7, dtype=np.int32)
    for f in ("result_is_road", "result_is_draw"):
        want = np.asarray(getattr(jax_types, f)(jnp.asarray(codes)))
        np.testing.assert_array_equal(
            getattr(types, f)(torch.as_tensor(codes)).numpy(), want)
        np.testing.assert_array_equal(getattr(types, f)(codes), want)
    jt, tt = run_both(4, ["a4", "d4", "b2"], waves=4, wave_size=4, k=8,
                      budget=16, recycle=True)
    np.testing.assert_array_equal(root_child_rewards(tt).numpy(),
                                  np.asarray(jax.vmap(jax_rewards)(jt)))
