"""PyTorch port's packed legal bits, step+legal and the packed top-Ks
against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX kernel (`build_fused_step_legal`) runs in Pallas interpret mode on the
CPU, one block of 8 rows, as `tests/test_pallas_env.py` runs it; the port
runs its plain PyTorch versions.  Every comparison is exact (integer
state, bit words, bool masks, float priors that both sides only select
and copy) unless a test states a tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tak_tpu.engine.core import Engine as JaxEngine
from tak_tpu.engine.pallas_env import (
    _pattern_class_tables,
    build_fused_step_legal,
)
from tak_tpu.engine.pallas_env import masked_topk_packed as jax_topk_packed
from tak_tpu.engine.pallas_env import unpack_legal as jax_unpack_legal
from tak_tpu.mcts.search import masked_topk as jax_masked_topk
from tak_tpu_torch.engine.core import Engine
from tak_tpu_torch.engine.legal_bits import (
    legal_bits_plain,
    masked_topk_packed,
    pattern_class_tables,
    step_legal_plain,
    unpack_legal,
)
from tak_tpu_torch.mcts import search as search_mod
from tak_tpu_torch.mcts.search import MCTS, SearchConfig, masked_topk
from tak_tpu_torch.mcts.tree import TENSOR_FIELDS
from tak_tpu_torch.types import GameState

from tests.test_pallas_env78 import tall_stack_states
from tests.test_torch_engine import (
    assert_states_equal,
    jax_to_torch,
    random_actions,
)

B = 8  # one kernel block


def words_i32(x):
    """The JAX package's uint32 words as the port stores them: the same
    bit patterns in int32."""
    return np.asarray(x).view(np.int32)


def check_step_legal(je, te, js, acts, enabled, rng, k, msg):
    """One step+legal call on both sides; returns the JAX output states."""
    fused = build_fused_step_legal(je, block_g=B, interpret=True)
    en = None if enabled is None else jnp.asarray(enabled)
    ref, rplace, rspread = fused(js, jnp.asarray(acts), en)
    ten = None if enabled is None else torch.as_tensor(enabled)
    got, place, spread = step_legal_plain(te, jax_to_torch(js),
                                          torch.as_tensor(acts), ten)
    assert_states_equal(ref, got, msg)
    assert place.dtype == torch.int32 and spread.dtype == torch.int32
    np.testing.assert_array_equal(place.numpy(), words_i32(rplace),
                                  err_msg=f"{msg} place words")
    np.testing.assert_array_equal(spread.numpy(), words_i32(rspread),
                                  err_msg=f"{msg} spread words")
    ref_legal = np.asarray(je.batched_legal_mask(ref))
    np.testing.assert_array_equal(
        unpack_legal(te, place, spread).numpy(), ref_legal,
        err_msg=f"{msg} unpacked mask")
    np.testing.assert_array_equal(te.legal_mask(got).numpy(), ref_legal,
                                  err_msg=f"{msg} dense oracle")

    policy = rng.random((B, je.num_actions)).astype(np.float32)
    rv, ri = jax_topk_packed(je, jnp.asarray(policy), rplace, rspread, k)
    gv, gi = masked_topk_packed(te, torch.as_tensor(policy), place, spread, k)
    rv, ri = np.asarray(rv), np.asarray(ri)
    np.testing.assert_array_equal(gv.numpy(), rv, err_msg=f"{msg} topk vals")
    sel = rv >= 0
    np.testing.assert_array_equal(gi.numpy()[sel], ri[sel],
                                  err_msg=f"{msg} topk ids")
    assert gi.dtype == torch.int32
    return ref


@pytest.mark.parametrize("n", [3, 4, 5, 6, 7, 8])
def test_pattern_class_tables(n):
    want = _pattern_class_tables(n)
    got = pattern_class_tables(n)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    te = Engine(n)
    assert te.pattern_words == want[0]
    flat = te.tensors("cpu")["legal_tables"].numpy()
    assert flat.dtype == np.int32 and flat.shape == (3 * n + 1, want[0])
    np.testing.assert_array_equal(flat.view(np.uint32),
                                  np.concatenate(want[1:]))


@pytest.mark.parametrize("n", [3, 5, 6])
def test_step_legal_playout_parity(n):
    """12 plies of random legal play with 10% disabled rows: states, packed
    words, the unpacked mask and the top-K over the words all equal the
    JAX package's (games finish and freeze along the way at n=3)."""
    je, te = JaxEngine(n), Engine(n)
    rng = np.random.default_rng(400 + n)
    js = je.initial_batch(B, 3)
    for ply in range(12):
        masks = np.asarray(je.batched_legal_mask(js))
        acts = random_actions(rng, masks)
        enabled = rng.random(B) < 0.9
        check_step_legal(je, te, js, acts, enabled, rng, 16,
                         f"n={n} ply={ply}")
        js = je.batched_step(js, jnp.asarray(acts))


@pytest.mark.parametrize("n,hs", [
    (7, [30, 33, 40, 62, 65, 70, 80, 33]),
    (8, [31, 34, 63, 66, 90, 95, 97, 100]),
])
def test_step_legal_tall_stacks(n, hs):
    """Spreads from and placements onto stacks that span words 1-3 (sizes
    7 and 8: wp = 4 and 8, three and four stack words)."""
    je, te = JaxEngine(n), Engine(n)
    js = tall_stack_states(je, hs, seed=n)
    masks = np.asarray(je.batched_legal_mask(js))
    rng = np.random.default_rng(5 + n)
    for round_ in range(4):
        acts = np.zeros(B, np.int32)
        for g in range(B):
            legal = np.nonzero(masks[g])[0]
            spreads = legal[legal >= 3 * je.num_squares]
            pool = spreads if (len(spreads) and rng.random() < 0.8) else legal
            acts[g] = rng.choice(pool) if len(pool) else 0
        js = check_step_legal(je, te, js, acts, None, rng, 16,
                              f"n={n} round={round_}")
        masks = np.asarray(je.batched_legal_mask(js))


@pytest.mark.parametrize("n", [4, 6])
def test_legal_bits_equal_dense_mask_along_playouts(n):
    """`unpack_legal(legal_bits_plain(s))` == the port's `legal_mask(s)` on
    every state of 40-ply playouts (openings, mid-games, finished games)."""
    te = Engine(n)
    rng = np.random.default_rng(n)
    ts = te.initial_batch(B, 2, device="cpu")
    for ply in range(40):
        mask = te.legal_mask(ts)
        place, spread = legal_bits_plain(te, ts)
        assert torch.equal(unpack_legal(te, place, spread), mask), ply
        ts = te.step(ts, torch.as_tensor(random_actions(rng, mask.numpy())))


def test_masked_topk_packed_ties():
    """A policy of a few distinct bf16 values: equal priors resolve to the
    lower action id, as `jax.lax.top_k(where(legal, p, -1))` does, in every
    slot: with K 128 (more than the legal actions) the pads hold -1 and the
    lowest illegal ids, ascending, on both sides."""
    n = 5
    je, te = JaxEngine(n), Engine(n)
    rng = np.random.default_rng(3)
    js = je.initial_batch(B, 3)
    for _ in range(10):
        acts = random_actions(rng, np.asarray(je.batched_legal_mask(js)))
        js = je.batched_step(js, jnp.asarray(acts))
    legal = np.asarray(je.batched_legal_mask(js))
    levels = np.array([0.0, 0.00390625, 0.0078125, 0.25], np.float32)
    policy = levels[rng.integers(0, len(levels), legal.shape)]
    place, spread = legal_bits_plain(te, jax_to_torch(js))
    assert legal.sum(1).max() < 128
    for k in (24, 128):
        rv, ri = jax.lax.top_k(jnp.where(legal, policy, -1.0), k)
        rv, ri = np.asarray(rv), np.asarray(ri)
        assert (rv[:, 1:] == rv[:, :-1]).any()
        assert (rv < 0).any() == (k == 128)
        for dtype in (torch.float32, torch.bfloat16):
            gv, gi = masked_topk_packed(
                te, torch.as_tensor(policy).to(dtype), place, spread, k)
            np.testing.assert_array_equal(gv.numpy(), rv)
            np.testing.assert_array_equal(gi.numpy(), ri)


@functools.lru_cache(maxsize=None)
def topk_rows(n):
    """(engine, states, dense legal mask) of 12 rows at size n: three
    openings (fewer legal actions than K 128), the rest seeded random
    playouts of 4 to 40 plies."""
    te = Engine(n)
    rng = np.random.default_rng(900 + n)
    ts = te.initial_batch(12, 2, device="cpu")
    stop = np.concatenate([[0, 0, 0], rng.integers(4, 41, 9)])
    for ply in range(40):
        mask = te.legal_mask(ts)
        acts = torch.as_tensor(random_actions(rng, mask.numpy()))
        ts = te.step(ts, acts, torch.as_tensor(stop > ply))
    return te, ts, te.legal_mask(ts)


@pytest.mark.parametrize("kind", ["softmax", "ties", "zeros"])
@pytest.mark.parametrize("k", [16, 32, 128])
@pytest.mark.parametrize("n", [6, 8])
def test_masked_topk_packed_is_exact_in_every_slot(n, k, kind):
    """`masked_topk_packed` (the legal top-K kernel's plain version) is
    bitwise `masked_topk(policy, legal_mask, k, "exact")` in every slot,
    pads included: softmax rows, rows of four tied levels (ties at the K
    boundary), and rows whose legal priors are all 0.0, on openings and
    played-out positions."""
    te, ts, legal = topk_rows(n)
    rng = np.random.default_rng([n, k])
    A = te.num_actions
    if kind == "softmax":
        policy = torch.softmax(torch.as_tensor(
            3.0 * rng.standard_normal((12, A)), dtype=torch.float32), -1)
    elif kind == "ties":
        levels = torch.tensor([0.0, 2.0 ** -12, 2.0 ** -8, 0.25])
        policy = levels[torch.as_tensor(rng.integers(0, 4, (12, A)))]
    else:
        policy = torch.zeros((12, A))
    place, spread = legal_bits_plain(te, ts)
    gv, gi = masked_topk_packed(te, policy, place, spread, k)
    wv, wi = masked_topk(policy, legal, k, "exact")
    assert torch.equal(gi, wi)
    assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))
    padded = bool((legal.sum(1) < k).any())
    assert padded == (k == 128) and bool((gv < 0).any()) == padded
    if kind != "softmax":
        assert bool((gv[:, 1:] == gv[:, :-1]).any())


def test_eval_and_topk_routing():
    """The leaf step emits the words with `fused_leaf_legal`, and on a card
    whenever the top-K is exact and K at most 128 (the legal top-K kernel
    reads them); never for a packed top-K without the option.  On the CPU the default stays
    the dense mask, and a pool-tier search's tree is the same, node states
    included, when the words are forced (what the card runs: `legal_topk`,
    here its plain version)."""
    from tests.test_torch_search import exact_eval_pair, start_states

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    te = Engine(4)
    for topk, fused, k, on_card, on_cpu in (
            ("auto", False, 128, True, False),
            ("exact", False, 32, True, False),
            ("exact", False, 129, False, False),
            ("packed", False, 32, False, False),
            ("packedq", False, 32, False, False),
            ("auto", True, 32, True, True),
            ("packedq", True, 32, True, True)):
        m = MCTS(te, None, SearchConfig(num_sims=8, topk_impl=topk,
                                        max_children=k,
                                        fused_leaf_legal=fused))
        assert m._leaf_words(cuda) == on_card, (topk, fused, k)
        assert m._leaf_words(cpu) == on_cpu, (topk, fused, k)

    _, torch_eval = exact_eval_pair(te.num_actions)
    cfg = SearchConfig(num_sims=48, wave_size=4, max_children=16,
                       node_budget=24, recycle=True, backend="pallas")
    states = GameState.from_numpy(start_states(4, ["a1", "d4", "b2"], 2))
    calls = []
    real = search_mod.legal_topk

    def spy(*args):
        calls.append(args[1].shape)
        return real(*args)

    trees = []
    for forced in (False, True):
        m = MCTS(te, torch_eval, cfg)
        assert m.tier == "pool"
        if forced:
            m._leaf_words = lambda device: True
        search_mod.legal_topk = spy
        try:
            tree = m.run_sims(None, m.prepare_root(None, m.init_batch(states)))
        finally:
            search_mod.legal_topk = real
        assert bool(calls) == forced
        trees.append(tree)
    for f in TENSOR_FIELDS:
        assert torch.equal(getattr(trees[0], f), getattr(trees[1], f)), f
    assert_states_equal(trees[0].state, trees[1].state, "node states")


def _distinct_policy(rng, rows, a, q_bits=17):
    """Rows of [0,1] values that are all distinct after q_bits rounding."""
    scale = (1 << q_bits) - 1
    qs = np.stack([rng.choice(scale + 1, size=a, replace=False)
                   for _ in range(rows)])
    return (qs.astype(np.float64) / scale).astype(np.float32)


@pytest.mark.parametrize("impl", ["packed", "packedq"])
@pytest.mark.parametrize("a,k", [(9036, 32), (1575, 17), (300, 8)])
def test_packed_topk_matches_jax(a, k, impl):
    """ids exact; `packed` values exact (and equal to "exact" on
    quantization-distinct priors); `packedq` values equal the JAX packedq
    (both decode the same integer; tolerance 0) and lie within 2^-17 of the
    true prior."""
    rng = np.random.default_rng(0)
    policy = _distinct_policy(rng, 4, a)
    legal = rng.random((4, a)) < 0.03
    rv, ri = jax_masked_topk(jnp.asarray(policy), jnp.asarray(legal), k, impl)
    gv, gi = masked_topk(torch.as_tensor(policy), torch.as_tensor(legal), k,
                         impl)
    rv, ri = np.asarray(rv), np.asarray(ri)
    np.testing.assert_array_equal(gi.numpy(), ri)
    np.testing.assert_array_equal(gv.numpy(), rv)
    assert gi.dtype == torch.int32 and gv.dtype == torch.float32
    ev, ei = masked_topk(torch.as_tensor(policy), torch.as_tensor(legal), k,
                         "exact")
    sel = ev.numpy() >= 0
    np.testing.assert_array_equal(gi.numpy()[sel], ei.numpy()[sel])
    if impl == "packed":
        np.testing.assert_array_equal(gv.numpy(), ev.numpy())
    else:
        assert np.abs(gv.numpy() - ev.numpy())[sel].max() < 2.0 ** -17


@pytest.mark.parametrize("impl", ["packed", "packedq"])
def test_packed_topk_pads_and_zero_priors(impl):
    """Fewer legal entries than K: pads are (-1, 0), on both sides alike;
    a legal action of prior 0 still beats an illegal slot; a bf16 policy
    is cast to float32 first."""
    a, k = 512, 16
    rng = np.random.default_rng(1)
    policy = _distinct_policy(rng, 2, a)
    legal = np.zeros((2, a), bool)
    legal[:, [3, 100, 511]] = True
    rv, ri = jax_masked_topk(jnp.asarray(policy), jnp.asarray(legal), k, impl)
    gv, gi = masked_topk(torch.as_tensor(policy), torch.as_tensor(legal), k,
                         impl)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    assert (gv.numpy()[:, 3:] == -1.0).all() and (gi.numpy()[:, 3:] == 0).all()
    assert {3, 100, 511} == set(gi.numpy()[0, :3].tolist())

    zero = torch.zeros((1, 256))
    one_legal = torch.zeros((1, 256), dtype=torch.bool)
    one_legal[0, 7] = True
    vp, ip = masked_topk(zero, one_legal, 4, impl)
    assert float(vp[0, 0]) == 0.0 and int(ip[0, 0]) == 7
    assert (vp.numpy()[0, 1:] == -1.0).all()

    half = torch.as_tensor(policy).to(torch.bfloat16)
    hv, hi = masked_topk(half, torch.as_tensor(legal), k, impl)
    fv, fi = masked_topk(half.float(), torch.as_tensor(legal), k, impl)
    assert torch.equal(hv, fv) and torch.equal(hi, fi)


def test_topk_impl_resolution():
    """"auto" is "exact" in the port on every device; unknown names raise
    in the config and in the function."""
    te = Engine(5)
    assert MCTS(te, None, SearchConfig(num_sims=8)).topk_impl == "exact"
    assert MCTS(te, None, SearchConfig(num_sims=8, topk_impl="packedq")
                ).topk_impl == "packedq"
    assert not SearchConfig().fused_leaf_legal
    with pytest.raises(ValueError):
        MCTS(te, None, SearchConfig(num_sims=8, topk_impl="bogus"))
    with pytest.raises(ValueError):
        masked_topk(torch.zeros((1, 8)), torch.ones((1, 8), dtype=torch.bool),
                    2, "bogus")
