"""PyTorch port's legal sampler and env rollout against the JAX package.

The JAX kernels (`build_legal_sampler`, `build_env_rollout`) run in Pallas
interpret mode on the CPU with `external_bits=True`, one block of 8 rows,
as `tests/test_pallas_env.py` runs them (the TPU's own generator has no CPU
lowering); the port runs its plain PyTorch versions on the same sampling
words.  Every comparison is exact.  The seeded mode (Philox4x32-10) has no
JAX counterpart: it is held against a reference of the generator written
with Python integers, and checked for determinism, legality and piece
conservation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tak_tpu.engine.core import Engine as JaxEngine
from tak_tpu.engine.pallas_env import build_env_rollout, build_legal_sampler
from tak_tpu.types import ONGOING
from tak_tpu_torch.engine.core import Engine
from tak_tpu_torch.engine.env_rollout import (
    env_rollout,
    env_rollout_plain,
    legal_sampler,
    legal_sampler_plain,
    philox_bits_plain,
    sample_action_plain,
    split_seed,
)
from tak_tpu_torch.engine.legal_bits import legal_bits_plain
from tak_tpu_torch.types import FIELDS

from tests.test_pallas_env import random_playout_states
from tests.test_torch_engine import assert_states_equal, jax_to_torch

B = 8  # one kernel block


def u32_words(rng, shape):
    """(uint32 array for JAX, int64 tensor of the same values for the
    port)."""
    bits = rng.integers(0, 2 ** 32, shape, dtype=np.uint64)
    return bits.astype(np.uint32), torch.as_tensor(bits.astype(np.int64))


@pytest.mark.parametrize("n", [5, 6, 7, 8])
@pytest.mark.parametrize("plies", [0, 1, 9, 40])
def test_sampler_matches_jax(n, plies):
    """(action, total) == the JAX sampler kernel on the same words, row by
    row; totals equal the legal counts and sampled actions are legal."""
    je, te = JaxEngine(n), Engine(n)
    sampler = build_legal_sampler(je, block_g=B, interpret=True,
                                  external_bits=True)
    js = random_playout_states(je, plies, seed=31 + n + plies)
    jbits, tbits = u32_words(np.random.default_rng(5), B)
    # the extremes of the unsigned modulo
    jbits[:2] = [0xFFFFFFFF, 0x80000000]
    tbits[:2] = torch.tensor([0xFFFFFFFF, 0x80000000])
    want_a, want_t = sampler(js, jnp.asarray(jbits))
    ts = jax_to_torch(js)
    got_a, got_t = legal_sampler(te, ts, bits=tbits)
    assert got_a.dtype == torch.int32 and got_t.dtype == torch.int32
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    masks = te.legal_mask(ts).numpy()
    results = ts.result.numpy()
    for g in range(B):
        assert got_t[g] == masks[g].sum(), (n, plies, g)
        if results[g] == ONGOING and got_t[g] > 0:
            assert masks[g][got_a[g]], (n, plies, g, int(got_a[g]))


def test_sampler_reaches_every_legal_action():
    """r = 0..total-1 enumerates the legal actions of a position exactly
    once each, in the group order (placements by kind, then direction and
    pattern word, squares ascending inside a group)."""
    n = 5
    je, te = JaxEngine(n), Engine(n)
    ts = jax_to_torch(random_playout_states(je, 6, seed=77 + n))
    legal0 = np.nonzero(te.legal_mask(ts).numpy()[0])[0]
    one = ts[:1]
    place, spread = legal_bits_plain(te, one)
    total = len(legal0)
    rep = lambda x: x.expand((total,) + tuple(x.shape[1:]))
    acts, tots = sample_action_plain(te, rep(place), rep(spread),
                                     torch.arange(total))
    assert (tots.numpy() == total).all()
    assert sorted(acts.tolist()) == legal0.tolist()
    n2, P, wp = te.num_squares, te.num_pat, te.pattern_words

    def group_key(a):
        ch, q = divmod(a, n2)
        if ch < 3:
            return (ch, q, 0)
        d, p = divmod(ch - 3, P)
        return (3 + d * wp + p // 32, q, p % 32)

    assert acts.tolist() == sorted(acts.tolist(), key=group_key)
    # r wraps around: bits = total + r samples the same action as r
    again, _ = sample_action_plain(te, rep(place), rep(spread),
                                   torch.arange(total) + total)
    assert torch.equal(again, acts)


@pytest.mark.parametrize("n", [6, 7])
def test_rollout_matches_jax(n):
    """T=12 steps with injected words [T, B] == the JAX rollout kernel on
    every field (states 4 plies in, komi 3 kept through the resets)."""
    je, te = JaxEngine(n), Engine(n)
    T = 12
    rollout = build_env_rollout(je, T, block_g=B, interpret=True,
                                external_bits=True)
    jbits, tbits = u32_words(np.random.default_rng(n), (T, B))
    js = random_playout_states(je, 4, seed=13 * n)
    want = rollout(js, jnp.asarray(jbits))
    got = env_rollout_plain(te, jax_to_torch(js), T, bits=tbits)
    assert_states_equal(want, got, f"n={n} rollout")
    run = te.env_rollout_fn(T, external_bits=True)
    assert_states_equal(want, run(jax_to_torch(js), tbits), "env_rollout_fn")


def test_rollout_resets_finished_games():
    """On 3x3 games end within a few plies: after 30 steps every row is
    ongoing again (reset to the start with its own komi), and rows that
    were finished on entry restart too, exactly as in the JAX kernel."""
    n, T = 3, 30
    je, te = JaxEngine(n), Engine(n)
    js = random_playout_states(je, 12, seed=3)
    komi = np.arange(B, dtype=np.int32) - 2
    js = js.replace(half_komi=jnp.asarray(komi))
    assert (np.asarray(js.result) != ONGOING).any()
    jbits, tbits = u32_words(np.random.default_rng(9), (T, B))
    rollout = build_env_rollout(je, T, block_g=B, interpret=True,
                                external_bits=True)
    want = rollout(js, jnp.asarray(jbits))
    got = env_rollout_plain(te, jax_to_torch(js), T, bits=tbits)
    assert_states_equal(want, got, "3x3 rollout")
    assert (got.result.numpy() == ONGOING).all()
    np.testing.assert_array_equal(got.half_komi.numpy(), komi)
    assert (got.ply.numpy() < T).any()       # some game restarted


def philox_reference(seed, row, step):
    """Philox4x32-10 with Python integers: key = seed, counter =
    (row, step, 0, 0); returns the four output words."""
    mask = 0xFFFFFFFF
    k0, k1 = seed & mask, (seed >> 32) & mask
    c = [row, step, 0, 0]
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & mask, (p0 >> 32) ^ c[3] ^ k1,
             p0 & mask]
        k0, k1 = (k0 + 0x9E3779B9) & mask, (k1 + 0xBB67AE85) & mask
    return c


def test_philox_plain_matches_reference():
    # the generator's published known-answer vectors
    assert philox_reference(0, 0, 0) == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    rows = torch.tensor([0, 1, 2, 8191, 0xFFFFFFFF, 123456789])
    for seed, step in ((0, 0), (1, 0), (7, 63), (0xDEADBEEFCAFEF00D, 5),
                       ((1 << 64) - 1, 0xFFFFFFFF)):
        got = philox_bits_plain(seed, rows, step)
        want = [philox_reference(seed, int(r), step)[0] for r in rows]
        assert got.dtype == torch.int64
        assert got.tolist() == want, (seed, step)
    gen = torch.Generator().manual_seed(4)
    k = split_seed(gen)
    assert k == split_seed(torch.Generator().manual_seed(4))
    with pytest.raises(TypeError):
        split_seed(1.5)


def pieces(state):
    """Per row and colour pair: pieces on the board plus both reserves."""
    return (state.heights.sum(-1) + state.stones.sum(-1)
            + state.caps.sum(-1)).numpy()


def test_seeded_rollout():
    """Seeded mode: deterministic for a seed, different for two seeds,
    equal to the external mode fed the generator's words, every sampled
    action legal, pieces conserved."""
    n, T, R = 6, 24, B
    te = Engine(n)
    start = te.initial_batch(R, 4, device="cpu")
    a = env_rollout(te, start, T, seed=11)
    b = env_rollout(te, start, T, seed=11)
    c = env_rollout(te, start, T, seed=12)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert not torch.equal(a.heights, c.heights)
    rows = torch.arange(R)
    words = torch.stack([philox_bits_plain(11, rows, t) for t in range(T)])
    d = env_rollout(te, start, T, bits=words)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(d, f)), f
    run = te.env_rollout_fn(T)
    e = run(start, 11)
    assert torch.equal(e.stacks, a.stacks) and torch.equal(e.ply, a.ply)
    assert (pieces(a) == pieces(start)).all()
    assert (a.result.numpy() == ONGOING).all() and (a.half_komi == 4).all()

    # step by step: each sampled action is legal and uses that step's word
    state = start
    for t in range(6):
        act, tot = legal_sampler_plain(te, state, bits=words[t])
        mask = te.legal_mask(state)
        assert mask[rows, act.long()].all() and (tot == mask.sum(1)).all()
        state = env_rollout(te, state, 1, bits=words[t:t + 1])
    # the seeded sampler draws the step-0 word of each row
    s_act, _ = legal_sampler(te, start, seed=11)
    w_act, _ = legal_sampler(te, start, bits=words[0])
    assert torch.equal(s_act, w_act)
    with pytest.raises(ValueError):
        legal_sampler(te, start)
    with pytest.raises(ValueError):
        env_rollout(te, start, 2, bits=words[:2], seed=1)
