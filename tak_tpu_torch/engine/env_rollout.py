"""Uniform legal sampling and the whole random-playout loop in one kernel.

Counterpart of `tak_tpu/engine/pallas_env.py` `_sample_action`,
`build_legal_sampler` (:927) and `build_env_rollout` (:990).  The wrappers
`legal_sampler` and `env_rollout` run the CUDA kernels of
`csrc/env_rollout.cu` on CUDA tensors and their plain PyTorch versions
(`legal_sampler_plain`, `env_rollout_plain`) on CPU tensors.

Sampling.  A row's legal actions are counted over the reference's group
order, which is NOT the action-id order: the placement bits 0, 1, 2 (each
over the squares ascending), then for each direction d and pattern word w
the word group (d, w) over the squares ascending, set bits ascending
inside a word.  The draw is `r = bits % max(total, 1)` on unsigned 32-bit
words and picks the r-th legal action in that order; a row with no legal
action gets action 0.

Random words.  Either the caller gives them (`bits`: an int64 tensor
carrying u32 values, [R] for the sampler, [T, R] for the rollout; the mode
held against the JAX package) or they come from a seed: Philox4x32-10
(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", 2011) with
key = the 64-bit seed and counter = (row, step, 0, 0), first output word.
The generator is written out in the kernel and in `philox_bits_plain`, so
the two agree bit for bit; there is no global random state.  The seed is
an int, or a `torch.Generator` from which one is drawn.

Rollout step (T times): legal bits and sample of the state at hand; step;
result; rows finished on entry stay frozen; rows finished now restart from
the initial position with their `half_komi`.

What bounds the rollout kernel on the H100: operations.  The state is
read once and written once (1.8 KB per 6x6 row) around T steps of
integer, branchy work per row; one warp holds a row for the whole
rollout, a square per lane in registers (`csrc/env_warp.cuh`), so nothing
but the final state goes back to device memory.  The sampler kernel
keeps one thread per row.
"""

from __future__ import annotations

import torch

from ..kernels import build as kb
from ..types import FIELDS, ONGOING, GameState, where_state
from . import fused_env, legal_bits

MASK32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(m: int, c):
    """(high, low) 32-bit halves of m * c for u32 values in int64 tensors
    (the 64-bit product would overflow int64, so c is split in two)."""
    a = m * (c & 0xFFFF)
    b = m * (c >> 16)
    low = a + ((b & 0xFFFF) << 16)
    return (b >> 16) + (low >> 32), low & MASK32


def split_seed(seed) -> tuple[int, int]:
    """The Philox key (low, high 32 bits) of a seed: an int, or a
    `torch.Generator` from which a 62-bit seed is drawn."""
    if isinstance(seed, torch.Generator):
        seed = int(torch.randint(0, 1 << 62, (1,), generator=seed,
                                 device=seed.device).item())
    if isinstance(seed, bool) or not isinstance(seed, int):
        raise TypeError(f"seed must be an int or a torch.Generator, "
                        f"not {type(seed).__name__}")
    return seed & MASK32, (seed >> 32) & MASK32


def philox_bits_plain(seed, rows, step: int):
    """Philox4x32-10 words for `rows` (int64 tensor of row indices) at
    `step`: int64 tensor of u32 values."""
    k0, k1 = split_seed(seed)
    c0 = rows.long() & MASK32
    c1 = torch.full_like(c0, step & MASK32)
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    for _ in range(10):
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W0) & MASK32
        k1 = (k1 + PHILOX_W1) & MASK32
    return c0


def _popcount32(x):
    """Set bits of u32 values held in int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def sample_action_plain(engine, place, spread, bits):
    """(action [R] int32, total [R] int32): the `bits % total`-th legal
    action of each row in the group order of the module docstring."""
    n2, P = engine.num_squares, engine.num_pat
    R, wp = place.shape[0], spread.shape[2]
    dev = place.device
    b3 = torch.arange(3, device=dev)
    pl = (place.long()[:, None, :] >> b3[None, :, None]) & 1        # [R,3,n2]
    words = torch.cat([pl, spread.long().reshape(R, 4 * wp, n2) & MASK32], 1)
    counts = _popcount32(words).reshape(R, -1)        # group-major, square
    cum = torch.cumsum(counts, 1)
    total = cum[:, -1]
    r = (bits.long() & MASK32) % torch.clamp(total, min=1)
    idx = (cum > r[:, None]).int().argmax(1)          # 0 when nothing legal
    rows = torch.arange(R, device=dev)
    g, q = idx // n2, idx % n2
    rank = r - (cum[rows, idx] - counts[rows, idx])
    word = words.reshape(R, -1)[rows, idx]
    b32 = torch.arange(32, device=dev)
    set_bits = (word[:, None] >> b32[None, :]) & 1
    bit = (torch.cumsum(set_bits, 1) > rank[:, None]).int().argmax(1)
    dw = torch.clamp(g - 3, min=0)
    spread_action = (3 + (dw // wp) * P + (dw % wp) * 32 + bit) * n2 + q
    action = torch.where(g < 3, g * n2 + q, spread_action)
    action = torch.where(total > 0, action, torch.zeros_like(action))
    return action.to(torch.int32), total.to(torch.int32)


def _words_for(state: GameState, bits, seed, step: int):
    if (bits is None) == (seed is None):
        raise ValueError("give exactly one of bits and seed")
    if bits is not None:
        return bits
    rows = torch.arange(state.ply.shape[0], device=state.device)
    return philox_bits_plain(seed, rows, step)


def legal_sampler_plain(engine, state: GameState, bits=None, seed=None):
    """Plain PyTorch version of `legal_sampler`."""
    place, spread = legal_bits.legal_bits_plain(engine, state)
    return sample_action_plain(engine, place, spread,
                               _words_for(state, bits, seed, 0))


def env_rollout_plain(engine, state: GameState, num_steps: int, bits=None,
                      seed=None) -> GameState:
    """Plain PyTorch version of `env_rollout`: a Python loop of plain legal
    bits, plain sample, `step_plain` and the reset."""
    if seed is not None:             # a generator is drawn from once
        k0, k1 = split_seed(seed)
        seed = k0 | (k1 << 32)
    R = state.ply.shape[0]
    fresh = engine.initial_batch(R, 0, state.device).replace(
        half_komi=state.half_komi)
    for t in range(num_steps):
        words = _words_for(state, None if bits is None else bits[t], seed, t)
        place, spread = legal_bits.legal_bits_plain(engine, state)
        action, _ = sample_action_plain(engine, place, spread, words)
        state = fused_env.step_plain(engine, state, action)
        state = where_state(state.result != ONGOING, fresh, state)
    return state


def _random_args(bits, seed, shape, device, what: str):
    """(bits pointer, use_seed, k0, k1) for the kernels."""
    if (bits is None) == (seed is None):
        raise ValueError(f"{what}: give exactly one of bits and seed")
    if bits is None:
        return None, 1, *split_seed(seed)
    if (bits.dtype != torch.int64 or tuple(bits.shape) != shape
            or not bits.is_contiguous() or bits.device != device):
        raise ValueError(f"{what}: bits must be a contiguous int64 "
                         f"{list(shape)} tensor of u32 values on {device}")
    return kb.ptr(bits), 0, 0, 0


def legal_sampler(engine, state: GameState, bits=None, seed=None):
    """(states [R], bits [R] int64 u32 values | seed) -> (actions [R] int32,
    legal counts [R] int32): one uniform legal action per row.  CUDA
    tensors launch the kernel, CPU tensors run `legal_sampler_plain`."""
    if state.device.type == "cpu":
        return legal_sampler_plain(engine, state, bits, seed)
    if not 3 <= engine.n <= 8:
        raise ValueError(f"legal_sampler supports sizes 3-8, not {engine.n}")
    R = state.ply.shape[0]
    dev = state.device
    fused_env.check_state(engine, state, R, "legal_sampler")
    bits_ptr, use_seed, k0, k1 = _random_args(bits, seed, (R,), dev,
                                              "legal_sampler")
    action = torch.empty(R, dtype=torch.int32, device=dev)
    total = torch.empty(R, dtype=torch.int32, device=dev)
    if R == 0:
        return action, total
    lib = kb.library("env_rollout")
    err = lib.tak_legal_sampler(
        engine.n, R, *[kb.ptr(getattr(state, f)) for f in FIELDS],
        kb.ptr(engine.tensors(dev)["legal_tables"]), bits_ptr, use_seed, k0,
        k1, kb.ptr(action), kb.ptr(total), kb.stream_ptr(dev))
    kb.check(err, "legal_sampler")
    kb.LAUNCHES["legal_sampler"] += 1
    return action, total


def env_rollout(engine, state: GameState, num_steps: int, bits=None,
                seed=None) -> GameState:
    """(states [R], bits [T, R] int64 u32 values | seed) -> states after
    `num_steps` uniform random legal steps with the reset of finished
    games, in ONE kernel launch.  CUDA tensors launch the kernel, CPU
    tensors run `env_rollout_plain`."""
    if state.device.type == "cpu":
        return env_rollout_plain(engine, state, num_steps, bits, seed)
    if not 3 <= engine.n <= 8:
        raise ValueError(f"env_rollout supports sizes 3-8, not {engine.n}")
    R = state.ply.shape[0]
    dev = state.device
    fused_env.check_state(engine, state, R, "env_rollout")
    bits_ptr, use_seed, k0, k1 = _random_args(
        bits, seed, (num_steps, R), dev, "env_rollout")
    out = state.map(torch.empty_like)
    if R == 0:
        return out
    lib = kb.library("env_rollout")
    args = [kb.ptr(getattr(state, f)) for f in FIELDS]
    args += [kb.ptr(getattr(out, f)) for f in FIELDS]
    err = lib.tak_env_rollout(
        engine.n, R, num_steps, engine.start_stones, engine.start_caps, *args,
        kb.ptr(engine.tensors(dev)["legal_tables"]), bits_ptr, use_seed, k0,
        k1, kb.stream_ptr(dev))
    kb.check(err, "env_rollout")
    kb.LAUNCHES["env_rollout"] += 1
    return out
