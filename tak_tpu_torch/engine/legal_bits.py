"""Packed legal-move bits, the fused step that emits them, and the top-K
that reads them.

Counterpart of `tak_tpu/engine/pallas_env.py` `_pattern_class_tables`,
`_legal_bits`, `unpack_legal`, `masked_topk_packed` and
`build_fused_step_legal` (:836).  The wrapper `step_legal` runs the CUDA
kernel `csrc/fused_step_legal.cu` on CUDA tensors and its plain PyTorch
version `step_legal_plain` on CPU tensors; the wrapper `legal_topk` runs
`csrc/legal_topk.cu` (no TPU original) or its plain version
`masked_topk_packed` the same way.

The packed words of a batch of R positions:

  * `place`  int32 [R, n2]: bits 0/1/2 = a flat / wall / capstone may be
    placed on the square;
  * `spread` int32 [R, 4, wp, n2]: bit b of word w of direction d = the
    drop pattern `w*32 + b` may be spread from the square in direction d
    (wp = ceil((2^n - 2) / 32)).

**The words are u32 bit patterns stored in int32** (PyTorch has no
shifts on uint32).  Bit 31 of a spread word is a live pattern at 6x6, so a
word may be negative: test a bit with `(word >> b) & 1` (the arithmetic
shift is masked by the `& 1`), never compare words by magnitude, and view
the JAX package's uint32 words as int32 to compare them.  The class tables
are int64 tensors carrying the u32 values, as the stack words are.

For a square the mover owns, the word (d, w) is
`KMASK[min(height, n)][w] & (SMASK[c][w] | (smash ? SMASHM[c][w] : 0))`:
c = the leading passable squares (top <= FLAT) along the ray, smash = the
first blocker is an on-board wall and the origin's top is a capstone.
The opening (ply < 2) places only flats, of the other colour's reserve.
The bits are those of `Engine.legal_mask`: `unpack_legal` of the words
equals it for every state.
"""

from __future__ import annotations

import numpy as np
import torch

from ..actions import pattern_mask_to_drops
from ..kernels import build as kb
from ..sizes import num_patterns
from ..types import CAP, FIELDS, FLAT, WALL, GameState
from ..utils.profiling import count
from . import fused_env

# the widest K the legal top-K kernel takes
LEGAL_TOPK_MAX_K = 128


def pattern_class_tables(n: int):
    """(wp, KMASK [n+1, wp], SMASK [n, wp], SMASHM [n, wp]) as uint32.

    KMASK[h]: patterns picking up <= h pieces.  SMASK[c]: patterns dropping
    over <= c squares.  SMASHM[c]: patterns with exactly c+1 drop squares
    and a last drop of 1 (a lone capstone flattening a wall at distance
    c+1)."""
    P = num_patterns(n)
    wp = -(-P // 32)
    drops = [pattern_mask_to_drops(p + 1, n) for p in range(P)]
    pat_k = np.array([sum(d) for d in drops])
    pat_s = np.array([len(d) for d in drops])
    pat_last = np.array([d[-1] for d in drops])

    def packed(sel):
        out = np.zeros(wp, np.uint32)
        for p in np.nonzero(sel)[0]:
            out[p // 32] |= np.uint32(1) << np.uint32(p % 32)
        return out

    kmask = np.stack([packed(pat_k <= h) for h in range(n + 1)])
    smask = np.stack([packed(pat_s <= c) for c in range(n)])
    smashm = np.stack([packed((pat_s == c + 1) & (pat_last == 1))
                       for c in range(n)])
    return wp, kmask, smask, smashm


def words_to_int32(x):
    """int64 u32 values -> the same bit patterns in int32."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def legal_bits_plain(engine, state: GameState):
    """(place [R, n2], spread [R, 4, wp, n2]) int32 words of `state`, in
    plain PyTorch."""
    n, n2 = engine.n, engine.num_squares
    t = engine.tensors(state.device)
    R = state.ply.shape[0]
    to_move = state.to_move.long()
    opening = state.ply < 2
    color_eff = torch.where(opening, 1 - to_move, to_move)
    empty = state.heights == 0
    have_stones = state.stones.gather(1, color_eff[:, None])[:, 0] > 0
    have_caps = state.caps.gather(1, to_move[:, None])[:, 0] > 0
    flat_ok = empty & have_stones[:, None]
    wall_ok = flat_ok & ~opening[:, None]
    cap_ok = empty & (have_caps & ~opening)[:, None]
    place = flat_ok.int() | (wall_ok.int() << 1) | (cap_ok.int() << 2)

    owner = fused_env.top_colors(state)
    own = ((state.heights > 0) & (owner == state.to_move[:, None])
           & ~opening[:, None])

    # tops along each ray; off-board squares read as a capstone (neither
    # passable nor a wall)
    cap_col = torch.full((R, 1), CAP, dtype=state.tops.dtype,
                         device=state.device)
    tops_pad = torch.cat([state.tops, cap_col], 1)
    path_tops = tops_pad[:, t["spread_path"].reshape(-1)].reshape(
        R, n2, 4, n - 1)
    passable = path_tops <= FLAT
    clear = torch.ones_like(passable[..., 0])      # all closer squares pass
    c = torch.zeros((R, n2, 4), dtype=torch.int64, device=state.device)
    wall_next = torch.zeros_like(clear)
    for j in range(n - 1):
        wall_next = wall_next | (clear & (path_tops[..., j] == WALL))
        clear = clear & passable[..., j]
        c = c + clear.long()
    smash_ok = wall_next & (state.tops == CAP)[:, :, None]

    km = t["kmask"][torch.clamp(state.heights.long(), max=n)]  # [R, n2, wp]
    sm = t["smask"][c]                                       # [R, n2, 4, wp]
    sh = torch.where(smash_ok[..., None], t["smashm"][c],
                     torch.zeros_like(sm))
    bits = km[:, :, None, :] & (sm | sh)
    bits = torch.where(own[:, :, None, None], bits, torch.zeros_like(bits))
    spread = words_to_int32(bits).permute(0, 2, 3, 1).contiguous()
    return place.to(torch.int32), spread


def _bit_tests(engine, place, spread):
    """(placement [R, 3, n2], spread [R, 4, P, n2]) bool: the packed words'
    bits in action order.  Pattern p reads bit p % 32 of word p // 32, so
    the pattern axis is one `index_select` of the word axis and an AND with
    a one-bit mask per pattern; nothing is padded to wp * 32."""
    t = engine.tensors(place.device)
    placement = (place[:, None, :] & t["place_bit"][None, :, None]) != 0
    words = spread.index_select(2, t["pattern_word"])
    return placement, (words & t["pattern_bit"][None, None, :, None]) != 0


def unpack_legal(engine, place, spread):
    """Dense [R, A] bool legal mask from the packed words."""
    R = place.shape[0]
    placement, spreads = _bit_tests(engine, place, spread)
    return torch.cat([placement.reshape(R, -1), spreads.reshape(R, -1)], 1)


def masked_topk_packed(engine, policy, place, spread, k: int):
    """(vals, action_ids) of the top-k LEGAL policy entries per row, read
    from the packed words: `top_k(where(legal, policy, -1), k)` with ties to
    the LOWER action id, as `jax.lax.top_k` and `mcts.search.masked_topk`'s
    "exact".  One int64 key per action (order-preserving float bits above
    the reversed id, as `masked_topk` builds it) is made from the policy
    alone; the words' bit tests then sink the illegal actions' keys below
    every float's, keeping the reversed id, so no [R, A] legal mask is
    assembled and the top-K's indices are the action ids.  Pad slots (fewer
    than k legal actions) return vals = -1 and the lowest illegal ids in
    ascending order: for a policy whose legal entries exceed -1 (a softmax)
    every slot equals the exact version's.  The plain version of
    `legal_topk`."""
    n2, P = engine.num_squares, engine.num_pat
    R, A = policy.shape
    if A >= 1 << 20:
        raise ValueError(f"action space {A} too wide for masked_topk_packed")
    policy = policy.float()
    fbits = policy.contiguous().view(torch.int32)
    key = torch.where(fbits >= 0, fbits, fbits ^ 0x7FFFFFFF).long()
    rev_idx = (1 << 20) - 1 - torch.arange(A, device=policy.device)
    key = (key << 20) | rev_idx
    sink = -(1 << 62) | rev_idx             # below every key of a float
    placement, spreads = _bit_tests(engine, place, spread)
    kp = key[:, :3 * n2].unflatten(1, (3, n2))
    kp.copy_(torch.where(placement, kp, sink[:3 * n2].view(3, n2)))
    ks = key[:, 3 * n2:].unflatten(1, (4, P, n2))
    ks.copy_(torch.where(spreads, ks, sink[3 * n2:].view(4, P, n2)))
    top, aidx = torch.topk(key, k, dim=-1)
    vals = torch.where(top > -(1 << 62) | ((1 << 20) - 1),
                       policy.gather(-1, aidx),
                       torch.full_like(top, -1.0, dtype=torch.float32))
    return vals, aidx.to(torch.int32)


def legal_topk(engine, policy, place, spread, k: int):
    """(policy [R, A], place [R, n2] int32, spread [R, 4, wp, n2] int32, k)
    -> (vals [R, k] float32, action_ids [R, k] int32): the top-k legal
    priors of each row from the packed words of `step_legal`, bitwise
    `masked_topk(policy, legal_mask, k, "exact")` for a softmax policy.
    CUDA tensors launch `csrc/legal_topk.cu` (sizes 3-8, 1 <= k <= 128)
    and count the rows under `search.legal_topk_rows`; CPU tensors run
    `masked_topk_packed`.  A policy that is not float32 is converted
    first."""
    if policy.device.type == "cpu":
        return masked_topk_packed(engine, policy, place, spread, k)
    n, n2, wp = engine.n, engine.num_squares, engine.pattern_words
    R, A = policy.shape
    if not 3 <= n <= 8:
        raise ValueError(f"legal_topk supports sizes 3-8, not {n}")
    if not 1 <= k <= min(LEGAL_TOPK_MAX_K, A):
        raise ValueError(f"legal_topk takes 1 <= k <= "
                         f"{min(LEGAL_TOPK_MAX_K, A)}, not {k}")
    if A != engine.num_actions:
        raise ValueError(f"policy has {A} actions, the {n}x{n} engine "
                         f"{engine.num_actions}")
    if (place.shape != (R, n2) or spread.shape != (R, 4, wp, n2)
            or place.dtype != torch.int32 or spread.dtype != torch.int32
            or place.device != policy.device
            or spread.device != policy.device):
        raise ValueError(
            f"legal_topk: words place {tuple(place.shape)} {place.dtype} and "
            f"spread {tuple(spread.shape)} {spread.dtype} on "
            f"{place.device}/{spread.device} do not fit {R} rows of "
            f"{n}x{n} on {policy.device}")
    policy = policy.float().contiguous()
    place, spread = place.contiguous(), spread.contiguous()
    vals = torch.empty((R, k), dtype=torch.float32, device=policy.device)
    ids = torch.empty((R, k), dtype=torch.int32, device=policy.device)
    if R == 0:
        return vals, ids
    count("search.legal_topk_rows", R)
    lib = kb.library("legal_topk")
    err = lib.tak_legal_topk(n, R, A, k, kb.ptr(policy), kb.ptr(place),
                             kb.ptr(spread), kb.ptr(vals), kb.ptr(ids),
                             kb.stream_ptr(policy.device))
    kb.check(err, "legal_topk")
    kb.LAUNCHES["legal_topk"] += 1
    return vals, ids


def step_legal_plain(engine, state: GameState, action, enabled=None):
    """Plain PyTorch version of `step_legal`: `step_plain`, then the packed
    legal bits of its result."""
    out = fused_env.step_plain(engine, state, action, enabled)
    return (out, *legal_bits_plain(engine, out))


def step_legal(engine, state: GameState, action, enabled=None):
    """(states [R], actions [R] int32, enabled [R] bool | None) ->
    (states, place [R, n2] int32, spread [R, 4, wp, n2] int32).

    The fused step plus the packed legal bits of the OUTPUT state, frozen
    rows and finished games included (callers gate terminal leaves).
    Consume with `legal_topk`, `masked_topk_packed` or `unpack_legal`.
    CUDA tensors launch the kernel, CPU tensors run `step_legal_plain`."""
    if state.device.type == "cpu":
        return step_legal_plain(engine, state, action, enabled)
    if not 3 <= engine.n <= 8:
        raise ValueError(f"step_legal supports sizes 3-8, not {engine.n}")
    R = action.shape[0]
    enabled = fused_env.check_step_args(engine, state, action, enabled,
                                        "step_legal")
    n2, wp = engine.num_squares, engine.pattern_words
    out = state.map(torch.empty_like)
    place = torch.empty((R, n2), dtype=torch.int32, device=state.device)
    spread = torch.empty((R, 4, wp, n2), dtype=torch.int32,
                         device=state.device)
    if R == 0:
        return out, place, spread
    lib = kb.library("fused_step_legal")
    args = [kb.ptr(getattr(state, f)) for f in FIELDS]
    args += [kb.ptr(getattr(out, f)) for f in FIELDS]
    err = lib.tak_fused_step_legal(
        engine.n, R, *args, kb.ptr(action), kb.ptr(enabled),
        kb.ptr(engine.tensors(state.device)["legal_tables"]), kb.ptr(place), kb.ptr(spread),
        kb.stream_ptr(state.device))
    kb.check(err, "fused_step_legal")
    kb.LAUNCHES["fused_step_legal"] += 1
    return out, place, spread
