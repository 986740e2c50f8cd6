"""Fused env step: one kernel for step + result, with the freeze.

Replaces `tak_tpu/engine/pallas_env.py:704` `build_fused_step`
(`_step_core`, `_roads`, `_compute_result` and the done/disabled freeze).
The wrapper `fused_step` runs the CUDA kernel `csrc/fused_step.cu` on a
CUDA tensor and its plain PyTorch version `step_plain` on a CPU tensor.

The kernel takes the `GameState` fields in their batch-first layout (no
packing into a kernel layout and back) and runs one warp per row, a
square per lane (`csrc/env_warp.cuh`).  What bounds it on the H100:
bytes.  A 6x6 row reads 36*2 int64 stack words and 2*36 int32
heights/tops (about 0.9 KB) and writes as much, for a few hundred integer
operations, far under the card's operations per byte; the road flood fill
runs on 64-bit bitboards made by warp ballots.  The design keeps the
whole step, the result and the freeze in one pass over the row so each
byte moves once; a warp's loads of its row are coalesced, and rows are
independent, so 8,192 rows and the 289,152-row instant-win scan fill the
card.
"""

from __future__ import annotations

import torch

from ..kernels import build as kb
from ..types import (
    BLACK_FLATS,
    BLACK_ROAD,
    CAP,
    DRAW_FLATS,
    DRAW_REVERSIBLE,
    EMPTY,
    FIELDS,
    FLAT,
    ONGOING,
    WHITE_FLATS,
    WHITE_ROAD,
    GameState,
    where_state,
)
from ..sizes import REVERSIBLE_PLIES

MASK32 = 0xFFFFFFFF


def _srl(x, k: int):
    """Logical right shift of int64 bitboards (bit 63 may be set at 8x8)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _i64(v: int) -> int:
    """A 64-bit pattern as a signed int64 constant."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def trunc_div2(x):
    """Truncated (toward zero) division by 2, matching Rust's i8 `/`."""
    return torch.where(x >= 0, x // 2, -((-x) // 2))


def top_colors(state: GameState):
    """Color of the top piece per square (garbage where empty)."""
    h1 = torch.clamp(state.heights - 1, min=0).long()
    w = torch.gather(state.stacks, -1, (h1 >> 5).unsqueeze(-1)).squeeze(-1)
    return ((w >> (h1 & 31)) & 1).to(torch.int32)


def flat_diff(state: GameState):
    """White flat tops minus black flat tops."""
    owner = top_colors(state)
    return torch.where(state.tops == FLAT, 1 - 2 * owner,
                       torch.zeros_like(owner)).sum(-1)


def roads(engine, state: GameState):
    """(white_road, black_road) bool [...]: edge-to-edge roads of flats and
    caps, as a flood fill on int64 bitboards (bit q = square q)."""
    n, n2 = engine.n, engine.num_squares
    owner = top_colors(state)
    roady = (state.heights > 0) & ((state.tops == FLAT) | (state.tops == CAP))
    pw = torch.tensor([_i64(1 << q) for q in range(n2)], dtype=torch.int64,
                      device=state.heights.device)

    def pack(m):
        return torch.where(m, pw, torch.zeros_like(pw)).sum(-1)

    own_w = pack(roady & (owner == 0))
    own_b = pack(roady & (owner == 1))
    full = (1 << n2) - 1
    col0 = sum(1 << q for q in range(0, n2, n))
    colL = col0 << (n - 1)
    bottom = (1 << n) - 1
    top = bottom << (n2 - n)
    nc0, ncl = _i64(full & ~col0), _i64(full & ~colL)
    # planes: white from bottom, white from left, black ..., black ...
    own = torch.stack([own_w, own_w, own_b, own_b], -1)
    seed = torch.tensor([_i64(bottom), _i64(col0)] * 2, dtype=torch.int64,
                        device=own.device)
    target = torch.tensor([_i64(top), _i64(colL)] * 2, dtype=torch.int64,
                          device=own.device)
    lab = own & seed
    for _ in range(n2):
        lab = (lab | ((lab << 1) & nc0) | (_srl(lab, 1) & ncl)
               | (lab << n) | _srl(lab, n)) & own
    hit = (lab & target) != 0
    return hit[..., 0] | hit[..., 1], hit[..., 2] | hit[..., 3]


def compute_result(engine, state: GameState):
    """Result code [...] int32 (game.rs:220-263 semantics)."""
    to_move = state.to_move
    just_moved = 1 - to_move
    white, black = roads(engine, state)
    road_jm = torch.where(just_moved == 0, white, black)
    road_om = torch.where(just_moved == 0, black, white)
    c = lambda v: torch.full_like(to_move, v)
    road_code = torch.where(
        road_jm, torch.where(just_moved == 0, c(WHITE_ROAD), c(BLACK_ROAD)),
        torch.where(road_om,
                    torch.where(to_move == 0, c(WHITE_ROAD), c(BLACK_ROAD)),
                    c(ONGOING)))
    out_of_reserves = ((state.stones == 0) & (state.caps == 0)).any(-1)
    board_full = (state.heights > 0).all(-1)
    diff = flat_diff(state) - trunc_div2(state.half_komi)
    flat_code = torch.where(
        diff > 0, c(WHITE_FLATS),
        torch.where(diff < 0, c(BLACK_FLATS),
                    torch.where(state.half_komi % 2 != 0, c(BLACK_FLATS),
                                c(DRAW_FLATS))))
    rev_draw = state.reversible >= REVERSIBLE_PLIES
    return torch.where(
        road_code != ONGOING, road_code,
        torch.where(out_of_reserves | board_full, flat_code,
                    torch.where(rev_draw, c(DRAW_REVERSIBLE), c(ONGOING)))
    ).to(torch.int32)


def step_plain(engine, state: GameState, action, enabled=None) -> GameState:
    """Plain PyTorch version of the fused step: rows [R], actions [R]."""
    n, n2, P, W = engine.n, engine.num_squares, engine.num_pat, engine.words
    t = engine.tensors(state.device)
    R = action.shape[0]
    dev = state.device
    rows = torch.arange(R, device=dev)
    a = action.long()
    ch, sq = a // n2, a % n2
    is_place = ch < 3
    q = torch.arange(n2, device=dev)
    is_origin = q[None, :] == sq[:, None]                      # [R, n2]

    to_move = state.to_move.long()
    opening = state.ply < 2
    color_eff = torch.where(opening, 1 - to_move, to_move)
    heights = state.heights.long()
    tops = state.tops.long()
    orig_top = tops[rows, sq]
    h = heights[rows, sq]

    dp = torch.clamp(ch - 3, min=0)
    d, p = dp // P, dp % P
    k = torch.where(is_place, torch.zeros_like(p), t["pat_k"][p])
    s = t["pat_s"][p]
    lo = h - k
    lo0 = torch.clamp(lo, min=0)

    # carry window: k bits at height lo from the origin's words
    words_sq = state.stacks[rows, sq]                          # [R, W]
    zero_w = torch.zeros((R, 1), dtype=torch.int64, device=dev)
    padded = torch.cat([words_sq, zero_w, zero_w], 1)
    j = lo0 >> 5
    off = lo0 & 31
    w0c = padded[rows, j]
    w1c = padded[rows, j + 1]
    hi = torch.where(off == 0, torch.zeros_like(w1c),
                     (w1c << torch.clamp(32 - off, max=31)) & MASK32)
    carry = ((w0c >> off) | hi) & ((1 << k) - 1)

    # per-square drops along the ray
    dist = t["path_dist"][sq, d]                               # [R, n2]
    on_ray = (~is_place)[:, None] & (dist >= 1) & (dist <= s[:, None])
    jq = torch.clamp(dist - 1, min=0)
    drops = torch.where(on_ray, t["pat_drops"][p[:, None], jq],
                        torch.zeros_like(dist))
    cum = t["pat_cum"][p[:, None], jq]
    bits = (carry[:, None] >> cum) & ((1 << drops) - 1)

    place_bits = torch.where(is_place, color_eff, torch.zeros_like(color_eff))
    ins_bits = torch.where(is_origin, place_bits[:, None], bits)
    ins_count = torch.where(is_place[:, None], is_origin.long(), drops)

    # insert ins_bits at each square's current height (two-word window)
    jw = heights >> 5
    offi = heights & 31
    w0 = (ins_bits << offi) & MASK32
    w1 = torch.where(offi == 0, torch.zeros_like(ins_bits),
                     ins_bits >> torch.clamp(32 - offi, max=31))
    word_ids = torch.arange(W, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    add = (torch.where(word_ids == jw[..., None], w0[..., None], zero)
           | torch.where(word_ids == jw[..., None] + 1, w1[..., None], zero))

    # clear the carried window at the spread origin
    cj = lo0 >> 5
    coff = lo0 & 31
    cmask = (1 << k) - 1
    cm0 = (cmask << coff) & MASK32
    cm1 = torch.where(coff == 0, torch.zeros_like(cmask),
                      cmask >> torch.clamp(32 - coff, max=31))
    clear = (torch.where(word_ids == cj[:, None], cm0[:, None], zero)
             | torch.where(word_ids == cj[:, None] + 1, cm1[:, None], zero))
    clear = torch.where(((~is_place)[:, None] & is_origin)[..., None],
                        clear[:, None, :], zero)
    new_stacks = (state.stacks & (~clear & MASK32)) | add

    new_heights = torch.where(
        is_origin, torch.where(is_place, torch.ones_like(lo), lo)[:, None],
        heights + ins_count)
    spread_top = torch.where(dist == s[:, None], orig_top[:, None],
                             torch.full_like(dist, FLAT))
    origin_top = torch.where(
        is_place, ch + 1,
        torch.where(lo > 0, torch.full_like(lo, FLAT),
                    torch.full_like(lo, EMPTY)))
    new_tops = torch.where(is_origin, origin_top[:, None],
                           torch.where(on_ray, spread_top, tops))

    is_cap_place = is_place & (ch + 1 == CAP)
    two = torch.arange(2, device=dev)
    new_stones = state.stones - ((two[None, :] == color_eff[:, None])
                                 & (is_place & ~is_cap_place)[:, None]).int()
    new_caps = state.caps - ((two[None, :] == to_move[:, None])
                             & is_cap_place[:, None]).int()
    i32 = torch.int32
    new = GameState(
        stacks=new_stacks,
        heights=new_heights.to(i32),
        tops=new_tops.to(i32),
        to_move=(1 - state.to_move).to(i32),
        ply=(state.ply + 1).to(i32),
        stones=new_stones.to(i32),
        caps=new_caps.to(i32),
        half_komi=state.half_komi,
        reversible=torch.where(is_place, torch.zeros_like(state.reversible),
                               state.reversible + 1).to(i32),
        result=state.result,
    )
    new = new.replace(result=compute_result(engine, new))
    done = state.result != ONGOING
    if enabled is not None:
        done = done | ~enabled
    return where_state(done, state, new)


def check_state(engine, state: GameState, R: int, what: str = "fused_step"):
    n2, W = engine.num_squares, engine.words
    shapes = {"stacks": (R, n2, W), "heights": (R, n2), "tops": (R, n2),
              "stones": (R, 2), "caps": (R, 2)}
    for f in FIELDS:
        x = getattr(state, f)
        want_shape = shapes.get(f, (R,))
        want_dtype = torch.int64 if f == "stacks" else torch.int32
        if tuple(x.shape) != want_shape or x.dtype != want_dtype:
            raise ValueError(f"{what}: field {f} is {x.dtype} "
                             f"{tuple(x.shape)}, want {want_dtype} {want_shape}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: field {f} is not contiguous")
        if x.device != state.device:
            raise ValueError(f"{what}: field {f} on {x.device}")


def check_step_args(engine, state: GameState, action, enabled, what: str):
    """Raise on what the step kernels do not take; returns `enabled` (all
    rows when None)."""
    R = action.shape[0]
    check_state(engine, state, R, what)
    if enabled is None:
        enabled = torch.ones(R, dtype=torch.bool, device=state.device)
    for name, x, dt in (("action", action, torch.int32),
                        ("enabled", enabled, torch.bool)):
        if (x.dtype != dt or tuple(x.shape) != (R,) or not x.is_contiguous()
                or x.device != state.device):
            raise ValueError(f"{what}: {name} must be a contiguous {dt} "
                             f"[{R}] tensor on {state.device}")
    return enabled


def fused_step(engine, state: GameState, action, enabled=None) -> GameState:
    """(states [R], actions [R] int32, enabled [R] bool | None) -> states.

    Step + result in one pass; finished (and disabled) rows come back
    unchanged.  CUDA tensors launch the kernel, CPU tensors run
    `step_plain`."""
    if state.device.type == "cpu":
        return step_plain(engine, state, action, enabled)
    if not 3 <= engine.n <= 8:
        raise ValueError(f"fused_step supports sizes 3-8, not {engine.n}")
    R = action.shape[0]
    enabled = check_step_args(engine, state, action, enabled, "fused_step")
    out = state.map(torch.empty_like)
    if R == 0:
        return out
    lib = kb.library("fused_step")
    args = [kb.ptr(getattr(state, f)) for f in FIELDS]
    args += [kb.ptr(getattr(out, f)) for f in FIELDS]
    err = lib.tak_fused_step(engine.n, R, *args, kb.ptr(action),
                             kb.ptr(enabled), kb.stream_ptr(state.device))
    kb.check(err, "fused_step")
    kb.LAUNCHES["fused_step"] += 1
    return out
