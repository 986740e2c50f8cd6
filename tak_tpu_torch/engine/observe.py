"""Network input planes from a batched GameState.

Same planes and channel order as `tak_tpu/engine/observe.py`, all from
the side-to-move perspective (alpha-tak/src/repr/):

  ch 0..5                : top piece (flat/wall/cap) x (mine/theirs)
  ch 6..6+2*(n+5)        : stack colors below the top, (mine/theirs) pairs
  next 2*stones planes   : one-hot of my/their stone reserve counts
  next 2*caps planes     : one-hot of my/their cap reserve counts
  next 1                 : 1.0 iff white to move
  next 1                 : (flat_diff - komi) / n^2

The public layout stays NHWC `[B, n, n, C]`, as in the JAX package; the
network permutes to NCHW inside.
"""

from __future__ import annotations

import torch

from ..sizes import STACK_DEPTH_BEYOND_CARRY
from ..types import GameState
from .fused_env import flat_diff, top_colors, trunc_div2


def observe(engine, state: GameState) -> torch.Tensor:
    """Input planes float32 [B, n, n, input_channels(n)]."""
    n, n2, W = engine.n, engine.num_squares, engine.words
    dev = state.device
    B = state.ply.shape[0]
    to_move = state.to_move
    heights = state.heights
    owner = top_colors(state)
    mine = owner == to_move[:, None]

    occupied = heights > 0
    ch = 2 * (state.tops - 1) + (~mine).to(torch.int32)
    ch = torch.where(occupied, ch, torch.full_like(ch, -1))
    top_planes = (ch[..., None] == torch.arange(6, device=dev)).float()

    depth = n + STACK_DEPTH_BEYOND_CARRY - 1
    pos = heights[..., None] - 2 - torch.arange(depth, device=dev)
    present = pos >= 0
    p = torch.clamp(pos, min=0).long()
    j = torch.clamp(p >> 5, max=W - 1)
    word = torch.gather(state.stacks, -1, j)                  # [B, n2, depth]
    color = (word >> (p & 31)) & 1
    layer_mine = present & (color == to_move[:, None, None])
    sub = torch.stack([layer_mine, present & ~layer_mine], -1).reshape(
        B, n2, 2 * depth).float()
    board = torch.cat([top_planes, sub], -1).reshape(B, n, n, 6 + 2 * depth)

    def onehot(count, size):
        hot = torch.arange(size, device=dev)[None, :] == (count - 1)[:, None]
        return (hot & (count > 0)[:, None]).float()

    my = to_move.long()[:, None]
    en = 1 - my
    reserve_vec = torch.cat([
        onehot(state.stones.gather(1, my)[:, 0], engine.start_stones),
        onehot(state.stones.gather(1, en)[:, 0], engine.start_stones),
        onehot(state.caps.gather(1, my)[:, 0], engine.start_caps),
        onehot(state.caps.gather(1, en)[:, 0], engine.start_caps),
    ], 1)
    reserves = reserve_vec[:, None, None, :].expand(B, n, n, -1)
    colour = (to_move == 0).float()[:, None, None, None].expand(B, n, n, 1)
    fcd = flat_diff(state) - trunc_div2(state.half_komi)
    fcd_plane = (fcd.float() / n2)[:, None, None, None].expand(B, n, n, 1)
    return torch.cat([board, reserves, colour, fcd_plane], -1)
