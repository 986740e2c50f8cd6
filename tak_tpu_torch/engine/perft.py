"""Breadth-first perft (move-tree leaf count) on the batched engine.

Same semantics as the reference's recursive `perf_count`
(tak/tests/perft.rs:3-18): a node contributes 1 if depth == 0 or the game
is over, otherwise the sum over its legal moves.  Each depth level is one
batched `legal_mask` + `step` over the whole frontier.
"""

from __future__ import annotations

import torch

from ..types import ONGOING, GameState, cat_states
from .core import Engine

_CHUNK = 1 << 16


def perft(engine: Engine, state: GameState, depth: int) -> int:
    """Leaf count of the move tree to `depth` from a batch-of-one state."""
    if depth == 0:
        return 1
    frontier = state
    total = 0
    for level in range(depth):
        finished = frontier.result != ONGOING
        total += int(finished.sum())
        live = torch.nonzero(~finished).flatten()
        if live.numel() == 0:
            return total
        frontier = frontier[live]
        masks = engine.legal_mask(frontier)
        if level == depth - 1:
            return total + int(masks.sum())
        b_idx, a_idx = torch.nonzero(masks, as_tuple=True)
        children = []
        for lo in range(0, b_idx.numel(), _CHUNK):
            sl = slice(lo, lo + _CHUNK)
            children.append(engine.step(frontier[b_idx[sl]], a_idx[sl]))
        frontier = cat_states(children)
    return total
