"""Core state of the PyTorch Tak engine.

A `GameState` holds a batch of Tak positions as tensors with leading
batch axes (`[B, ...]`, or `[B, M, ...]` for the node tier of a search
tree).  The bit layout is the JAX package's (`tak_tpu/types.py`): bit h
of `stacks[..., sq, :]` (little-endian across the words) holds the color
of the piece at height h of square sq, and only the top piece's type is
stored in `tops`.

PyTorch has no shifts on uint32, so the stack words are int64 tensors
carrying the u32 values (always in [0, 2^32)).  Moving a state between
the two packages is a cast of that one field.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

# Piece codes in `tops`.
EMPTY, FLAT, WALL, CAP = 0, 1, 2, 3
WHITE, BLACK = 0, 1

# Result codes in `result`.
ONGOING = 0
WHITE_ROAD = 1
BLACK_ROAD = 2
WHITE_FLATS = 3
BLACK_FLATS = 4
DRAW_FLATS = 5
DRAW_REVERSIBLE = 6

FIELDS = ("stacks", "heights", "tops", "to_move", "ply", "stones", "caps",
          "half_komi", "reversible", "result")


def result_winner(result):
    """-1 = no winner; 0 = white; 1 = black (tensors or numpy arrays)."""
    if isinstance(result, torch.Tensor):
        is_white = (result == WHITE_ROAD) | (result == WHITE_FLATS)
        is_black = (result == BLACK_ROAD) | (result == BLACK_FLATS)
        minus = torch.full_like(result, -1)
        return torch.where(is_white, torch.zeros_like(result),
                           torch.where(is_black, torch.ones_like(result), minus))
    result = np.asarray(result)
    is_white = (result == WHITE_ROAD) | (result == WHITE_FLATS)
    is_black = (result == BLACK_ROAD) | (result == BLACK_FLATS)
    return np.where(is_white, 0, np.where(is_black, 1, -1))


@dataclass
class GameState:
    """Batched Tak positions (W = stack words, n2 = squares)."""

    stacks: torch.Tensor      # int64 [..., n2, W] u32 values, bit-packed colors
    heights: torch.Tensor     # int32 [..., n2]
    tops: torch.Tensor        # int32 [..., n2]  EMPTY/FLAT/WALL/CAP
    to_move: torch.Tensor     # int32 [...]  0=white 1=black
    ply: torch.Tensor         # int32 [...]
    stones: torch.Tensor      # int32 [..., 2] reserve flats/walls per color
    caps: torch.Tensor        # int32 [..., 2] reserve capstones per color
    half_komi: torch.Tensor   # int32 [...]
    reversible: torch.Tensor  # int32 [...] spread plies since last placement
    result: torch.Tensor      # int32 [...] result code (cached by step)

    def map(self, fn) -> "GameState":
        return GameState(*(fn(getattr(self, f)) for f in FIELDS))

    def replace(self, **kw) -> "GameState":
        return dataclasses.replace(self, **kw)

    def __getitem__(self, idx) -> "GameState":
        return self.map(lambda x: x[idx])

    def clone(self) -> "GameState":
        return self.map(torch.clone)

    @property
    def device(self) -> torch.device:
        return self.heights.device

    def to_numpy(self) -> dict:
        """Field name -> numpy array, stacks as uint32 (the JAX layout)."""
        out = {f: getattr(self, f).cpu().numpy() for f in FIELDS}
        out["stacks"] = out["stacks"].astype(np.uint32)
        return out

    @staticmethod
    def from_numpy(fields, device="cpu") -> "GameState":
        """From a mapping (or object with attributes) of numpy-like arrays in
        the JAX package's layout (uint32 stacks, int32 elsewhere)."""
        get = (fields.__getitem__ if isinstance(fields, dict)
               else lambda f: getattr(fields, f))
        vals = {}
        for f in FIELDS:
            a = np.array(get(f))
            dt = torch.int64 if f == "stacks" else torch.int32
            vals[f] = torch.as_tensor(a.astype(np.int64), device=device).to(dt)
        return GameState(**vals)


def cat_states(states) -> GameState:
    return GameState(*(torch.cat([getattr(s, f) for s in states])
                       for f in FIELDS))


def where_state(cond, a: GameState, b: GameState) -> GameState:
    """Per-batch-entry select: cond [...] picks a, else b."""
    def sel(x, y):
        c = cond.reshape(cond.shape + (1,) * (x.dim() - cond.dim()))
        return torch.where(c, x, y)

    return GameState(*(sel(getattr(a, f), getattr(b, f)) for f in FIELDS))
