"""PTN game-file parsing (host-side).

Counterpart of `tak_tpu/engine/ptn.py` (`analysis/src/parse.rs`): extracts
`[Key "Value"]` headers (Komi, Flats, Caps, Size, TPS), strips comments,
splits plies on move numbers / results / `--` placeholders, and parses
each move with the PTN move grammar from `tak_tpu_torch.actions`.
"""

from __future__ import annotations

import re

import torch

from ..actions import parse_move
from ..sizes import default_starting_stones
from .core import Engine
from .tps import tps_to_state

_OPTIONS_RE = re.compile(r"\[(\S+) [\"'](.*?)[\"']\]")
_COMMENTS_RE = re.compile(r"\{.*?\}")
_PLY_SPLIT_RE = re.compile(
    r"\s*\d+\. |\s+|1-0|R-0|F-0|0-1|0-R|0-F|1/2-1/2|--"
)


def _pair(a: int, b: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([[a, b]], dtype=like.dtype, device=like.device)


def parse_ptn(engine: Engine, text: str, device=None):
    """-> (initial GameState (a batch of one), [Move]).  Raises on size
    mismatch."""
    n = engine.n
    komi = 0
    stones, caps = default_starting_stones(n)
    state = None
    for key, value in _OPTIONS_RE.findall(text):
        if key == "Komi":
            komi = int(float(value))
        elif key == "Flats":
            stones = int(value)
        elif key == "Caps":
            caps = int(value)
        elif key == "Size":
            if int(value) != n:
                raise ValueError(
                    f"game size mismatch, expected size {n} and found {value}"
                )
        elif key == "TPS":
            state = tps_to_state(engine, value, device=device)

    if state is None:
        state = engine.initial(device=device)
        state = state.replace(
            stones=_pair(stones, stones, state.stones),
            caps=_pair(caps, caps, state.caps),
        )
    state = state.replace(half_komi=torch.full_like(state.half_komi, 2 * komi))

    body = _OPTIONS_RE.sub("", text)
    body = _COMMENTS_RE.sub("", body)
    moves = [
        parse_move(tok.rstrip("?!'*"))  # strip annotation marks (e.g. d3<?)
        for tok in _PLY_SPLIT_RE.split(body)
        if tok
    ]
    return state, moves


def parse_position(engine: Engine, s: str, device=None):
    """Parse "TPS;ws;wc;bs;bc;half_komi" (analysis/src/parse.rs:62-77)."""
    parts = s.split(";")
    state = tps_to_state(engine, parts[0], device=device)
    if len(parts) > 1:
        ws, wc, bs, bc, hk = (int(p) for p in parts[1:6])
        return state.replace(
            stones=_pair(ws, bs, state.stones),
            caps=_pair(wc, bc, state.caps),
            half_komi=torch.full_like(state.half_komi, hk),
        )
    return state.replace(half_komi=torch.full_like(state.half_komi, 4))  # assume komi 2
