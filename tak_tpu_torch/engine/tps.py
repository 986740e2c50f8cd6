"""TPS (Tak Positional System) codec for GameState (host-side).

Counterpart of `tak_tpu/engine/tps.py`, parity with `tak/src/tps.rs`:
rows are emitted top row first; each stack is its colors bottom-to-top as
digits (1=white, 2=black) with an 'S'/'C' suffix for a wall/cap top; runs
of empties compress to "xK"; the trailer is "<to_move> <move_number>" with
move_number = 1 + ply/2.  Importing a TPS reconstructs reserves by
subtracting on-board pieces from the size's default (tps.rs:62-95);
half-komi and the reversible counter are NOT part of TPS (they reset to
the provided/default values, as upstream).

A single position is a `GameState` with a leading batch axis of one.
"""

from __future__ import annotations

import numpy as np

from ..sizes import default_starting_stones, stack_words
from ..types import CAP, FLAT, WALL, GameState
from ..utils.device import resolve_device
from .core import Engine


def _stack_colors(words: np.ndarray, height: int) -> list[int]:
    """Colors bottom-to-top (0=white, 1=black) of one bit-packed stack."""
    return [int((int(words[h >> 5]) >> (h & 31)) & 1) for h in range(height)]


def host_fields(state: GameState) -> dict:
    """The numpy fields of a batch-of-one state, batch axis dropped, in
    the JAX package's layout (uint32 stacks)."""
    if state.ply.shape != (1,):
        raise ValueError("expected a single position (a batch of one), got "
                         f"batch shape {tuple(state.ply.shape)}")
    return {k: v[0] for k, v in state.to_numpy().items()}


def state_to_tps(engine: Engine, state: GameState) -> str:
    return host_to_tps(engine, host_fields(state))


def host_to_tps(engine: Engine, host: dict) -> str:
    """TPS of one position given as numpy fields without a batch axis (the
    layout of `host_fields` and `tps_to_host`)."""
    n = engine.n
    heights = np.asarray(host["heights"]).reshape(n, n)
    tops = np.asarray(host["tops"]).reshape(n, n)
    stacks = np.asarray(host["stacks"]).reshape(n, n, -1)

    rows = []
    for r in range(n - 1, -1, -1):
        cells = []
        for c in range(n):
            h = int(heights[r, c])
            if h == 0:
                if cells and cells[-1][0] == "x":
                    prev = cells.pop()
                    count = int(prev[1:]) if len(prev) > 1 else 1
                    cells.append(f"x{count + 1}")
                else:
                    cells.append("x")
            else:
                colors = _stack_colors(stacks[r, c], h)
                cell = "".join("2" if col else "1" for col in colors)
                top = int(tops[r, c])
                cell += {FLAT: "", WALL: "S", CAP: "C"}[top]
                cells.append(cell)
        rows.append(",".join(cells))
    to_move = 2 if int(host["to_move"]) else 1
    move_number = 1 + int(host["ply"]) // 2
    return f"{'/'.join(rows)} {to_move} {move_number}"


def tps_to_host(engine: Engine, tps: str, half_komi: int = 0) -> dict:
    """Parse TPS into a dict of HOST numpy arrays (GameState fields of one
    position, no batch axis, uint32 stacks)."""
    n = engine.n
    W = stack_words(n)
    parts = tps.strip().split()
    if len(parts) != 3:
        raise ValueError(f"malformed TPS {tps!r}")
    board_s, to_move_s, move_s = parts
    to_move = int(to_move_s) - 1
    ply = 2 * (int(move_s) - 1) + (1 if to_move == 1 else 0)

    heights = np.zeros((n, n), np.int32)
    tops = np.zeros((n, n), np.int32)
    stacks = np.zeros((n, n, W), np.uint32)
    piece_count = [0, 0]
    cap_count = [0, 0]

    rows = board_s.split("/")
    if len(rows) != n:
        raise ValueError(f"TPS has {len(rows)} rows, expected {n}")
    for ri, row in enumerate(rows):
        r = n - 1 - ri  # TPS lists the top row first
        c = 0
        for cell in row.split(","):
            if cell.startswith("x"):
                c += int(cell[1:]) if len(cell) > 1 else 1
                continue
            top = FLAT
            if cell.endswith("S"):
                top, cell = WALL, cell[:-1]
            elif cell.endswith("C"):
                top, cell = CAP, cell[:-1]
            colors = [int(ch) - 1 for ch in cell]
            for h, col in enumerate(colors):
                stacks[r, c, h >> 5] |= np.uint32(col) << np.uint32(h & 31)
                piece_count[col] += 1
            heights[r, c] = len(colors)
            tops[r, c] = top
            if top == CAP:
                cap_count[colors[-1]] += 1
            c += 1
        if c != n:
            raise ValueError(f"TPS row {row!r} has wrong width")

    d_stones, d_caps = default_starting_stones(n)
    stones = [d_stones - (piece_count[i] - cap_count[i]) for i in (0, 1)]
    caps = [d_caps - cap_count[i] for i in (0, 1)]

    return {
        "stacks": stacks.reshape(n * n, W),
        "heights": heights.reshape(-1),
        "tops": tops.reshape(-1),
        "to_move": np.int32(to_move),
        "ply": np.int32(ply),
        "stones": np.asarray(stones, np.int32),
        "caps": np.asarray(caps, np.int32),
        "half_komi": np.int32(half_komi),
        "reversible": np.int32(0),
        "result": np.int32(0),
    }


def tps_to_state(engine: Engine, tps: str, half_komi: int = 0,
                 device=None) -> GameState:
    """One position as a batch of one on `device` (default: the card)."""
    host = tps_to_host(engine, tps, half_komi)
    return GameState.from_numpy({k: np.asarray(v)[None]
                                 for k, v in host.items()},
                                resolve_device(device))
