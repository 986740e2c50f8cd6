"""Move-rejection diagnosis: the reference's PlayError taxonomy.

Counterpart of `tak_tpu/errors.py`.  `tak/src/error.rs` distinguishes
ten rejection reasons (plus stack/take
sub-errors).  The vectorized engine only produces a legality *mask*; this
module recovers the precise reason for a rejected move on the host so
interactive surfaces (REPL, TEI, playtak) can say *why*, like upstream.
"""

from __future__ import annotations

from enum import Enum

from .actions import Move
from .engine.tps import host_fields
from .types import CAP, WALL


class PlayError(Enum):
    OUT_OF_BOUNDS = "given square is not on the board"
    ALREADY_OCCUPIED = "cannot place a piece there: the square is occupied"
    NO_CAPSTONE = "no capstone left to play"
    NO_STONES = "no stones left to play"
    OPENING_NON_FLAT = "only flat placements are allowed on the first two plies"
    EMPTY_SQUARE = "cannot move from an empty square"
    STACK_NOT_OWNED = "cannot move a stack you do not own"
    WALL_IN_WAY = "only a lone capstone can flatten a standing stone"
    CAP_IN_WAY = "cannot stack on top of a capstone"
    TAKE_ZERO = "cannot take zero pieces"
    CARRY_LIMIT = "cannot carry more pieces than the board size"
    STACK_SIZE = "cannot take more pieces than the stack holds"
    SPREAD_OUT_OF_BOUNDS = "spread would leave the board"


def diagnose(game, move: Move) -> PlayError | None:
    """Why `move` is illegal in `game` (None if it is legal).

    Mirrors the validation order of `Game::play` (game.rs:147-209).
    """
    n = game.n
    state = host_fields(game.state)
    heights = state["heights"]
    tops = state["tops"]
    stones = state["stones"]
    caps = state["caps"]
    ply = int(state["ply"])
    to_move = int(state["to_move"])
    opening = ply < 2

    if not (0 <= move.row < n and 0 <= move.col < n):
        return PlayError.OUT_OF_BOUNDS
    sq = move.row * n + move.col

    if not move.is_spread:
        if heights[sq] > 0:
            return PlayError.ALREADY_OCCUPIED
        if move.piece == CAP:
            if opening:
                return PlayError.OPENING_NON_FLAT
            if caps[to_move] == 0:
                return PlayError.NO_CAPSTONE
            return None
        color_eff = 1 - to_move if opening else to_move
        if stones[color_eff] == 0:
            return PlayError.NO_STONES
        if opening and move.piece == WALL:
            return PlayError.OPENING_NON_FLAT
        return None

    # spreads
    if heights[sq] == 0:
        return PlayError.EMPTY_SQUARE
    stacks = state["stacks"]
    h = int(heights[sq])
    top_color = (int(stacks[sq, (h - 1) // 32]) >> ((h - 1) % 32)) & 1
    mover_color = 1 - to_move if opening else to_move
    if top_color != mover_color:
        return PlayError.STACK_NOT_OWNED
    k = move.count
    if k == 0:
        return PlayError.TAKE_ZERO
    if k > n:
        return PlayError.CARRY_LIMIT
    if k > h:
        return PlayError.STACK_SIZE

    from .actions import DIR_VECS

    dr, dc = DIR_VECS[move.direction]
    r, c = move.row, move.col
    cap_top = tops[sq] == CAP
    for j, drop in enumerate(move.drops):
        r, c = r + dr, c + dc
        if not (0 <= r < n and 0 <= c < n):
            return PlayError.SPREAD_OUT_OF_BOUNDS
        t = tops[r * n + c]
        if t == CAP:
            return PlayError.CAP_IN_WAY
        if t == WALL:
            last = j == len(move.drops) - 1
            if not (last and cap_top and drop == 1):
                return PlayError.WALL_IN_WAY
    return None
