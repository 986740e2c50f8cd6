"""Per-board-size static constants for Tak.

Reference parity: reserve table matches `tak/src/game.rs:10-20`
(default_starting_stones); action-space/channel arithmetic matches
`alpha-tak/src/repr/moves.rs:20-31` and
`alpha-tak/src/search/move_map.rs:15-17`; input-plane arithmetic matches
`alpha-tak/src/repr/board.rs:4-8` and `alpha-tak/src/repr/game.rs:12-15`.

Everything here is a Python-level (static) constant: board size N is a
jit-specialization axis, never a traced value.
"""

from __future__ import annotations

from functools import lru_cache

# Reversible-ply draw threshold (tak/src/game.rs:22).
REVERSIBLE_PLIES = 50

# Extra stack depth (below the carry limit) encoded in the NN input planes
# (alpha-tak/src/repr/board.rs:4).
STACK_DEPTH_BEYOND_CARRY = 6

_STARTING_STONES = {
    3: (10, 0),
    4: (15, 0),
    5: (21, 1),
    6: (30, 1),
    7: (40, 2),
    8: (50, 2),
}


def default_starting_stones(n: int) -> tuple[int, int]:
    """(stones, capstones) per player for board size n (game.rs:10-20)."""
    return _STARTING_STONES[n]


def max_stack_height(n: int) -> int:
    """Upper bound on a single stack's height: every piece in the game."""
    stones, caps = default_starting_stones(n)
    return 2 * (stones + caps)


def stack_words(n: int) -> int:
    """Number of u32 words needed to bit-pack one stack's colors."""
    return (max_stack_height(n) + 31) // 32


def num_patterns(n: int) -> int:
    """Spread drop-patterns per (square, direction): 2^n - 2.

    All non-empty compositions (d_1..d_s), sum <= n, minus the single
    geometrically impossible one (1 repeated n times needs n distinct
    target squares but at most n-1 exist).  move_map.rs:15-17.
    """
    return 2**n - 2


def move_channels(n: int) -> int:
    """Action channels: 3 placement types + 4 directions x patterns."""
    return 3 + 4 * num_patterns(n)


def action_space(n: int) -> int:
    """Total flat action count (channel scheme), moves.rs:29-31."""
    return n * n * move_channels(n)


def legacy_action_space(n: int) -> int:
    """Size of the legacy one-hot move list (moves.rs:6-16).

    5x5 -> 1575: used by the reference's Net5 dense policy head.
    """
    return {3: 126, 4: 480, 5: 1575, 6: 4572, 7: 12495, 8: 32704}[n]


def board_channels(n: int) -> int:
    """Input planes encoding the board: 6 top planes + 2*(n+5) sub-top."""
    return (n + 2 + STACK_DEPTH_BEYOND_CARRY) * 2


def input_channels(n: int) -> int:
    """Total NN input planes (repr/game.rs:12-15): 72 for 5x5, 92 for 6x6."""
    stones, caps = default_starting_stones(n)
    return board_channels(n) + 1 + 1 + 2 * stones + 2 * caps


@lru_cache(maxsize=None)
def validate(n: int) -> int:
    if n not in _STARTING_STONES:
        raise ValueError(f"unsupported board size {n}")
    return n
