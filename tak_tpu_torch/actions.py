"""Tak action space: flat channel-scheme encoding + host-side move codec.

The framework uses one flat action id per move, for every board size:

    action = channel * n^2 + row * n + col
    channel 0..2   : place flat / wall / cap
    channel 3 + d*P + p : spread in direction d with drop-pattern p
    d in {0:Up(+), 1:Right(>), 2:Down(-), 3:Left(<)},  P = 2^n - 2

This reproduces the reference's channel scheme
(`alpha-tak/src/search/move_map.rs:19-47`, `alpha-tak/src/repr/moves.rs:20-31`).

A drop-pattern for a spread picking up k pieces and dropping (d_1..d_s) over
s successive squares is encoded as an n-bit mask: write, for each drop d_i,
(d_i - 1) zeros followed by a one (MSB first, k bits total, always ending in
a one), then left-align to n bits.  The number of trailing zeros recovers k,
the set bits recover the drop boundaries.  Pattern channel p = mask - 1;
the all-ones mask (n single drops, needs n target squares) is geometrically
impossible and excluded, giving 2^n - 2 patterns.  This matches takparse's
`Pattern::mask()` arithmetic used at move_map.rs:35.

Also here: the legacy one-hot move list (1575 moves for 5x5) used by the
reference's Net5 dense policy head (move_map.rs:51-201, generated
programmatically instead of hardcoded), the canonical `possible_moves`
enumeration order (tak/src/move_gen.rs) used for seeded-playout parity, and
the D4 symmetry permutations of the action space (tak/src/symm.rs).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from functools import cached_property, lru_cache

import numpy as np

from .sizes import (
    action_space,
    default_starting_stones,
    legacy_action_space,
    num_patterns,
    validate,
)

# Piece codes used across the framework (0 is "empty" in board tops).
EMPTY, FLAT, WALL, CAP = 0, 1, 2, 3
WHITE, BLACK = 0, 1

# Direction channel order (move_map.rs:37-42): Up, Right, Down, Left.
DIR_VECS = ((1, 0), (0, 1), (-1, 0), (0, -1))  # (drow, dcol)
DIR_CHARS = "+>-<"
# Enumeration order of directions inside possible_moves (move_gen.rs:66):
# Up, Down, Left, Right -> as direction-channel indices:
ENUM_DIR_ORDER = (0, 2, 3, 1)


def pattern_mask_to_drops(mask: int, n: int) -> tuple[int, ...]:
    """Decode an n-bit pattern mask into its drop counts."""
    assert 0 < mask < (1 << n) - 1 or mask == (1 << n) - 1
    tz = (mask & -mask).bit_length() - 1
    k = n - tz
    kbits = mask >> tz  # k bits, MSB-first composition encoding
    drops = []
    prev = -1
    for i in range(k):
        if (kbits >> (k - 1 - i)) & 1:
            drops.append(i - prev)
            prev = i
    return tuple(drops)


def drops_to_pattern_mask(drops: tuple[int, ...], n: int) -> int:
    """Encode drop counts as an n-bit left-aligned pattern mask."""
    k = sum(drops)
    assert 1 <= k <= n
    kbits = 0
    pos = -1
    for d in drops:
        pos += d
        kbits |= 1 << (k - 1 - pos)
    return kbits << (n - k)


@dataclass(frozen=True)
class Move:
    """A host-side Tak move. row/col are 0-indexed; 'a1' = (row 0, col 0)."""

    row: int
    col: int
    piece: int = FLAT          # for placements: FLAT / WALL / CAP
    direction: int | None = None  # None = placement, else 0..3
    drops: tuple[int, ...] = ()

    @property
    def is_spread(self) -> bool:
        return self.direction is not None

    @property
    def count(self) -> int:
        return sum(self.drops)

    def __str__(self) -> str:
        sq = f"{chr(ord('a') + self.col)}{self.row + 1}"
        if not self.is_spread:
            return {FLAT: "", WALL: "S", CAP: "C"}[self.piece] + sq
        k = self.count
        prefix = str(k) if k > 1 else ""
        suffix = "".join(str(d) for d in self.drops) if len(self.drops) > 1 else ""
        return f"{prefix}{sq}{DIR_CHARS[self.direction]}{suffix}"


_SPREAD_RE = re.compile(r"^([1-9]?)([a-h])([1-8])([<>+-])([1-9]*)\*?$")
_PLACE_RE = re.compile(r"^([CS]?)([a-h])([1-8])$")


def parse_move(s: str) -> Move:
    """Parse a PTN move string (analysis/src/parse.rs:6-8 regexes)."""
    s = s.strip()
    m = _PLACE_RE.match(s)
    if m:
        piece = {"": FLAT, "S": WALL, "C": CAP}[m.group(1)]
        return Move(row=int(m.group(3)) - 1, col=ord(m.group(2)) - ord("a"), piece=piece)
    m = _SPREAD_RE.match(s)
    if m:
        count = int(m.group(1)) if m.group(1) else 1
        row, col = int(m.group(3)) - 1, ord(m.group(2)) - ord("a")
        direction = DIR_CHARS.index(m.group(4))
        drops = tuple(int(c) for c in m.group(5)) if m.group(5) else (count,)
        if sum(drops) != count:
            raise ValueError(f"bad drop counts in move {s!r}")
        return Move(row=row, col=col, direction=direction, drops=drops)
    raise ValueError(f"cannot parse move {s!r}")


@lru_cache(maxsize=None)
class Tables:
    """All static per-size tables, as numpy arrays (wrap in jnp at use site)."""

    def __init__(self, n: int):
        validate(n)
        self.n = n
        self.num_squares = n * n
        P = num_patterns(n)
        self.num_pat = P
        self.num_actions = action_space(n)

        # --- pattern tables ------------------------------------------------
        # channel p <-> mask p+1 (masks 1 .. 2^n-2; all-ones excluded)
        pat_drops = np.zeros((P, n - 1), np.int32)  # drops per distance-1
        pat_k = np.zeros(P, np.int32)               # total pieces picked up
        pat_s = np.zeros(P, np.int32)               # number of drop squares
        pat_last = np.zeros(P, np.int32)            # final drop count
        for p in range(P):
            drops = pattern_mask_to_drops(p + 1, n)
            pat_drops[p, : len(drops)] = drops
            pat_k[p] = sum(drops)
            pat_s[p] = len(drops)
            pat_last[p] = drops[-1]
        self.pat_drops, self.pat_k, self.pat_s, self.pat_last = (
            pat_drops, pat_k, pat_s, pat_last,
        )

        # --- spread path table --------------------------------------------
        # flat square index at distance j+1 in direction d; n*n = off-board
        path = np.full((n * n, 4, n - 1), n * n, np.int32)
        for r in range(n):
            for c in range(n):
                for d, (dr, dc) in enumerate(DIR_VECS):
                    for j in range(1, n):
                        rr, cc = r + dr * j, c + dc * j
                        if 0 <= rr < n and 0 <= cc < n:
                            path[r * n + c, d, j - 1] = rr * n + cc
        self.spread_path = path
        # in-bounds for all s drop squares of pattern p (furthest implies rest)
        self.spread_fits = path[:, :, pat_s - 1] < n * n  # [n*n, 4, P]

        # --- canonical enumeration order (move_gen.rs) ---------------------
        # possible_moves order: squares col-major (col outer, row inner);
        # empty square -> place flat, wall, cap; own stack -> spreads with
        # direction order Up,Down,Left,Right, pickup k ascending, then
        # composition bits ascending.  CANON_KEY ranks every action id.
        pat_rank = np.zeros(P, np.int32)
        order = sorted(range(P), key=lambda p: (int(pat_k[p]),
                                                (p + 1) >> (n - int(pat_k[p]))))
        for rank, p in enumerate(order):
            pat_rank[p] = rank
        sub = 3 + 4 * P
        canon = np.zeros(self.num_actions, np.int32)
        for a in range(self.num_actions):
            ch, sq = divmod(a, n * n)
            r, c = divmod(sq, n)
            cm = c * n + r  # column-major square rank
            if ch < 3:
                key = cm * sub + ch
            else:
                d, p = divmod(ch - 3, P)
                key = cm * sub + 3 + ENUM_DIR_ORDER.index(d) * P + pat_rank[p]
            canon[a] = key
        self.canon_key = canon

        # --- legacy one-hot move list (move_map.rs:51-201 scheme) ----------
        # Squares col-major; per square: flat, S, C placements, then spreads
        # with direction order '<','-','>','+', pickup ascending, composition
        # bits ascending, only geometrically-fitting ones.  The 5x5 list has
        # 1575 entries like the reference's POSSIBLE_MOVES_IN_5S.
        legacy: list[int] = []  # action ids in legacy order
        legacy_dirs = [DIR_CHARS.index(ch) for ch in "<->+"]
        n_place_types = 3 if default_starting_stones(n)[1] > 0 else 2
        for c in range(n):  # all placements first
            for r in range(n):
                sq = r * n + c
                for piece_ch in range(n_place_types):
                    legacy.append(piece_ch * n * n + sq)
        for c in range(n):  # then all spreads
            for r in range(n):
                sq = r * n + c
                for d in legacy_dirs:
                    for p in order:  # (k asc, bits asc)
                        if path[sq, d, pat_s[p] - 1] < n * n:
                            legacy.append((3 + d * P + p) * n * n + sq)
        assert len(legacy) == legacy_action_space(n), (len(legacy), n)
        self.legacy_actions = np.asarray(legacy, np.int32)
        # map action id -> legacy index (or -1)
        inv = np.full(self.num_actions, -1, np.int32)
        inv[self.legacy_actions] = np.arange(len(legacy), dtype=np.int32)
        self.legacy_index = inv

        # --- D4 symmetry tables (tak/src/symm.rs) --------------------------
        # sym 0..3: rot^i with rot (r,c)->(c, n-1-r); sym 4..7: rot^(i-4)∘mirror
        # with mirror (r,c)->(r, n-1-c).  Directions transform as the linear
        # part; drop patterns are invariant (symm.rs:40-53).
        def sq_t(i, r, c):
            if i >= 4:
                c = n - 1 - c
                i -= 4
            for _ in range(i):
                r, c = c, n - 1 - r
            return r, c

        def dir_t(i, d):
            dr, dc = DIR_VECS[d]
            if i >= 4:
                dc = -dc
                i -= 4
            for _ in range(i):
                dr, dc = dc, -dr
            return DIR_VECS.index((dr, dc))

        sym_sq = np.zeros((8, n * n), np.int32)   # sym_sq[i, sq] = T_i(sq)
        for i in range(8):
            for r in range(n):
                for c in range(n):
                    rr, cc = sq_t(i, r, c)
                    sym_sq[i, r * n + c] = rr * n + cc
        self.sym_square = sym_sq
        sym_dir = np.zeros((8, 4), np.int32)
        for i in range(8):
            for d in range(4):
                sym_dir[i, d] = dir_t(i, d)
        self.sym_dir = sym_dir

        sym_act = np.zeros((8, self.num_actions), np.int32)
        for i in range(8):
            for a in range(self.num_actions):
                ch, sq = divmod(a, n * n)
                tsq = sym_sq[i, sq]
                if ch < 3:
                    sym_act[i, a] = ch * n * n + tsq
                else:
                    d, p = divmod(ch - 3, P)
                    sym_act[i, a] = (3 + sym_dir[i, d] * P + p) * n * n + tsq
        self.sym_action = sym_act  # sym_action[i, a] = T_i(a)

        # Inverse permutations: x_transformed = x[sym_*_inv[i]] applies T_i
        # to an array indexed by square/action (scatter expressed as gather).
        self.sym_square_inv = np.argsort(sym_sq, axis=1).astype(np.int32)
        self.sym_action_inv = np.argsort(sym_act, axis=1).astype(np.int32)

        # symmetry over the legacy move list (closed under D4: geometric
        # fit is symmetric), for the dense Net5-style policy head
        L = len(self.legacy_actions)
        legacy_sym = inv[sym_act[:, self.legacy_actions]]  # [8, L]
        assert (legacy_sym >= 0).all()
        self.legacy_sym_action = legacy_sym.astype(np.int32)
        self.legacy_sym_action_inv = np.argsort(legacy_sym, axis=1).astype(
            np.int32
        )

    # --- host-side move <-> action id -------------------------------------
    def move_to_action(self, m: Move) -> int:
        n = self.n
        sq = m.row * n + m.col
        if not m.is_spread:
            return (m.piece - 1) * n * n + sq
        p = (drops_to_pattern_mask(m.drops, n)) - 1
        return (3 + m.direction * self.num_pat + p) * n * n + sq

    def action_to_move(self, a: int) -> Move:
        n = self.n
        ch, sq = divmod(int(a), n * n)
        r, c = divmod(sq, n)
        if ch < 3:
            return Move(row=r, col=c, piece=ch + 1)
        d, p = divmod(ch - 3, self.num_pat)
        return Move(row=r, col=c, direction=d,
                    drops=pattern_mask_to_drops(p + 1, n))

    @cached_property
    def _ptn_index(self) -> dict:
        """Canonical PTN string -> action id (example files hold tens of
        thousands of lines, each with dozens of moves)."""
        return {self.action_to_ptn(a): a for a in range(self.num_actions)}

    def ptn_to_action(self, s: str) -> int:
        a = self._ptn_index.get(s)
        return a if a is not None else self.move_to_action(parse_move(s))

    def action_to_ptn(self, a: int) -> str:
        return str(self.action_to_move(a))
