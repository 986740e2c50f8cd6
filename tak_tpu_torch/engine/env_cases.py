"""Hand-built positions and actions: the hard cases of the env kernels.

Random playouts rarely reach what the fused step's and the rollout's
layouts put at risk.  This module builds such positions directly, as
numpy fields in the JAX package's layout (uint32 stacks, a leading batch
axis), for the sizes 3-8:

  * `opening_*`: plies 0 and 1, where a placement puts down the other
    colour's flat;
  * `carry_*` / `drop_*`: a spread that takes its carry from a stack of
    height 31-33 (62-66 at 7x7 and 8x8, 95-97 at 8x8), or drops onto one,
    so the carried window and the insert cross a stack-word boundary;
  * `edge_*`: a full carry of n pieces spread to the board's edge, the last
    square keeping the origin's wall or capstone;
  * `smash_*`: a capstone flattening a wall with its last drop;
  * `both_roads_*`: one spread that completes a road for each colour (the
    side that just moved wins), and `reveal_road`, a spread that uncovers
    the other side's road;
  * `snake_*`: a road that winds through the even columns, so the flood
    fill needs one iteration per square of the path (and `snake_open`, the
    same path one square short);
  * `last_*`: the last stone or capstone of a reserve, with half-komi odd,
    even and negative (flat wins, komi ties);
  * `full_board_*`: a placement on the last empty square;
  * `rev_*`: the reversible counter going from 48 to 49 and from 49 to 50
    (a draw), and a placement that resets it;
  * `disabled`, `finished`, `finished_disabled`: rows the step freezes.

Each case has a legal action (`step_cases`) and, where the case is about
the result, the result code that the step must give (`expect`).  The
same positions, without their actions, start the rollout's cases.  The
CPU tests hold the plain versions against the reference's kernels on
them; `chip_smoke.py` holds the CUDA kernels against the plain versions.
"""

from __future__ import annotations

import numpy as np

from ..actions import Move, Tables
from ..sizes import default_starting_stones, stack_words
from ..types import (
    BLACK_FLATS,
    BLACK_ROAD,
    CAP,
    DRAW_FLATS,
    DRAW_REVERSIBLE,
    FIELDS,
    FLAT,
    ONGOING,
    WALL,
    WHITE_FLATS,
    WHITE_ROAD,
    GameState,
)

SIZES = (3, 4, 5, 6, 7, 8)
RIGHT, UP = 1, 0          # direction channels (actions.DIR_VECS)


class _Position:
    """One board being built: stacks bottom to top, colours 0/1."""

    def __init__(self, n: int):
        self.n = n
        self.stacks = np.zeros((n * n, stack_words(n)), np.uint32)
        self.heights = np.zeros(n * n, np.int32)
        self.tops = np.zeros(n * n, np.int32)

    def put(self, row: int, col: int, colors, top: int = FLAT):
        q = row * self.n + col
        self.stacks[q] = 0
        for h, c in enumerate(colors):
            self.stacks[q, h >> 5] |= np.uint32(c) << np.uint32(h & 31)
        self.heights[q] = len(colors)
        self.tops[q] = top
        return self

    def fields(self, to_move: int, ply: int | None = None, half_komi: int = 0,
               rev: int = 0, result: int = ONGOING, stones=None,
               caps=None) -> dict:
        """The GameState fields; reserves are the size's less the pieces on
        the board (as a TPS import counts them) unless given."""
        n = self.n
        pieces, on_caps = [0, 0], [0, 0]
        for q in range(n * n):
            h = int(self.heights[q])
            for i in range(h):
                pieces[int(self.stacks[q, i >> 5] >> np.uint32(i & 31)) & 1] += 1
            if h and self.tops[q] == CAP:
                on_caps[int(self.stacks[q, (h - 1) >> 5]
                            >> np.uint32((h - 1) & 31)) & 1] += 1
        d_stones, d_caps = default_starting_stones(n)
        if stones is None:
            stones = [d_stones - (pieces[c] - on_caps[c]) for c in (0, 1)]
        if caps is None:
            caps = [d_caps - on_caps[c] for c in (0, 1)]
        assert min(stones) >= 0 and min(caps) >= 0, (stones, caps)
        if ply is None:
            ply = 20 + to_move
        return {
            "stacks": self.stacks.copy(), "heights": self.heights.copy(),
            "tops": self.tops.copy(), "to_move": np.int32(to_move),
            "ply": np.int32(ply), "stones": np.asarray(stones, np.int32),
            "caps": np.asarray(caps, np.int32),
            "half_komi": np.int32(half_komi), "reversible": np.int32(rev),
            "result": np.int32(result),
        }


def _alternating(height: int, top_color: int) -> list[int]:
    """`height` colours alternating bottom to top, ending in `top_color`."""
    return [(top_color + height - 1 - i) % 2 for i in range(height)]


def _spread(tables, row, col, direction, drops):
    return tables.move_to_action(Move(row=row, col=col, direction=direction,
                                      drops=tuple(drops)))


def _place(tables, row, col, piece=FLAT):
    return tables.move_to_action(Move(row=row, col=col, piece=piece))


def _boundary_heights(n: int) -> list[int]:
    """Stack heights around each stack-word boundary the size can reach
    (with one flat to spare); one word only (3x3, 4x4): the tallest."""
    flats = 2 * default_starting_stones(n)[0]
    if stack_words(n) == 1:
        return [flats - 1]
    hs = [h for b in (32, 64, 96) for h in (b - 1, b, b + 1)
          if b < 32 * stack_words(n)]
    hs += [62, 66] if stack_words(n) >= 3 else []
    return sorted(h for h in hs if h + 1 <= flats)


def _snake(n: int):
    """(cells, end): a path of squares through the even columns up to
    n - 2, from a1 up, over, down, over, ...; `end` is the square above
    the last column's top, which makes it a road from bottom to top."""
    lanes = list(range(0, n - 1, 2))
    cells = []
    for i, c in enumerate(lanes):
        if i == 0:
            rows = range(0, n - 1)
        elif i % 2:
            rows = range(n - 2, 0, -1)
        else:
            rows = range(1, n - 1)
        cells += [(r, c) for r in rows]
        if i + 1 < len(lanes):
            cells.append((n - 2 if i % 2 == 0 else 1, c + 1))
    return cells, (n - 1, lanes[-1])


def step_cases(n: int):
    """The cases of size n: a list of (name, fields, action, enabled,
    expect), `expect` the result code after the step, or None."""
    tables = Tables(n)
    caps_ok = default_starting_stones(n)[1] > 0
    out = []

    def add(name, fields, action, enabled=True, expect=None):
        out.append((name, fields, int(action), bool(enabled), expect))

    # plies 0 and 1: the placement puts down the other colour
    add("opening_ply0", _Position(n).fields(0, ply=0, half_komi=4),
        _place(tables, 0, 0), expect=ONGOING)
    p = _Position(n).put(0, 0, [1])
    add("opening_ply1", p.fields(1, ply=1), _place(tables, n - 1, n - 1),
        expect=ONGOING)

    # carries from, and drops onto, stacks across a stack-word boundary
    flats = 2 * default_starting_stones(n)[0]
    for h in _boundary_heights(n):
        for k, drops in ((1, (1,)), (2, (1, 1)),
                         (n, (2,) + (1,) * (n - 2))):
            p = _Position(n).put(1 % n, 0, _alternating(h, 0))
            add(f"carry_{h}_k{k}", p.fields(0), _spread(
                tables, 1 % n, 0, RIGHT, drops))
        k = min(n, flats - h)
        for drops in sorted({(k,), (1,) * k if k < n
                             else (2,) + (1,) * (n - 2)}):
            p = _Position(n).put(0, 1, _alternating(h, 1))
            p.put(0, 0, _alternating(k, 0))
            add(f"drop_{h}_{'-'.join(map(str, drops))}", p.fields(0),
                _spread(tables, 0, 0, RIGHT, drops))

    # a full carry of n pieces spread to the edge, flats on the way; the
    # last square keeps the origin's top
    tops = [WALL] + ([CAP] if caps_ok else [])
    for top in tops:
        p = _Position(n).put(0, 0, _alternating(n + 1, 1), top=top)
        for c in range(1, n):
            p.put(0, c, [c % 2])
        add(f"edge_right_{'wall' if top == WALL else 'cap'}", p.fields(1),
            _spread(tables, 0, 0, RIGHT, (2,) + (1,) * (n - 2)))
        p = _Position(n).put(0, n - 1, _alternating(n, 0), top=top)
        add(f"edge_up_{'wall' if top == WALL else 'cap'}", p.fields(0),
            _spread(tables, 0, n - 1, UP, (2,) + (1,) * (n - 2)))

    # a capstone flattening a wall: alone, and as the last drop of three
    if caps_ok:
        p = _Position(n).put(1, 1, [0], top=CAP).put(1, 2, [1], top=WALL)
        add("smash_alone", p.fields(0), _spread(tables, 1, 1, RIGHT, (1,)))
        p = _Position(n).put(0, 0, [1, 0, 0], top=CAP).put(0, 2, [1],
                                                           top=WALL)
        add("smash_after_2", p.fields(0),
            _spread(tables, 0, 0, RIGHT, (2, 1)))

    # one spread completes both colours' roads: the mover's wins
    c = n // 2
    for mover in (0, 1):
        p = _Position(n)
        for col in range(n):
            if col != c:
                p.put(1, col, [1 - mover])
                p.put(n - 1, col, [mover])
        carried = [1 - mover] + [col % 2 for col in range(n - 3)] + [mover]
        p.put(0, c, [mover] + carried)
        add(f"both_roads_{'white' if mover == 0 else 'black'}_moves",
            p.fields(mover), _spread(tables, 0, c, UP, (1,) * (n - 1)),
            expect=WHITE_ROAD if mover == 0 else BLACK_ROAD)
    # a spread uncovers the other side's road
    p = _Position(n)
    for col in range(1, n):
        p.put(0, col, [0])
    p.put(0, 0, [0, 1])
    add("reveal_road", p.fields(1), _spread(tables, 0, 0, UP, (1,)),
        expect=WHITE_ROAD)

    # a snake road: the fill needs one iteration per square of the path
    cells, end = _snake(n)
    for mover in (0, 1):
        p = _Position(n)
        for r, col in cells:
            p.put(r, col, [mover])
        add(f"snake_{'white' if mover == 0 else 'black'}", p.fields(mover),
            _place(tables, *end),
            expect=WHITE_ROAD if mover == 0 else BLACK_ROAD)
    p = _Position(n)
    for r, col in cells[1:]:
        p.put(r, col, [0])
    add("snake_open", p.fields(0), _place(tables, *end), expect=ONGOING)

    # the last piece of a reserve: flats counted with komi.  White has 3
    # flats after the step, black 2 and a wall, so the flat difference is 1
    base = (_Position(n).put(0, 0, [0]).put(0, 2 % n, [0])
            .put(n - 1, 0, [1]).put(n - 1, 2 % n, [1])
            .put(n - 1, 1, [1], top=WALL))
    black_caps = 1 if caps_ok else 0
    for komi, want in ((0, WHITE_FLATS), (1, WHITE_FLATS), (2, DRAW_FLATS),
                       (3, BLACK_FLATS), (4, BLACK_FLATS), (-1, WHITE_FLATS),
                       (-3, WHITE_FLATS)):
        add(f"last_stone_komi{komi}",
            base.fields(0, half_komi=komi, stones=[1, 4],
                        caps=[0, black_caps]),
            _place(tables, 1, 1), expect=want)
    add("last_wall", base.fields(0, half_komi=2, stones=[1, 4], caps=[0, 0]),
        _place(tables, 1, 1, WALL), expect=BLACK_FLATS)
    if caps_ok:
        add("last_cap", base.fields(1, half_komi=1, stones=[3, 0], caps=[0, 1]),
            _place(tables, 1, 1, CAP), expect=BLACK_FLATS)

    # a placement on the last empty square fills the board
    last = (n // 2, n // 2)
    for komi in (0, 1, 2):
        p = _Position(n)
        for q in range(n * n):
            r, col = divmod(q, n)
            if (r, col) == last:
                continue
            flat = (r, col) in ((0, 0), (n - 1, n - 1))
            p.put(r, col, [q % 2], top=FLAT if flat else WALL)
        add(f"full_board_komi{komi}", p.fields(0, half_komi=komi),
            _place(tables, *last))

    # the reversible counter: 48 -> 49, 49 -> 50 (a draw), 49 -> 0
    p = _Position(n).put(0, 0, [0]).put(n - 1, n - 1, [1])
    add("rev_48", p.fields(0, rev=48), _spread(tables, 0, 0, RIGHT, (1,)),
        expect=ONGOING)
    add("rev_49", p.fields(0, rev=49), _spread(tables, 0, 0, RIGHT, (1,)),
        expect=DRAW_REVERSIBLE)
    add("rev_49_place", p.fields(0, rev=49), _place(tables, 1, 1),
        expect=ONGOING)

    # rows the step freezes
    add("disabled", p.fields(0), _place(tables, 1, 1), enabled=False)
    add("finished", p.fields(1, result=WHITE_ROAD), _place(tables, 1, 1))
    add("finished_disabled", p.fields(0, result=DRAW_FLATS),
        _place(tables, 1, 1), enabled=False)
    return out


def batch(n: int, multiple: int = 8):
    """All cases of size n in one batch, the rows repeated from the start
    up to a multiple of `multiple`: (names, fields [R, ...], actions int32
    [R], enabled bool [R], expect list)."""
    cases = step_cases(n)
    distinct = len(cases)
    while len(cases) % multiple:
        cases.append(cases[len(cases) - distinct])
    names = [c[0] for c in cases]
    fields = {f: np.stack([c[1][f] for c in cases]) for f in FIELDS}
    actions = np.array([c[2] for c in cases], np.int32)
    enabled = np.array([c[3] for c in cases], bool)
    return names, fields, actions, enabled, [c[4] for c in cases]


def as_state(fields: dict, device) -> GameState:
    return GameState.from_numpy(fields, device)
