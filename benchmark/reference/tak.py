"""Plain Tak rules, the network's input planes and the board's symmetries.

Written from the rules of Tak (the `tak` crate's game.rs and move_gen.rs
semantics) and from alpha-tak's encodings of moves (repr/moves.rs,
search/move_map.rs) and of positions (repr/board.rs, repr/game.rs); it
imports nothing of the program.  A position is read from the fields the
program hands out (`GameState.to_numpy()`: `stacks` uint32 [n2, W] with
bit h the colour of the piece at height h, `heights`, `tops`, `to_move`,
`ply`, `stones`, `caps`, `half_komi`, `reversible`, `result`).

The action id is `channel * n^2 + row * n + col`; channels 0-2 place a
flat, wall or capstone; channel 3 + d * P + p spreads in direction d
(0 up: row + 1, 1 right: col + 1, 2 down: row - 1, 3 left: col - 1) with
drop pattern p, P = 2^n - 2.  Pattern p is the n-bit mask p + 1: for the
drops (d_1..d_s) of k pieces, (d_i - 1) zeros then a one each, most
significant first, left-aligned to n bits; the all-ones mask is
excluded.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

EMPTY, FLAT, WALL, CAP = 0, 1, 2, 3
ONGOING, WHITE_ROAD, BLACK_ROAD = 0, 1, 2
WHITE_FLATS, BLACK_FLATS, DRAW_FLATS, DRAW_REVERSIBLE = 3, 4, 5, 6
REVERSIBLE_PLIES = 50
DEPTH_BEYOND_CARRY = 6
START = {3: (10, 0), 4: (15, 0), 5: (21, 1), 6: (30, 1), 7: (40, 2),
         8: (50, 2)}
DIRS = ((1, 0), (0, 1), (-1, 0), (0, -1))   # (drow, dcol) per direction
FIELDS = ("stacks", "heights", "tops", "to_move", "ply", "stones", "caps",
          "half_komi", "reversible", "result")


def words(n: int) -> int:
    stones, caps = START[n]
    return (2 * (stones + caps) + 31) // 32


def num_patterns(n: int) -> int:
    return 2 ** n - 2


def num_actions(n: int) -> int:
    return n * n * (3 + 4 * num_patterns(n))


def input_channels(n: int) -> int:
    stones, caps = START[n]
    return 2 * (n + 2 + DEPTH_BEYOND_CARRY) + 2 + 2 * stones + 2 * caps


@lru_cache(maxsize=None)
def pattern_drops(n: int) -> tuple:
    """The drops of every pattern p, in pattern order."""
    out = []
    for mask in range(1, 2 ** n - 1):
        tz = (mask & -mask).bit_length() - 1
        k = n - tz
        kbits = mask >> tz
        drops, prev = [], -1
        for i in range(k):
            if (kbits >> (k - 1 - i)) & 1:
                drops.append(i - prev)
                prev = i
        out.append(tuple(drops))
    return tuple(out)


class Position:
    """One position as plain Python lists: `stacks[q]` the colours bottom
    to top, `tops[q]` the top piece's type."""

    def __init__(self, n, stacks, tops, to_move, ply, stones, caps,
                 half_komi, reversible, result):
        self.n = n
        self.stacks = stacks
        self.tops = tops
        self.to_move = to_move
        self.ply = ply
        self.stones = stones
        self.caps = caps
        self.half_komi = half_komi
        self.reversible = reversible
        self.result = result

    @staticmethod
    def from_fields(fields: dict, i: int, n: int) -> "Position":
        n2 = n * n
        stacks = []
        for q in range(n2):
            h = int(fields["heights"][i][q])
            w = [int(x) for x in fields["stacks"][i][q]]
            stacks.append([(w[j >> 5] >> (j & 31)) & 1 for j in range(h)])
        return Position(
            n, stacks, [int(t) for t in fields["tops"][i]],
            int(fields["to_move"][i]), int(fields["ply"][i]),
            [int(x) for x in fields["stones"][i]],
            [int(x) for x in fields["caps"][i]],
            int(fields["half_komi"][i]), int(fields["reversible"][i]),
            int(fields["result"][i]))

    def copy(self) -> "Position":
        return Position(self.n, [list(s) for s in self.stacks],
                        list(self.tops), self.to_move, self.ply,
                        list(self.stones), list(self.caps), self.half_komi,
                        self.reversible, self.result)

    def fields(self) -> dict:
        """The program's field layout of this position (one row)."""
        n2, W = self.n * self.n, words(self.n)
        st = np.zeros((n2, W), np.uint32)
        for q, s in enumerate(self.stacks):
            for h, c in enumerate(s):
                st[q, h >> 5] |= np.uint32(c << (h & 31))
        return {"stacks": st,
                "heights": np.array([len(s) for s in self.stacks], np.int32),
                "tops": np.array(self.tops, np.int32),
                "to_move": np.int32(self.to_move), "ply": np.int32(self.ply),
                "stones": np.array(self.stones, np.int32),
                "caps": np.array(self.caps, np.int32),
                "half_komi": np.int32(self.half_komi),
                "reversible": np.int32(self.reversible),
                "result": np.int32(self.result)}

    # -- rules ---------------------------------------------------------------

    def _ray(self, q: int, d: int, s: int):
        n = self.n
        r, c = divmod(q, n)
        dr, dc = DIRS[d]
        out = []
        for i in range(1, s + 1):
            rr, cc = r + i * dr, c + i * dc
            if not (0 <= rr < n and 0 <= cc < n):
                return None
            out.append(rr * n + cc)
        return out

    def legal_actions(self) -> set:
        n, n2 = self.n, self.n * self.n
        if self.result != ONGOING:
            return set()
        me = self.to_move
        out = set()
        opening = self.ply < 2
        for q in range(n2):
            if self.stacks[q]:
                continue
            if opening:
                out.add(q)
                continue
            if self.stones[me] > 0:
                out.add(q)
                out.add(n2 + q)
            if self.caps[me] > 0:
                out.add(2 * n2 + q)
        if opening:
            return out
        P = num_patterns(n)
        for q in range(n2):
            s = self.stacks[q]
            if not s or s[-1] != me:
                continue
            top = self.tops[q]
            for d in range(4):
                for p, drops in enumerate(pattern_drops(n)):
                    if sum(drops) > min(n, len(s)):
                        continue
                    ray = self._ray(q, d, len(drops))
                    if ray is None:
                        continue
                    ok = True
                    for i, t in enumerate(ray):
                        tt = self.tops[t]
                        last = i == len(ray) - 1
                        if tt == CAP or (tt == WALL and not (
                                last and top == CAP and drops[-1] == 1)):
                            ok = False
                            break
                    if ok:
                        out.add((3 + d * P + p) * n2 + q)
        return out

    def step(self, action: int) -> "Position":
        """The position after `action` (not checked for legality); a
        finished game comes back unchanged."""
        if self.result != ONGOING:
            return self.copy()
        n, n2 = self.n, self.n * self.n
        new = self.copy()
        ch, q = divmod(action, n2)
        me = self.to_move
        if ch < 3:
            colour = 1 - me if self.ply < 2 else me
            new.stacks[q].append(colour)
            new.tops[q] = ch + 1
            if ch + 1 == CAP:
                new.caps[me] -= 1
            else:
                new.stones[colour] -= 1
            new.reversible = 0
        else:
            d, p = divmod(ch - 3, num_patterns(n))
            drops = pattern_drops(n)[p]
            k = sum(drops)
            top = self.tops[q]
            carried = new.stacks[q][len(new.stacks[q]) - k:]
            del new.stacks[q][len(new.stacks[q]) - k:]
            new.tops[q] = FLAT if new.stacks[q] else EMPTY
            at = 0
            ray = self._ray(q, d, len(drops))
            for i, t in enumerate(ray):
                new.stacks[t].extend(carried[at:at + drops[i]])
                at += drops[i]
                new.tops[t] = top if i == len(ray) - 1 else FLAT
            new.reversible = self.reversible + 1
        new.to_move = 1 - me
        new.ply = self.ply + 1
        new.result = new._result()
        return new

    def _roads(self):
        n = self.n
        out = []
        for colour in (0, 1):
            own = [bool(s) and s[-1] == colour and self.tops[q] in (FLAT, CAP)
                   for q, s in enumerate(self.stacks)]
            hit = False
            for axis in (0, 1):   # 0: bottom row to top row, 1: left to right
                start = [q for q in range(n * n) if own[q]
                         and (q // n if axis == 0 else q % n) == 0]
                seen = set(start)
                todo = list(start)
                while todo and not hit:
                    q = todo.pop()
                    if (q // n if axis == 0 else q % n) == n - 1:
                        hit = True
                    r, c = divmod(q, n)
                    for dr, dc in DIRS:
                        rr, cc = r + dr, c + dc
                        t = rr * n + cc
                        if 0 <= rr < n and 0 <= cc < n and own[t] \
                                and t not in seen:
                            seen.add(t)
                            todo.append(t)
            out.append(hit)
        return out

    def flat_diff(self) -> int:
        return sum((1 if s[-1] == 0 else -1) for q, s in enumerate(self.stacks)
                   if s and self.tops[q] == FLAT)

    def _result(self) -> int:
        just_moved = 1 - self.to_move
        roads = self._roads()
        if roads[just_moved]:
            return WHITE_ROAD if just_moved == 0 else BLACK_ROAD
        if roads[1 - just_moved]:
            return WHITE_ROAD if just_moved == 1 else BLACK_ROAD
        out = any(self.stones[c] == 0 and self.caps[c] == 0 for c in (0, 1))
        full = all(self.stacks)
        if out or full:
            hk = self.half_komi
            diff = self.flat_diff() - int(hk / 2)
            if diff > 0:
                return WHITE_FLATS
            if diff < 0:
                return BLACK_FLATS
            return BLACK_FLATS if hk % 2 != 0 else DRAW_FLATS
        if self.reversible >= REVERSIBLE_PLIES:
            return DRAW_REVERSIBLE
        return ONGOING


def same_fields(a: dict, b: dict) -> list:
    """The names of the fields on which two one-row positions differ."""
    return [f for f in FIELDS if not np.array_equal(np.asarray(a[f]),
                                                    np.asarray(b[f]))]


# -- network input planes ----------------------------------------------------

def observe(fields: dict, n: int, device=None) -> torch.Tensor:
    """Input planes float32 [R, n, n, C] of the rows of `fields`, from the
    side to move (alpha-tak repr/board.rs, repr/game.rs): the top piece
    (flat, wall, cap) x (mine, theirs); the n + 5 pieces below the top,
    each a (mine, theirs) pair; one-hot reserves (my stones, their stones,
    my caps, their caps); white to move; (white flat tops - black flat
    tops - komi) / n^2, the komi half_komi / 2 truncated."""
    stones0, caps0 = START[n]
    n2 = n * n

    def t(x, dt=torch.int64):
        return torch.as_tensor(np.asarray(x).astype(np.int64),
                               device=device).to(dt)

    stacks = t(fields["stacks"])                    # [R, n2, W]
    heights = t(fields["heights"])
    tops = t(fields["tops"])
    to_move = t(fields["to_move"])
    R = heights.shape[0]

    def colour_at(h):                               # [R, n2, ...] heights
        hc = torch.clamp(h, min=0)
        w = torch.gather(stacks, 2, (hc >> 5).reshape(R, n2, -1))
        return (w >> (hc & 31).reshape(R, n2, -1)) & 1

    occupied = heights > 0
    top_col = colour_at(heights - 1)[..., 0]
    mine_top = top_col == to_move[:, None]
    planes = []
    for piece in (FLAT, WALL, CAP):
        on = occupied & (tops == piece)
        planes += [on & mine_top, on & ~mine_top]
    depth = n + DEPTH_BEYOND_CARRY - 1
    below = heights[..., None] - 2 - torch.arange(depth, device=device)
    cols = colour_at(below)
    present = below >= 0
    mine = present & (cols == to_move[:, None, None])
    theirs = present & ~mine
    sub = torch.stack([mine, theirs], -1).reshape(R, n2, 2 * depth)
    board = torch.cat([torch.stack(planes, -1), sub], -1).float()

    def onehot(count, size):
        return ((torch.arange(size, device=device)[None, :]
                 == (count - 1)[:, None]) & (count > 0)[:, None]).float()

    st, cp = t(fields["stones"]), t(fields["caps"])
    me = to_move[:, None]
    reserves = torch.cat([
        onehot(st.gather(1, me)[:, 0], stones0),
        onehot(st.gather(1, 1 - me)[:, 0], stones0),
        onehot(cp.gather(1, me)[:, 0], caps0),
        onehot(cp.gather(1, 1 - me)[:, 0], caps0)], 1)
    flat_top = occupied & (tops == FLAT)
    diff = (torch.where(flat_top, 1 - 2 * top_col, 0)).sum(-1)
    hk = t(fields["half_komi"])
    komi = torch.where(hk >= 0, hk // 2, -((-hk) // 2))
    extra = torch.cat([reserves, (to_move == 0).float()[:, None],
                       ((diff - komi).float() / n2)[:, None]], 1)
    planes = torch.cat([board, extra[:, None, :].expand(R, n2, -1)], -1)
    return planes.reshape(R, n, n, -1)


# -- the board's eight symmetries ---------------------------------------------

@lru_cache(maxsize=None)
def symmetries(n: int):
    """(square maps [8, n2], action maps [8, A]) of the dihedral group:
    symmetry g takes square q to `sq[g, q]` and action a to `act[g, a]`."""
    n2, P = n * n, num_patterns(n)

    def transforms():
        for rot in range(4):
            for flip in (False, True):
                def f(r, c, rot=rot, flip=flip):
                    if flip:
                        c = n - 1 - c
                    for _ in range(rot):
                        r, c = c, n - 1 - r
                    return r, c

                def lin(dr, dc, rot=rot, flip=flip):
                    if flip:
                        dc = -dc
                    for _ in range(rot):
                        dr, dc = dc, -dr
                    return dr, dc
                yield f, lin

    sq_maps, act_maps = [], []
    for f, lin in transforms():
        sq = np.array([f(*divmod(q, n))[0] * n + f(*divmod(q, n))[1]
                       for q in range(n2)], np.int64)
        dmap = [DIRS.index(lin(*DIRS[d])) for d in range(4)]
        act = np.zeros(n2 * (3 + 4 * P), np.int64)
        for ch in range(3 + 4 * P):
            if ch < 3:
                ch2 = ch
            else:
                d, p = divmod(ch - 3, P)
                ch2 = 3 + dmap[d] * P + p
            act[ch * n2 + np.arange(n2)] = ch2 * n2 + sq
        sq_maps.append(sq)
        act_maps.append(act)
    return np.stack(sq_maps), np.stack(act_maps)
