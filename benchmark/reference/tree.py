"""The pool tier's tree waves in plain NumPy, one game at a time: the
backups of a pending wave (install each new leaf's top-K edge row, the
outcome of terminal leaves, sign-alternating backups that turn a virtual
visit into a real one) and V sequential virtual-loss PUCT descents with
node creation and, when recycling, eviction of the coldest node.

Written from the semantics of AlphaTak's search and of the tree layout
that the program hands out (`Tree`: a node tier [M], an edge tier [M, K]
with statistics on the parent's edge slot, a dense root tier [A]):
  * C(N) = ln((1 + N + base) / base) + init, base 500, init 4;
  * score = Q + C(N) * prior * sqrt(N) / (1 + n + virt), Q = (w - virt) /
    max(n + virt, 1) (0 while unvisited), each virtual visit a loss;
    ties go to the last maximum; illegal root actions and empty slots
    are never picked;
  * a descent stops at an unexpanded node or where it creates one; a new
    node takes the next free slot, else (recycling) the childless,
    unpinned non-root node of least (visits at creation, index), or the
    next such node where that one is the create's own parent; an evicted
    node is detached from its parent's edge or root entry; a node that
    cannot be had leaves the descent at its parent;
  * a backup adds -v to the leaf's edge, +v to the next, and so on to the
    root, one visit each, v the network's value or the terminal outcome
    for the side to move at the leaf.
It imports nothing of the program.

The descents follow the program's: at each step the reference scores
every choice itself, holds the program's choice (read from the links of
the tree the program left) to be its best to within `TIE`, a relative
rounding of the float32 scores, and goes on along the program's choice.
Every other number is compared exactly: each leaf and whether it was
created, and every field of the tree after the launch.
"""

from __future__ import annotations

import numpy as np

NONE = -1
ONGOING = 0
BASE, INIT = 500.0, 4.0
LANES = 128
INT_INF = 2 ** 30
TIE = 1e-5
F32 = np.float32

# the tree's fields that the pool tier's kernels read or write
FIELDS = ("parent", "parent_slot", "parent_action", "expanded", "node_n",
          "node_virt", "child_count", "edge_action", "edge_prior",
          "edge_child", "edge_n", "edge_virt", "edge_w", "root_prior",
          "root_child", "root_legal", "root_n", "root_virt", "root_w", "n0",
          "virt0", "next_free")
PENDING = ("leaves", "topk_vals", "topk_aidx", "results", "values",
           "to_move")


def _c(n):
    return np.log((F32(1.0) + n + F32(BASE)) / F32(BASE)) + F32(INIT)


def _scores(n, virt, w, prior, parent_n):
    tot = (n + virt).astype(F32)
    q = np.where(tot > 0, (w - virt.astype(F32)) / np.maximum(tot, F32(1.0)),
                 F32(0.0)).astype(F32)
    npf = F32(parent_n)
    u = _c(npf) * prior * np.sqrt(npf) / (F32(1.0) + tot)
    return (q + u).astype(F32)


def _last_max(s) -> int:
    return len(s) - 1 - int(np.argmax(s[::-1]))


class Game:
    """One game's tree (numpy copies of its fields), changed in place."""

    def __init__(self, fields: dict, recycle: bool):
        self.t = {k: np.array(v) for k, v in fields.items()}
        self.recycle = recycle
        self.M, self.K = self.t["edge_n"].shape
        self.A = self.t["root_n"].shape[0]

    # -- allocation ----------------------------------------------------------

    def _victim(self, cur: int):
        t, M = self.t, self.M
        pk = -(-M // LANES) * LANES
        idx = np.arange(M)
        cand = (t["child_count"] == 0) & (t["node_virt"] == 0) & (idx > 0)
        key = np.minimum(t["node_n"].astype(np.int64), INT_INF // pk - 1) \
            * pk + idx
        order = np.argsort(np.where(cand, key, INT_INF), kind="stable")[:2]
        for x in order:
            if cand[x] and x != cur:
                return int(x)
        return None

    def _alloc(self, cur: int):
        """A slot for a node created under `cur`, or None."""
        t = self.t
        nf = int(t["next_free"])
        if nf < self.M:
            t["next_free"] = nf + 1
            return nf
        if not self.recycle:
            return None
        x = self._victim(cur)
        if x is None:
            return None
        p, s, a = (int(t["parent"][x]), int(t["parent_slot"][x]),
                   int(t["parent_action"][x]))
        if p == 0 and s == NONE:
            if 0 <= a < self.A:
                t["root_child"][a] = NONE
        elif p >= 0 and 0 <= s < self.K:
            t["edge_child"][p, s] = NONE
        if p >= 0:
            t["child_count"][p] -= 1
        t["expanded"][x] = False
        t["node_n"][x] = 0
        return x

    def _link(self, x: int, parent: int, slot: int, action: int, n: int):
        t = self.t
        t["parent"][x] = parent
        t["parent_slot"][x] = slot
        t["expanded"][x] = False
        t["parent_action"][x] = action
        if self.recycle:
            t["child_count"][parent] += 1
            t["node_n"][x] = n

    # -- one descent ---------------------------------------------------------

    def _pick(self, s, forced) -> tuple:
        """(choice, off): the program's choice where it is the reference's
        best to within TIE, else the reference's best and off = 1."""
        best = _last_max(s)
        if forced is None:
            return best, 0
        if not 0 <= forced < len(s) or not np.isfinite(s[forced]):
            return best, 1
        room = TIE * max(1.0, abs(float(s[best])))
        if float(s[forced]) >= float(s[best]) - room:
            return forced, 0
        return best, 1

    def descend(self, path) -> tuple:
        """One descent along the program's `path` (root action, then edge
        slots): (leaf, created, choices off the reference's best)."""
        t = self.t
        off = 0
        legal = t["root_legal"]
        s = _scores(t["root_n"], t["root_virt"], t["root_w"],
                    t["root_prior"], int(t["n0"]) + int(t["virt0"]))
        s = np.where(legal, s, F32(-np.inf))
        a0, o = self._pick(s, path[0] if path else None)
        off += o
        c0 = int(t["root_child"][a0])
        n_a0 = int(t["root_n"][a0])
        nv = n_a0 + int(t["root_virt"][a0])
        t["virt0"] += 1
        leaf, created, cur = 0, False, NONE
        if c0 == NONE:
            x = self._alloc(0)
            if x is not None:
                t["root_virt"][a0] += 1
                t["root_child"][a0] = x
                self._link(x, 0, NONE, a0, n_a0)
                leaf, created = x, True
        else:
            t["root_virt"][a0] += 1
            cur = c0
        depth = 1
        while cur != NONE:
            if not t["expanded"][cur]:
                leaf = cur
                break
            ea = t["edge_action"][cur]
            s = _scores(t["edge_n"][cur], t["edge_virt"][cur],
                        t["edge_w"][cur], t["edge_prior"][cur], nv)
            s = np.where(ea != NONE, s, F32(-np.inf))
            slot, o = self._pick(s, path[depth] if depth < len(path)
                                 else None)
            off += o
            depth += 1
            child = int(t["edge_child"][cur, slot])
            en = int(t["edge_n"][cur, slot])
            cnv = en + int(t["edge_virt"][cur, slot])
            t["edge_virt"][cur, slot] += 1
            if child == NONE:
                x = self._alloc(cur)
                if x is None:
                    leaf = cur
                else:
                    t["edge_child"][cur, slot] = x
                    self._link(x, cur, slot, int(ea[slot]), en)
                    leaf, created = x, True
                break
            cur, nv = child, cnv
        if self.recycle:
            t["node_virt"][leaf] += 1
        return leaf, created, off

    # -- one backup ----------------------------------------------------------

    def backup(self, leaf: int, result: int, value, to_move: int, vals,
               aidx):
        t = self.t
        if result == ONGOING:
            val = F32(value)
        else:
            winner = (0 if result in (1, 3) else 1 if result in (2, 4)
                      else -1)
            val = F32(0.0 if winner < 0 else 1.0 if to_move == winner
                      else -1.0)
        if self.recycle:
            t["node_virt"][leaf] -= 1
        if result == ONGOING and leaf != 0 and not t["expanded"][leaf]:
            ok = vals >= 0
            t["edge_action"][leaf] = np.where(ok, aidx, NONE)
            t["edge_child"][leaf] = NONE
            t["edge_prior"][leaf] = np.where(ok, vals, F32(0.0))
            t["edge_n"][leaf] = 0
            t["edge_virt"][leaf] = 0
            t["edge_w"][leaf] = 0.0
            t["expanded"][leaf] = True
        sign = F32(-1.0)
        cur = leaf
        for _ in range(self.M + 1):
            if cur == NONE:
                break
            p, s, a = (int(t["parent"][cur]), int(t["parent_slot"][cur]),
                       int(t["parent_action"][cur]))
            add = F32(sign * val)
            if p == 0 and s == NONE:
                if 0 <= a < self.A:
                    t["root_n"][a] += 1
                    t["root_virt"][a] -= 1
                    t["root_w"][a] = F32(t["root_w"][a] + add)
            elif p != NONE and 0 <= s < self.K:
                t["edge_n"][p, s] += 1
                t["edge_virt"][p, s] -= 1
                t["edge_w"][p, s] = F32(t["edge_w"][p, s] + add)
            if cur == 0:
                t["n0"] += 1
                t["virt0"] -= 1
            cur, sign = p, -sign


def program_path(after: dict, leaf: int) -> list:
    """The choices of the descent that ended at `leaf`, read from the
    links of the tree the program left: the root action, then the edge
    slot at each node below.  Empty for the root itself."""
    nodes, x = [], int(leaf)
    M = len(after["parent"])
    while x > 0 and len(nodes) <= M:
        nodes.append(x)
        x = int(after["parent"][x])
    nodes.reverse()
    if not nodes:
        return []
    return ([int(after["parent_action"][nodes[0]])]
            + [int(after["parent_slot"][x]) for x in nodes[1:]])


def replay(before: dict, after: dict, pending: dict | None, valid: bool,
           out: dict | None, recycle: bool) -> int:
    """Mismatches of one game's launch: `before`/`after` the game's tree
    fields around it, `pending` the wave it backed up (applied when
    `valid`), `out` its descents' `leaves` and `created` (None for the
    expand+backup alone).  Counts the descents' choices off the
    reference's best, the leaves and created flags that differ, and the
    fields of the tree that differ after the launch."""
    g = Game(before, recycle)
    wrong = 0
    if valid:
        for v in range(len(pending["leaves"])):
            g.backup(int(pending["leaves"][v]), int(pending["results"][v]),
                     pending["values"][v], int(pending["to_move"][v]),
                     pending["topk_vals"][v], pending["topk_aidx"][v])
    if out is not None:
        for v, leaf in enumerate(out["leaves"]):
            ref_leaf, ref_created, off = g.descend(program_path(after, leaf))
            wrong += off
            wrong += int(ref_leaf != int(leaf))
            wrong += int(ref_created != bool(out["created"][v]))
    for f in FIELDS:
        if not np.array_equal(g.t[f], np.asarray(after[f])):
            wrong += 1
    return wrong
