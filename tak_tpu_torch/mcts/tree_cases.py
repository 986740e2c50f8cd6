"""Hand-built trees and pending waves: the hard cases of the tree kernels.

A search grows bushy, shallow trees; the cases that the kernels' layout
puts at risk are rare in them.  This module builds such trees directly,
as numpy arrays in the `Tree` layout, from a seed:

  * `shared_prefix`: a chain of expanded nodes 40 deep whose last node has
    V children: every descent of a wave runs down the same 40 edges, and
    every backup adds its (non-dyadic) value to them, so the order of the
    float adds shows;
  * `dups_twice`: the chain ends in V/2 children and no other action, so
    every leaf of the wave occurs twice;
  * `one_leaf`: the chain ends in an unexpanded node, so the same leaf
    occurs V times;
  * `deep_chain`: the chain is 150 deep, longer than the 128 levels of a
    path that the backup kernel keeps in shared memory;
  * `root_creates`: only the root is expanded: every descent creates a
    child of the root, and every backup ends after one level;
  * `pool_full`: as `root_creates`, with room for V/2 more nodes: the
    later descents find the pool full and return the root as their leaf.

Every tree carries the node tier of recycling (node_n, node_virt,
child_count) as a search would have left it.  `POOL_CASES` are the pool
tier's recycling cases, each in a full pool (see there); `check_first_wave`
tells whether a wave on one of them was the case it was built to be.

`hand_pending` makes the evaluation of a wave's leaves from a seed, with
terminal results mixed in, masked top-K entries and values that are not
dyadic.  The same arrays go through the plain versions and the reference's
kernels in the CPU tests, and through the CUDA kernels and the plain
versions on the card.
"""

from __future__ import annotations

import numpy as np

from .tree import NONE

CASES = {
    "shared_prefix": dict(chain=40, fan="V"),
    "dups_twice": dict(chain=5, fan="V/2"),
    "one_leaf": dict(chain=6, fan=0),
    "deep_chain": dict(chain=150, fan="V/2"),
    "root_creates": dict(chain=0, fan=0),
    "pool_full": dict(chain=0, fan=0, room="V/2"),
}


def nodes_needed(V: int) -> int:
    """A pool that holds every case's tree and a wave's creates."""
    return max(c["chain"] for c in CASES.values()) + 2 * V + 2


def _count(spec, V: int) -> int:
    return {"V": V, "V/2": V // 2}.get(spec, spec)


def _row(rng, K: int, A: int, slots: int, lead: int):
    """One edge row: `slots` distinct actions with falling priors that are
    not dyadic; slot `lead` gets most of the mass."""
    action = np.full(K, NONE, np.int32)
    prior = np.zeros(K, np.float32)
    action[:slots] = rng.choice(A, size=slots, replace=False)
    p = np.sort(rng.random(slots).astype(np.float32))[::-1] * np.float32(0.001)
    prior[:slots] = p
    prior[lead] = np.float32(0.9)
    return action, prior


def _one_game(rng, name: str, M: int, K: int, A: int, V: int) -> dict:
    spec = CASES[name]
    chain, fan = spec["chain"], _count(spec["fan"], V)
    f = dict(
        parent=np.full(M, NONE, np.int32),
        parent_slot=np.full(M, NONE, np.int32),
        parent_action=np.full(M, NONE, np.int32),
        expanded=np.zeros(M, bool),
        edge_action=np.full((M, K), NONE, np.int32),
        edge_prior=np.zeros((M, K), np.float32),
        edge_child=np.full((M, K), NONE, np.int32),
        edge_n=np.zeros((M, K), np.int32),
        edge_virt=np.zeros((M, K), np.int32),
        edge_w=np.zeros((M, K), np.float32),
        root_prior=np.zeros(A, np.float32),
        root_child=np.full(A, NONE, np.int32),
        root_legal=np.zeros(A, bool),
        root_n=np.zeros(A, np.int32),
        root_virt=np.zeros(A, np.int32),
        root_w=np.zeros(A, np.float32),
    )
    legal = np.sort(rng.choice(A, size=min(A, 3 * V), replace=False))
    f["root_legal"][legal] = True
    f["root_prior"][legal] = (rng.random(legal.size).astype(np.float32)
                              * np.float32(0.001))
    f["expanded"][0] = True
    nodes = 1
    visits = 1000
    if chain:
        a0 = int(legal[rng.integers(legal.size)])
        f["root_prior"][a0] = np.float32(0.9)
        f["root_child"][a0] = 1
        f["root_n"][a0] = visits
        f["root_w"][a0] = np.float32(visits * 0.3 + rng.random())
        f["parent"][1], f["parent_action"][1] = 0, a0
        nodes = 2
    for node in range(1, chain + 1):
        last = node == chain
        if last and fan == 0:
            break                       # the chain ends in an unexpanded node
        f["expanded"][node] = True
        slots = fan if last else int(rng.integers(2, K + 1))
        lead = int(rng.integers(slots))
        action, prior = _row(rng, K, A, slots, lead)
        f["edge_action"][node], f["edge_prior"][node] = action, prior
        children = range(slots) if last else (lead,)
        for slot in children:
            child = nodes
            nodes += 1
            f["edge_child"][node, slot] = child
            f["parent"][child] = node
            f["parent_slot"][child] = slot
            f["parent_action"][child] = action[slot]
            if not last:
                f["edge_n"][node, slot] = visits
                f["edge_w"][node, slot] = np.float32(
                    visits * 0.3 + rng.random())
        if last:
            f["edge_prior"][node, :slots] = np.float32(1.0 / slots)
    room = spec.get("room")
    f["next_free"] = np.int32(M - _count(room, V) if room else nodes)
    f["n0"] = np.int32(1 + f["root_n"].sum())
    f["virt0"] = np.int32(0)
    _node_tier(f)
    return f


def _node_tier(f: dict) -> None:
    """The recycling fields of a tree whose links are set: child_count
    counts the attached children, node_n is the visit count of the edge a
    node hangs from, nothing is pinned."""
    par, slot, act = f["parent"], f["parent_slot"], f["parent_action"]
    M = par.shape[0]
    f["child_count"] = np.bincount(par[par >= 0], minlength=M).astype(np.int32)
    n = np.zeros(M, np.int32)
    for i in np.nonzero(par >= 0)[0]:
        n[i] = (f["root_n"][act[i]] if slot[i] == NONE
                else f["edge_n"][par[i], slot[i]])
    f["node_n"] = n
    f["node_virt"] = np.zeros(M, np.int32)


def max_wave(name: str, K: int, V: int) -> int:
    """The largest wave up to V whose case fits rows of K slots."""
    fan = CASES[name]["fan"] if name in CASES else 0
    return min(V, K if fan == "V" else 2 * K if fan == "V/2" else V)


def hand_tree(name: str, B: int, M: int, K: int, A: int, V: int,
              seed: int = 0) -> dict:
    """The tree fields of case `name` (of CASES or POOL_CASES) for B games
    (each game from its own stream of the seed), as numpy arrays with a
    leading game axis.  A pool case's dict also holds `pending_leaves`
    [B, V], the leaves of the wave in flight (NONE where there is none),
    which is not a tree field."""
    if name in POOL_CASES:
        build = _pool_game
    elif M < nodes_needed(V):
        raise ValueError(f"{M} nodes: the cases need {nodes_needed(V)}")
    else:
        build = _one_game
    games = [build(np.random.default_rng([seed, g]), name, M, K, A, V)
             for g in range(B)]
    return {k: np.stack([g[k] for g in games]) for k in games[0]}


# ---------------------------------------------------------------------------
# The pool tier: a full pool, so that every create recycles a node
# ---------------------------------------------------------------------------

# Every pool case fills the pool: nodes 1..M-1 hang from the root, with a
# few visits and a poor value; at least 2V other legal root actions have no
# child.
POOL_CASES = {
    # node 1 leads the root pick, is expanded, childless and the coldest
    # node: the first create below it evicts the second candidate (`use2`),
    # a child of the root, whose root_child entry is reset
    "evict_parent": dict(lead=True, cold_lead=True),
    # node 1 leads, and every node is pinned: no create finds a victim, so
    # each descent ends in node 1 (`cur`) having created nothing
    "no_candidate": dict(lead=True, pinned=True),
    # every descent creates a child of the root; three candidates tie at
    # the lowest node_n (the lowest index goes first), the others exceed
    # the clamp 2^30/PK - 1 (they go by index, not by node_n)
    "tied_keys": dict(ties=True),
    # V root children are the leaves of the wave in flight (pinned, marked,
    # the coldest): the merged kernel's backups unpin them, and its
    # descents, creating children of the root, evict them
    "merged_unpin": dict(in_flight=True),
}


def pool_nodes(V: int) -> int:
    """The pool of the CPU tests: every case of CASES fits, with room."""
    return nodes_needed(V) + 8


def _pool_game(rng, name: str, M: int, K: int, A: int, V: int) -> dict:
    spec = POOL_CASES[name]
    L = M - 1 + 2 * V     # legal root actions: M-1 with a child, 2V without
    if A < L:
        raise ValueError(f"{A} actions: the pool cases need {L}")
    f = dict(
        parent=np.full(M, NONE, np.int32),
        parent_slot=np.full(M, NONE, np.int32),
        parent_action=np.full(M, NONE, np.int32),
        expanded=np.zeros(M, bool),
        edge_action=np.full((M, K), NONE, np.int32),
        edge_prior=np.zeros((M, K), np.float32),
        edge_child=np.full((M, K), NONE, np.int32),
        edge_n=np.zeros((M, K), np.int32),
        edge_virt=np.zeros((M, K), np.int32),
        edge_w=np.zeros((M, K), np.float32),
        root_prior=np.zeros(A, np.float32),
        root_child=np.full(A, NONE, np.int32),
        root_legal=np.zeros(A, bool),
        root_n=np.zeros(A, np.int32),
        root_virt=np.zeros(A, np.int32),
        root_w=np.zeros(A, np.float32),
    )
    legal = rng.permutation(rng.choice(A, size=L, replace=False))
    f["root_legal"][legal] = True
    f["expanded"][0] = True
    kids, free = legal[:M - 1], legal[M - 1:]
    visits = rng.integers(1, 4, M - 1).astype(np.int32)
    f["root_child"][kids] = np.arange(1, M, dtype=np.int32)
    f["root_n"][kids] = visits
    f["root_w"][kids] = (-0.5 * visits
                         + 0.1 * rng.random(M - 1)).astype(np.float32)
    f["root_prior"][kids] = (rng.random(M - 1).astype(np.float32)
                             * np.float32(0.001))
    f["parent"][1:] = 0
    f["parent_action"][1:] = kids
    node_n = np.concatenate([[0], visits]).astype(np.int32)
    if spec.get("lead"):
        a0 = kids[0]
        f["root_prior"][free] = (rng.random(free.size).astype(np.float32)
                                 * np.float32(0.001))
        f["root_prior"][a0] = np.float32(0.9)
        f["root_n"][a0] = 1000
        f["root_w"][a0] = np.float32(900.0 + rng.random())
        f["expanded"][1] = True
        # a flat row: each descent's virtual loss sends the next elsewhere
        f["edge_action"][1] = rng.choice(A, size=K, replace=False)
        f["edge_prior"][1] = np.float32(1.0 / K)
        node_n[1] = 0 if spec.get("cold_lead") else 1000
    else:
        # creates at the root win every pick
        f["root_prior"][free] = (np.float32(0.3) + rng.random(free.size)
                                 .astype(np.float32) * np.float32(0.01))
    if spec.get("ties"):
        PK = -(-M // 128) * 128
        node_n[1:] = 2 ** 30 // PK + rng.integers(0, 10 ** 6, M - 1)
        node_n[1 + rng.choice(M - 1, size=3, replace=False)] = 5
    f["node_n"] = node_n
    f["child_count"] = np.bincount(f["parent"][1:],
                                   minlength=M).astype(np.int32)
    f["node_virt"] = np.zeros(M, np.int32)
    f["n0"] = np.int32(1 + f["root_n"].sum())
    f["virt0"] = np.int32(0)
    f["next_free"] = np.int32(M)
    if spec.get("pinned"):
        f["node_virt"][1:] = 1
    pending = np.full(V, NONE, np.int32)
    if spec.get("in_flight"):
        pending = rng.choice(np.arange(1, M), size=V,
                             replace=False).astype(np.int32)
        f["node_virt"][pending] = 1
        f["node_n"][pending] = 0
        f["root_virt"][f["parent_action"][pending]] = 1
        f["virt0"] = np.int32(V)
    f["pending_leaves"] = pending
    return f


def hand_pending(leaves: np.ndarray, K: int, A: int, seed: int = 0) -> dict:
    """A wave's evaluation for `leaves` [B, V]: top-K rows that differ from
    leaf to leaf (so which occurrence of a repeated leaf was installed
    shows) with their tail masked by -1, values that are not dyadic, and
    every third leaf terminal with results 1..5 in turn."""
    rng = np.random.default_rng([seed, 7])
    B, V = leaves.shape
    vals = np.sort(rng.random((B, V, K)).astype(np.float32), -1)[..., ::-1]
    vals = np.ascontiguousarray(vals)
    masked = rng.integers(0, K // 2 + 1, (B, V))
    vals[np.arange(K)[None, None, :] >= (K - masked)[..., None]] = -1.0
    aidx = np.argsort(rng.random((B, V, A)), -1)[..., :K].astype(np.int32)
    v = np.arange(V)[None, :]
    results = np.where(v % 3 == 2, 1 + (v // 3) % 5, 0).astype(np.int32)
    return dict(
        leaves=leaves.astype(np.int32),
        topk_vals=vals,
        topk_aidx=aidx,
        results=np.broadcast_to(results, (B, V)).copy(),
        values=(rng.random((B, V)) * 2 - 1).astype(np.float32),
        to_move=rng.integers(0, 2, (B, V)).astype(np.int32),
    )


def _require(ok, what: str) -> None:
    if not bool(ok):
        raise AssertionError(what)


def check_first_wave(name: str, before: dict, after: dict, leaves, created,
                     in_flight) -> None:
    """Raise AssertionError unless the first wave on case `name` was the
    case it was built to be.  `before` and `after` hold the tree fields as
    numpy arrays [B, ...] around the wave, `leaves` and `created` [B, V]
    its outputs, `in_flight` the case's pending leaves."""
    B, V = leaves.shape
    M = before["parent"].shape[1]
    b = np.arange(B)
    kids = (after["root_child"] != NONE).sum(1)
    kids_before = (before["root_child"] != NONE).sum(1)
    if name == "evict_parent":
        # node 1 was the coldest candidate but the first create's parent: it
        # stays at the root and takes the new node, evicted from the root
        a0 = before["parent_action"][:, 1]
        first = leaves[:, 0]
        _require((after["root_child"][b, a0] == 1).all()
                 and (after["parent"][:, 1] == 0).all(), "node 1 was evicted")
        _require(created[:, 0].all() and (after["parent"][b, first] == 1).all()
                 and (before["parent"][b, first] == 0).all(),
                 "the first create did not evict a child of the root")
        _require((kids == kids_before - created.sum(1)).all(),
                 "a create did not evict a child of the root")
    elif name == "no_candidate":
        _require(not created.any(), "a create found a victim")
        _require((leaves == 1).all(), "a descent did not end in node 1")
        _require((after["next_free"] == M).all(), "the pool is not full")
    elif name == "tied_keys":
        # evicted in key order: the three tied at node_n 5 by index, then
        # the clamped ones by index, whatever their node_n
        n = before["node_n"]
        clamp = 2 ** 30 // (-(-M // 128) * 128) - 1
        _require(created.all(), "a descent did not create")
        for g in range(B):
            tied = np.nonzero(n[g] == 5)[0]
            clamped = np.nonzero(n[g] > clamp)[0]
            _require(len(set(n[g, clamped].tolist())) > 1,
                     "the clamped node_n are all equal")
            _require((leaves[g] == np.concatenate([tied, clamped])[:V]).all(),
                     "the victims were not taken in key order")
    elif name == "merged_unpin":
        # every leaf in flight was unpinned by its backup, then evicted and
        # reused by a create at another root action
        _require(created.all(), "a descent did not create")
        for g in range(B):
            _require(set(leaves[g].tolist()) == set(in_flight[g].tolist()),
                     "the victims were not the leaves in flight")
        _require((after["parent_action"][b[:, None], leaves]
                  != before["parent_action"][b[:, None], leaves]).all(),
                 "a victim was not reused at another action")
    else:
        # the large tier's trees: no node is recycled, the pool has room
        _require((after["next_free"] < M).all(), "the pool filled up")
