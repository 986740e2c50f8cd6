"""Hand-built trees and pending waves: the hard cases of the large-tree kernels.

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
    return f


def hand_tree(name: str, B: int, M: int, K: int, A: int, V: int,
              seed: int = 0) -> dict:
    """The tree fields of case `name` for B games (each game from its own
    stream of the seed), as numpy arrays with a leading game axis."""
    if M < nodes_needed(V):
        raise ValueError(f"{M} nodes: the cases need {nodes_needed(V)}")
    games = [_one_game(np.random.default_rng([seed, g]), name, M, K, A, V)
             for g in range(B)]
    return {k: np.stack([g[k] for g in games]) for k in games[0]}


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
