"""Search-tree reuse: re-root onto a played move's subtree.

Counterpart of `tak_tpu/mcts/reuse.py`, batched over games: mark the
nodes reachable from each new root (parent-pointer doubling with a
liveness backlink check), optionally drop the coldest childless carried
nodes down to `keep`, compact the survivors to the front of the pool with
one permutation gather, remap parent/child links, and rebuild the dense
root tier from the new root's edge row.  The new root is left
unexpanded; `prepare_root` re-evaluates its full-width prior.
"""

from __future__ import annotations

import torch

from ..types import FIELDS, GameState
from .tree import NONE, Tree


def blank_trees(tree: Tree, states: GameState, mask) -> Tree:
    """Reset masked games' trees in place to a fresh root at `states`."""
    m = mask.to(tree.n0.device)
    g = torch.nonzero(m).flatten()
    if g.numel() == 0:
        return tree
    for f in FIELDS:
        getattr(tree.state, f)[g, 0] = getattr(states, f)[g]
    tree.result[g, 0] = states.result[g]
    tree.parent[g, 0] = NONE
    tree.expanded[g] = False
    for f in ("node_n", "node_virt", "child_count", "root_prior", "root_legal",
              "root_n", "root_virt", "root_w", "n0", "virt0"):
        getattr(tree, f)[g] = 0
    tree.root_child[g] = NONE
    tree.next_free[g] = 1
    return tree


def _reach_doubling(tree: Tree, c0i, has_subtree):
    """[B, M] bool: live slots in each c0i's subtree (ancestor-or-self
    chains by pointer doubling; dead slots fail the backlink check)."""
    B, M = tree.parent.shape
    A = tree.root_child.shape[1]
    dev = tree.parent.device
    idx = torch.arange(M, device=dev)[None, :]
    b = torch.arange(B, device=dev)[:, None]
    p = tree.parent.long()
    pc = torch.clamp(p, min=0)
    s = tree.parent_slot.long()
    a = tree.parent_action.long()
    root_link = ((p == 0) & (s == NONE)
                 & (tree.root_child.gather(1, torch.clamp(a, 0, A - 1)) == idx))
    edge_link = ((s != NONE) & tree.expanded.gather(1, pc)
                 & (tree.edge_child[b, pc, torch.clamp(s, min=0)] == idx))
    live = (p != NONE) & (root_link | edge_link)

    hit = (idx == c0i[:, None]) & has_subtree[:, None]
    jumpv = p
    for _ in range(max(1, (M - 1).bit_length())):
        jvalid = jumpv != NONE
        j = torch.clamp(jumpv, min=0)
        hit = hit | (jvalid & hit.gather(1, j))
        jumpv = torch.where(jvalid, jumpv.gather(1, j),
                            torch.full_like(jumpv, NONE))
    return hit & live


def reroot(engine, tree: Tree, action, new_root_state: GameState,
           max_children: int, keep: int | None = None) -> Tree:
    """Re-root every game's tree onto root action `action` [B]; returns a
    new tree.  `new_root_state` [B] is written to node 0 unconditionally,
    so an action whose child was never materialized degrades to a fresh
    tree at that position.  `keep`: drop the coldest childless carried
    nodes (lossless for edge statistics) until at most `keep` remain."""
    B, M, K = tree.edge_child.shape
    A = tree.root_prior.shape[1]
    dev = tree.parent.device
    b = torch.arange(B, device=dev)
    idx = torch.arange(M, device=dev)[None, :].expand(B, M)
    action = action.long().to(dev)

    c0 = tree.root_child[b, action].long()
    has_subtree = c0 != NONE
    c0i = torch.clamp(c0, min=0)
    reach = _reach_doubling(tree, c0i, has_subtree)

    if keep is not None:
        ecl = torch.clamp(tree.edge_child.long(), min=0).reshape(B, M * K)
        edge_ok = (tree.edge_child != NONE) & tree.expanded[..., None]
        inf = torch.full((B, M), 2 ** 30, dtype=torch.int32, device=dev)
        progressed = torch.ones(B, dtype=torch.bool, device=dev)
        while True:
            excess = torch.clamp(reach.sum(1) - keep, min=0)
            go = (excess > 0) & progressed
            if not bool(go.any()):
                break
            cc = (edge_ok & reach.gather(1, ecl).reshape(B, M, K)).sum(-1)
            cand = reach & (cc == 0) & (idx != c0i[:, None])
            score = torch.where(cand, tree.node_n, inf)
            order = torch.argsort(score, dim=1, stable=True)
            rank = torch.empty_like(order).scatter_(1, order, idx)
            new_reach = reach & ~(cand & (rank < excess[:, None]))
            new_reach = torch.where(go[:, None], new_reach, reach)
            progressed = torch.where(go, (new_reach != reach).any(1),
                                     progressed)
            reach = new_reach

    # compaction permutation: new_id = rank among reachable, root at 0
    ranks = torch.cumsum(reach.long(), 1) - 1
    none = torch.full_like(ranks, NONE)
    new_id_of = torch.where(reach, ranks, none)
    c0_rank = new_id_of.gather(1, c0i[:, None])
    swapped = torch.where(new_id_of == c0_rank, torch.zeros_like(ranks),
                          torch.where(new_id_of == 0, c0_rank.expand(B, M),
                                      new_id_of))
    new_id_of = torch.where(reach, swapped, none)
    n_reach = reach.sum(1)
    buf = torch.zeros((B, M + 1), dtype=torch.long, device=dev)
    buf.scatter_(1, torch.where(reach, new_id_of, torch.full_like(ranks, M)),
                 idx)
    old_of_new = buf[:, :M]

    def remap(arr):  # values that are node indices
        flat = arr.reshape(B, -1).long()
        out = new_id_of.gather(1, torch.clamp(flat, min=0))
        return torch.where(flat == NONE, flat, out).reshape(arr.shape).to(
            arr.dtype)

    def reorder(arr):  # leading [B, M] axes
        ix = old_of_new.reshape((B, M) + (1,) * (arr.dim() - 2)).expand(
            arr.shape)
        return arr.gather(1, ix)

    state = tree.state.map(reorder)
    for f in FIELDS:
        getattr(state, f)[:, 0] = getattr(new_root_state, f)
    new_parent = remap(reorder(tree.parent))
    new_parent_slot = torch.where(new_parent == 0,
                                  torch.full_like(new_parent, NONE),
                                  reorder(tree.parent_slot))
    valid_new = reach.gather(1, old_of_new)
    zero_i = torch.zeros_like(tree.node_n)
    result = reorder(tree.result)
    result[:, 0] = new_root_state.result
    new = tree.replace(
        state=state,
        result=result,
        parent=new_parent,
        parent_slot=new_parent_slot,
        parent_action=reorder(tree.parent_action),
        expanded=reorder(tree.expanded) & valid_new,
        node_n=torch.where(valid_new, reorder(tree.node_n), zero_i),
        node_virt=zero_i.clone(),
        child_count=torch.where(valid_new, reorder(tree.child_count), zero_i),
        edge_action=reorder(tree.edge_action),
        edge_prior=reorder(tree.edge_prior),
        edge_child=remap(reorder(tree.edge_child)),
        edge_n=reorder(tree.edge_n),
        edge_virt=reorder(tree.edge_virt),
        edge_w=reorder(tree.edge_w),
        next_free=torch.clamp(n_reach, min=1).to(torch.int32),
    )

    # rebuild the dense root tier from the new root's edge row
    acts = new.edge_action[:, 0].long()
    valid = (acts != NONE) & has_subtree[:, None]
    aidx = torch.where(valid, acts, torch.full_like(acts, A))

    def scatter_row(vals, fill):
        out = torch.full((B, A + 1), fill, dtype=vals.dtype, device=dev)
        out.scatter_(1, aidx, torch.where(valid, vals,
                                          torch.full_like(vals, fill)))
        return out[:, :A].contiguous()

    root_n = scatter_row(new.edge_n[:, 0], 0)
    root_w = scatter_row(new.edge_w[:, 0], 0.0)
    root_child = scatter_row(new.edge_child[:, 0], NONE)
    n0 = torch.where(has_subtree, tree.root_n[b, action],
                     torch.zeros_like(tree.n0))

    # node 0: clear its parent linkage, mark unexpanded
    new.parent[:, 0] = NONE
    new.parent_slot[:, 0] = NONE
    new.parent_action[:, 0] = NONE
    new.expanded[:, 0] = False
    new.node_n[:, 0] = n0
    new = new.replace(
        root_prior=torch.zeros_like(tree.root_prior),
        root_legal=torch.zeros_like(tree.root_legal),
        root_n=root_n,
        root_virt=torch.zeros_like(tree.root_virt),
        root_w=root_w,
        root_child=root_child,
        n0=n0.to(torch.int32),
        virt0=torch.zeros_like(tree.virt0),
    )
    # recount child_count from the remapped edge rows of expanded nodes
    counts = (new.edge_child != NONE).sum(-1).to(torch.int32)
    new.child_count = torch.where(new.expanded, counts, zero_i)
    return new
