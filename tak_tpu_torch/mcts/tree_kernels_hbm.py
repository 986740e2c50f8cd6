"""Large-tree wave kernels: descents and backups on pools of up to 140,000 nodes.

Replaces the two Pallas kernels of `tak_tpu/mcts/pallas_hbm.py` (the
"pallas_hbm" tier that the single-game `Player` ponders on):

  * `build_descend_wave_hbm` (:324) -> `descend_wave_hbm`: V sequential
    virtual-loss PUCT descents per game; the root pick is dense over all A
    actions, each tree level reads one K-wide edge row; a descent that
    reaches an unmaterialized child creates it while the pool has room.
  * `build_expand_backup_wave_hbm` (:648) -> `expand_backup_wave_hbm`: per
    leaf, swap in the anchored outcome of a terminal leaf, install the
    top-K edge row of a new ongoing non-root leaf, and walk to the root
    adding n+1, virt-1, w+sign*value.

Semantics (pallas_hbm.py): C(N) = ln((1+N+base)/base) + init in the
Pallas float32 operation order, Q counts each virtual visit as a loss,
ties go to the LAST maximum, descent v sees every virtual mark of
descents < v, node indices are allocated in the kernel's order, a
rootward create that finds the pool full leaves no mark, and a create
below the root that finds it full ends the descent at the parent.
There is no recycling on this tier: `node_n`, `node_virt` and
`child_count` are never read or written, and a fresh slot's `expanded`
flag is left as it is (False since the tree was built).

What is NOT carried over from the TPU kernels: their per-row DMA, the
512-row VMEM cache of hot rows and its flush.  Those exist because VMEM
cannot hold the edge tier; on the card the whole tree is in global
memory and the L2 caches what the walk touches, so only the semantics
above are ported.

CUDA design (`csrc/tree_wave_hbm.cu`): one thread block per game (the
Player runs one game, so one block).  Descend: the legal root actions
are staged once per launch in shared memory, in ascending order (q, prior
and denominator; global reads if more are legal than fit); four warps
walk the tree together, a slot per lane at K=128, and agree on each
level's choice through shared memory, while the other twelve warps
already score the next descent's root pick, handed over through named
barriers; the thread that scored the chosen slot writes the mark.
Expand+backup: one thread per leaf records its path to the root, all
leaves at once (in shared memory, or in a global buffer from the wrapper
for a wave too wide for it); then one warp applies the paths in leaf
order, a path's levels together, while the other warps install the new
rows.  What bounds them on the H100: neither bytes nor operations but
latency, the chain of dependent global loads of each descent, on one SM
of 132; `parent_chase` and `child_chase` measure that round trip on a
wave's own paths.

The plain PyTorch versions below are batched over games and loop over
the V descents and the walk; they are what a CPU tensor runs and what
the kernels are held against bitwise on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build as kb
from ..types import ONGOING
from .tree import NONE, Tree
from .tree_kernels import Pending, _c_puct, _check, _last_argmax

MAX_HBM_NODES = 140_000  # the reference's cap on this tier's node pool


def fits_hbm(max_nodes: int) -> bool:
    """The reference's pool cap (pallas_hbm.py:75) without its TPU-only
    lane rule K % 128 == 0, which guards a Mosaic slicing restriction."""
    return max_nodes <= MAX_HBM_NODES


# ---------------------------------------------------------------------------
# Plain PyTorch versions (batched over games, in place)
# ---------------------------------------------------------------------------

def _q_u(n, virt, w, prior, nv, base, init):
    """PUCT score terms in the Pallas operation order: nv [B] is the
    visit count of the node whose edges are scored."""
    tot = (n + virt).float()
    q = torch.where(tot > 0, (w - virt.float()) / torch.clamp(tot, min=1.0),
                    torch.zeros_like(tot))
    u = (_c_puct(nv, base, init)[:, None] * prior * torch.sqrt(nv)[:, None]
         / (1.0 + tot))
    return q + u


def descend_wave_hbm_plain(tree: Tree, wave_size: int, *, base: float,
                           init: float):
    """V descents per game, in place.  Returns (leaves [B, V] int32,
    created [B, V] bool)."""
    B, M, K = tree.edge_n.shape
    dev = tree.n0.device
    b = torch.arange(B, device=dev)
    leaves = torch.zeros((B, wave_size), dtype=torch.int32, device=dev)
    created = torch.zeros((B, wave_size), dtype=torch.bool, device=dev)
    bias = torch.where(tree.root_legal, torch.zeros_like(tree.root_prior),
                       torch.full_like(tree.root_prior, float("-inf")))
    zero_b = torch.zeros(B, dtype=torch.long, device=dev)
    none_b = torch.full((B,), NONE, dtype=torch.long, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    nf = tree.next_free.long()
    for v in range(wave_size):
        # ---- root selection: dense PUCT over the full action space ----
        n0f = (tree.n0 + tree.virt0).float()
        a0 = _last_argmax(_q_u(tree.root_n, tree.root_virt, tree.root_w,
                               tree.root_prior, n0f, base, init) + bias)
        c0 = tree.root_child[b, a0].long()
        nv = (tree.root_n[b, a0] + tree.root_virt[b, a0]).long()
        create0 = (c0 == NONE) & (nf < M)
        # no mark on a rootward create that finds the pool full
        tree.root_virt[b, a0] += ((c0 != NONE) | (nf < M)).int()
        tree.virt0 += 1
        g = torch.nonzero(create0).flatten()
        s0 = nf[g]
        tree.root_child[g, a0[g]] = s0.int()
        tree.parent[g, s0] = 0
        tree.parent_slot[g, s0] = NONE
        tree.parent_action[g, s0] = a0[g].int()
        leaf_v = torch.where(create0, nf, zero_b)
        created_v = create0.clone()
        nf = nf + create0.long()
        cur = torch.where(create0, none_b, c0)

        # ---- walk down until a leaf resolves ---------------------------
        while bool((cur != NONE).any()):
            act = cur != NONE
            ci = torch.clamp(cur, min=0)
            exp = tree.expanded[b, ci] & act
            ea = tree.edge_action[b, ci]
            ev = tree.edge_virt[b, ci]
            en = tree.edge_n[b, ci]
            score = _q_u(en, ev, tree.edge_w[b, ci], tree.edge_prior[b, ci],
                         nv.float(), base, init)
            slot = _last_argmax(torch.where(ea != NONE, score, neg_inf))
            child = tree.edge_child[b, ci, slot].long()
            cnv = (en[b, slot] + ev[b, slot]).long()
            want = exp & (child == NONE)
            ok = want & (nf < M)
            g = torch.nonzero(exp).flatten()
            tree.edge_virt[g, ci[g], slot[g]] += 1
            g = torch.nonzero(ok).flatten()
            sc = nf[g]
            tree.edge_child[g, ci[g], slot[g]] = sc.int()
            tree.parent[g, sc] = cur[g].int()
            tree.parent_slot[g, sc] = slot[g].int()
            tree.parent_action[g, sc] = ea[g, slot[g]]
            stopping = act & (~exp | want)
            leaf_v = torch.where(stopping, torch.where(ok, nf, cur), leaf_v)
            created_v = created_v | ok
            nf = nf + ok.long()
            cur = torch.where(stopping | ~act, none_b, child)
            nv = torch.where(stopping, nv, cnv)

        leaves[:, v] = leaf_v.int()
        created[:, v] = created_v
    tree.next_free.copy_(nf)
    return leaves, created


def expand_backup_wave_hbm_plain(tree: Tree, pending: Pending) -> None:
    """Install the pending leaves' edge rows and apply their V backups,
    in place."""
    B, M, K = tree.edge_n.shape
    A = tree.root_n.shape[1]
    V = pending.leaves.shape[1]
    dev = tree.n0.device
    b = torch.arange(B, device=dev)
    none_b = torch.full((B,), NONE, dtype=torch.long, device=dev)
    for v in range(V):
        cur = pending.leaves[:, v].long()
        res = pending.results[:, v]
        winner = torch.where((res == 1) | (res == 3), 0,
                             torch.where((res == 2) | (res == 4), 1, -1))
        one = torch.ones_like(pending.values[:, v])
        term_val = torch.where(
            winner < 0, 0.0 * one,
            torch.where(pending.to_move[:, v] == winner, one, -one))
        val = torch.where(res != ONGOING, term_val, pending.values[:, v])

        # expansion: install the leaf's top-K prior row
        do_exp = (res == ONGOING) & (cur != 0) & ~tree.expanded[b, cur]
        g = torch.nonzero(do_exp).flatten()
        if g.numel():
            cg = cur[g]
            va = pending.topk_vals[g, v]
            ai = pending.topk_aidx[g, v]
            okm = va >= 0.0
            tree.edge_action[g, cg] = torch.where(okm, ai,
                                                  torch.full_like(ai, NONE))
            tree.edge_child[g, cg] = NONE
            tree.edge_prior[g, cg] = torch.where(okm, va,
                                                 torch.zeros_like(va))
            tree.edge_n[g, cg] = 0
            tree.edge_virt[g, cg] = 0
            tree.edge_w[g, cg] = 0.0
            tree.expanded[g, cg] = True

        # sign-alternating walk to the root
        sign = torch.full((B,), -1.0, device=dev)
        active = torch.ones(B, dtype=torch.bool, device=dev)
        while bool(active.any()):
            ci = torch.clamp(cur, min=0)
            p = tree.parent[b, ci].long()
            s = tree.parent_slot[b, ci].long()
            a = tree.parent_action[b, ci].long()
            is_root_edge = active & (p == 0) & (s == NONE)
            is_edge = active & (p != NONE) & ~is_root_edge
            add = sign * val
            g = torch.nonzero(is_root_edge & (a >= 0) & (a < A)).flatten()
            tree.root_n[g, a[g]] += 1
            tree.root_virt[g, a[g]] -= 1
            tree.root_w[g, a[g]] += add[g]
            g = torch.nonzero(is_edge & (s >= 0) & (s < K)).flatten()
            tree.edge_n[g, p[g], s[g]] += 1
            tree.edge_virt[g, p[g], s[g]] -= 1
            tree.edge_w[g, p[g], s[g]] += add[g]
            at_root = (active & (cur == 0)).int()
            tree.n0 += at_root
            tree.virt0 -= at_root
            cur = torch.where(active, p, none_b)
            sign = -sign
            active = cur != NONE


# ---------------------------------------------------------------------------
# Wrappers: CUDA tensors launch the kernel, CPU tensors run the plain version
# ---------------------------------------------------------------------------

# the fields the kernels take, in the C entry points' order; node_n,
# node_virt and child_count are not among them
_DESCEND_ARGS = (
    ("parent", torch.int32, "M"), ("parent_slot", torch.int32, "M"),
    ("parent_action", torch.int32, "M"), ("expanded", torch.bool, "M"),
    ("edge_action", torch.int32, "MK"), ("edge_prior", torch.float32, "MK"),
    ("edge_child", torch.int32, "MK"), ("edge_n", torch.int32, "MK"),
    ("edge_virt", torch.int32, "MK"), ("edge_w", torch.float32, "MK"),
    ("root_prior", torch.float32, "A"), ("root_child", torch.int32, "A"),
    ("root_legal", torch.bool, "A"), ("root_n", torch.int32, "A"),
    ("root_virt", torch.int32, "A"), ("root_w", torch.float32, "A"),
    ("n0", torch.int32, ""), ("virt0", torch.int32, ""),
    ("next_free", torch.int32, ""),
)
_BACKUP_ARGS = tuple(a for a in _DESCEND_ARGS
                     if a[0] not in ("root_prior", "root_child", "root_legal",
                                     "next_free"))
_PENDING_ARGS = (
    ("leaves", torch.int32, "V"), ("topk_vals", torch.float32, "VK"),
    ("topk_aidx", torch.int32, "VK"), ("results", torch.int32, "V"),
    ("values", torch.float32, "V"), ("to_move", torch.int32, "V"),
)


def _dims(tree: Tree, V: int) -> dict:
    """The kernels' dimensions; raises on a shape they do not take."""
    B, M, K = tree.edge_n.shape
    if K > 1024:
        raise ValueError(f"max_children {K} above the kernels' 1024")
    if M * K >= 2 ** 31:
        raise ValueError(f"{M} nodes x {K} children: an edge index does not "
                         "fit the 32-bit path codes of the backup kernel")
    if V < 1 or V * K >= 2 ** 31:
        raise ValueError(f"wave size {V} x {K} children: the backup kernel "
                         "counts a wave's row slots in 32 bits")
    return {"B": B, "M": M, "K": K, "A": tree.root_n.shape[1], "V": V}


_SCRATCH_BYTES: dict[int, int] = {}   # wave size -> bytes a game


def _backup_scratch(lib, B: int, V: int, dev):
    """The backup kernel's global buffer for a wave whose recorded paths
    (544 B a leaf) do not fit the block's shared memory: int32 [B, bytes/4],
    or None where the shared memory holds them."""
    if V not in _SCRATCH_BYTES:
        nbytes = ctypes.c_longlong()
        kb.check(lib.tak_backup_scratch_bytes(V, ctypes.addressof(nbytes)),
                 "backup_scratch_bytes")
        _SCRATCH_BYTES[V] = nbytes.value
    words = _SCRATCH_BYTES[V] // 4
    if words == 0:
        return None
    return torch.empty((B, words), dtype=torch.int32, device=dev)


def descend_wave_hbm(tree: Tree, wave_size: int, *, base: float,
                     init: float):
    """V descents per game on the large-tree tier; the tree is updated in
    place.  Returns (leaves [B, V] int32, created [B, V] bool)."""
    dev = tree.n0.device
    if dev.type == "cpu":
        return descend_wave_hbm_plain(tree, wave_size, base=base, init=init)
    d = _dims(tree, wave_size)
    _check(tree, _DESCEND_ARGS, d, dev, "descend_wave_hbm")
    leaves = torch.empty((d["B"], wave_size), dtype=torch.int32, device=dev)
    created = torch.empty((d["B"], wave_size), dtype=torch.bool, device=dev)
    lib = kb.library("tree_wave_hbm")
    err = lib.tak_descend_wave_hbm(
        d["B"], d["M"], d["K"], d["A"], wave_size, base, init,
        *(kb.ptr(getattr(tree, f)) for f, _, _ in _DESCEND_ARGS),
        kb.ptr(leaves), kb.ptr(created), kb.stream_ptr(dev))
    kb.check(err, "descend_wave_hbm")
    kb.LAUNCHES["descend_wave_hbm"] += 1
    return leaves, created


def expand_backup_wave_hbm(tree: Tree, pending: Pending) -> None:
    """Install the pending leaves' edge rows and apply their V backups on
    the large-tree tier, in place."""
    dev = tree.n0.device
    if dev.type == "cpu":
        expand_backup_wave_hbm_plain(tree, pending)
        return
    d = _dims(tree, pending.leaves.shape[1])
    _check(tree, _BACKUP_ARGS, d, dev, "expand_backup_wave_hbm")
    _check(pending, _PENDING_ARGS, d, dev, "expand_backup_wave_hbm")
    lib = kb.library("tree_wave_hbm")
    scratch = _backup_scratch(lib, d["B"], d["V"], dev)
    err = lib.tak_expand_backup_wave_hbm(
        d["B"], d["M"], d["K"], d["A"], d["V"],
        *(kb.ptr(getattr(tree, f)) for f, _, _ in _BACKUP_ARGS),
        *(kb.ptr(getattr(pending, f)) for f, _, _ in _PENDING_ARGS),
        None if scratch is None else kb.ptr(scratch), kb.stream_ptr(dev))
    kb.check(err, "expand_backup_wave_hbm")
    kb.LAUNCHES["expand_backup_wave_hbm"] += 1


# ---------------------------------------------------------------------------
# Measuring aids: the dependent-load chains of a wave (no ported kernel)
# ---------------------------------------------------------------------------

def parent_chase(tree: Tree, leaves: torch.Tensor) -> torch.Tensor:
    """Levels [B] on the parent chains of `leaves` [B, V], followed by one
    thread per game, leaf after leaf, one dependent load per level: the
    round trip that the backup kernel's walks cannot avoid.  A measuring
    aid, not a ported kernel, so it counts no launch.  On the CPU the same
    count with tensor operations."""
    dev = tree.n0.device
    B, M = tree.parent.shape
    leaves = leaves.to(torch.int32).contiguous()
    if dev.type == "cpu":
        b = torch.arange(B)[:, None]
        cur = leaves.long()
        levels = torch.zeros(B, dtype=torch.int32)
        while bool((cur != NONE).any()):
            levels += (cur != NONE).sum(1).int()
            cur = torch.where(cur != NONE,
                              tree.parent[b, cur.clamp(min=0)].long(), cur)
        return levels
    levels = torch.empty(B, dtype=torch.int32, device=dev)
    lib = kb.library("tree_wave_hbm")
    err = lib.tak_parent_chase(B, M, leaves.shape[1], kb.ptr(tree.parent),
                               kb.ptr(leaves), kb.ptr(levels),
                               kb.stream_ptr(dev))
    kb.check(err, "parent_chase")
    return levels


def wave_paths(tree: Tree, leaves: torch.Tensor):
    """The paths from the root to `leaves` [B, V], read off the parent
    links on the host: (actions [B, V], the root action of each path or
    NONE for the root itself; slots [B, V, D], the edge slot taken at every
    node below, NONE after the path's end), int32 on the tree's device."""
    import numpy as np

    parent = tree.parent.cpu().numpy()
    slot = tree.parent_slot.cpu().numpy()
    action = tree.parent_action.cpu().numpy()
    B, V = leaves.shape
    paths = [[[] for _ in range(V)] for _ in range(B)]
    actions = np.full((B, V), NONE, np.int32)
    for g in range(B):
        for v, cur in enumerate(leaves[g].tolist()):
            while cur > 0:
                if slot[g, cur] == NONE:
                    actions[g, v] = action[g, cur]
                else:
                    paths[g][v].append(int(slot[g, cur]))
                cur = int(parent[g, cur])
    D = max(1, max(len(p) for row in paths for p in row))
    slots = np.full((B, V, D), NONE, np.int32)
    for g in range(B):
        for v, p in enumerate(paths[g]):
            slots[g, v, :len(p)] = p[::-1]
    dev = tree.n0.device
    return (torch.as_tensor(actions, device=dev),
            torch.as_tensor(slots, device=dev))


def child_chase(tree: Tree, actions: torch.Tensor,
                slots: torch.Tensor) -> torch.Tensor:
    """The node each path of `wave_paths` ends in [B, V], followed
    downwards through `root_child` and `edge_child` by one thread per game,
    path after path, one dependent load per level: the round trip that the
    descend kernel's walks cannot avoid (it must read the chosen slot's
    child out of every node's row).  A measuring aid: counts no launch."""
    dev = tree.n0.device
    B, M, K = tree.edge_child.shape
    V, D = slots.shape[1:]
    if dev.type == "cpu":
        ends = torch.zeros((B, V), dtype=torch.int32)
        for g in range(B):
            for v in range(V):
                a = int(actions[g, v])
                cur = 0 if a == NONE else int(tree.root_child[g, a])
                for s in slots[g, v].tolist():
                    if s == NONE:
                        break
                    cur = int(tree.edge_child[g, cur, s])
                ends[g, v] = cur
        return ends
    ends = torch.empty((B, V), dtype=torch.int32, device=dev)
    lib = kb.library("tree_wave_hbm")
    err = lib.tak_child_chase(
        B, M, K, tree.root_child.shape[1], V, D, kb.ptr(tree.root_child),
        kb.ptr(tree.edge_child), kb.ptr(actions), kb.ptr(slots),
        kb.ptr(ends), kb.stream_ptr(dev))
    kb.check(err, "child_chase")
    return ends
