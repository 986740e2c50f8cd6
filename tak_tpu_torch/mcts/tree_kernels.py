"""Tree wave kernels: V sequential PUCT descents and V backups per game.

Replaces three Pallas kernels of `tak_tpu/mcts/pallas_ops.py`:

  * `build_backup_descend_wave` (:1118) -> `backup_descend_wave`: apply
    the pending wave (install each new leaf's top-K edge row, swap in the
    anchored outcome of terminal leaves, V sign-alternating backups that
    turn a virtual visit into a real one), then run V sequential
    virtual-loss PUCT descents with node creation and recycling.
  * `build_descend_wave` (:1284) -> `descend_wave`: the same kernel
    launched with valid=0 (no pending wave, descents only).
  * `build_expand_backup_wave` (:637) -> `expand_backup_wave`: the
    backup half alone (the flush at the end of each chunk).

Semantics (pallas_ops.py): C(N) = ln((1+N+base)/base) + init, Q counts
each virtual visit as a loss, ties go to the LAST maximum, descent v sees
every virtual mark of descents < v, and recycling evicts the coldest
childless unpinned node, min (node_n clamped to 2^30/PK-1, index) with
PK = 128*ceil(M/128), falling back to the second candidate when the first
is the create's own parent.  Node indices are allocated in the Pallas
kernels' order, so trees match field for field.

CUDA design (`csrc/tree_wave.cu`): one thread block per game, because
descents within a game are sequential by definition; the tree stays in
global memory (all 32 games, ~33 MB, stay resident in the 50 MB L2) and is
updated in place.  What a descent reads again and again lives in shared
memory for the whole launch: the legal root actions (staged once, 32 B
each, the root tier's other actions are never picked) and, with
recycling, a mirror of the node tier (28 B a node).  Warp 0 walks (a slot
per lane at K=32); meanwhile warps 8-15 score the next descent's root pick
and warps 1-7 find this descent's victim pair in the mirror, so neither
is on the walk's path.  The backups record every leaf's path in parallel,
install the new rows with all warps and apply every edge at once, its adds
in leaf order.  What bounds it on the H100: the dependent round trips of
the walk, not bytes or operations (PERF.md has the chain floor).

The plain PyTorch versions below are batched over games and loop over
the V descents and the tree walk; they reproduce the Pallas kernels'
sequential semantics and allocation order exactly, and are what a CPU
tensor runs.  The float32 PUCT arithmetic keeps the Pallas operation
order, and the CUDA build uses no fast-math and no FMA contraction, so
kernel and plain agree bit for bit on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels import build as kb
from ..types import ONGOING
from .tree import NONE, Tree

LANES = 128
INT_INF = 2 ** 30


@dataclass
class Pending:
    """Evaluation results of one wave, consumed by the next backup."""

    leaves: torch.Tensor      # int32 [B, V]
    topk_vals: torch.Tensor   # f32   [B, V, K] masked top-K priors (-1 pad)
    topk_aidx: torch.Tensor   # int32 [B, V, K] top-K action ids
    results: torch.Tensor     # int32 [B, V] leaf result codes
    values: torch.Tensor      # f32   [B, V] raw network values
    to_move: torch.Tensor     # int32 [B, V] leaf side to move
    valid: int = 1            # 0: nothing pending (first wave of a chunk)

    @staticmethod
    def zeros(B: int, V: int, K: int, device) -> "Pending":
        i32 = dict(dtype=torch.int32, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        return Pending(torch.zeros((B, V), **i32), torch.zeros((B, V, K), **f32),
                       torch.zeros((B, V, K), **i32), torch.zeros((B, V), **i32),
                       torch.zeros((B, V), **f32), torch.zeros((B, V), **i32),
                       valid=0)


def _cdiv(a, b):
    return -(-a // b)


# The reference sends a search to this tier when the tree fits the TPU's
# VMEM budget (pallas_ops.py:49-68).  The card has no such limit; the port
# keeps the rule so that one SearchConfig reaches the counterpart kernels
# in both packages.
VMEM_BUDGET_BYTES = 5 * 1024 * 1024


def tree_vmem_bytes(max_nodes: int, k: int, num_actions: int) -> int:
    kp = _cdiv(k, LANES) * LANES
    edge = 6 * max_nodes * kp * 4
    root = 7 * _cdiv(num_actions, LANES) * LANES * 4
    node = 5 * _cdiv(max_nodes, LANES) * LANES * 4
    return edge + root + node


def fits_in_vmem(max_nodes: int, k: int, num_actions: int) -> bool:
    return tree_vmem_bytes(max_nodes, k, num_actions) <= VMEM_BUDGET_BYTES


def pool_kernels_take(max_nodes: int, k: int, wave: int,
                      recycle: bool) -> bool:
    """Whether the pool tier's CUDA kernels take a recycled pool of this
    shape (`_dims`' limits; the root's actions have none)."""
    return (recycle and max_nodes <= MAX_RECYCLE_NODES and k <= 1024
            and 1 <= wave <= MAX_WAVE and max_nodes * k < 2 ** 31)


def _last_argmax(scores):
    """Index of the max along the last axis; ties -> LAST index."""
    K = scores.shape[-1]
    return K - 1 - torch.argmax(torch.flip(scores, (-1,)), -1)


def _c_puct(n, base, init):
    # divided by a tensor: PyTorch multiplies a CUDA tensor divided by a
    # Python scalar by the scalar's reciprocal, which can round one bit away
    # from the division that the kernels and the CPU compute
    return torch.log((1.0 + n + base) / torch.full_like(n, base)) + init


# ---------------------------------------------------------------------------
# Plain PyTorch versions (batched over games, in place)
# ---------------------------------------------------------------------------

def _victim_pair(tree: Tree):
    """Two coldest eviction candidates per game (childless, unpinned,
    non-root): min (node_n, index), as pallas_ops._victim_pair."""
    B, M = tree.node_n.shape
    PK = _cdiv(M, LANES) * LANES
    idx = torch.arange(M, device=tree.node_n.device)
    cand = (tree.child_count == 0) & (tree.node_virt == 0) & (idx > 0)
    n_c = torch.clamp(tree.node_n.long(), max=INT_INF // PK - 1)
    packed = torch.where(cand, n_c * PK + idx, torch.full_like(n_c, INT_INF))
    m1 = packed.min(1).values
    v1 = m1 % PK
    packed2 = torch.where(idx[None, :] == v1[:, None],
                          torch.full_like(packed, INT_INF), packed)
    m2 = packed2.min(1).values
    return v1, m1 < INT_INF, m2 % PK, m2 < INT_INF


def _alloc(tree: Tree, want, nf, cur, pair, recycle: bool):
    """Node slot per game: a fresh slot while the pool has room, else evict
    the coldest candidate of `pair` (skipping `cur`).  Eviction detaches
    the victim from its parent edge (or the root tier) and keeps the edge
    statistics.  Returns (slot, ok, new_nf)."""
    M = tree.node_n.shape[1]
    if not recycle:
        ok = want & (nf < M)
        return nf, ok, nf + ok.long()
    v1, have1, v2, have2 = pair
    fresh = nf < M
    use2 = v1 == cur
    victim = torch.where(use2, v2, v1)
    have = torch.where(use2, have2, have1)
    evict = want & ~fresh & have
    if bool(evict.any()):
        A = tree.root_child.shape[1]
        K = tree.edge_child.shape[2]
        g = torch.nonzero(evict).flatten()
        vg = victim[g]
        pv = tree.parent[g, vg].long()
        sv = tree.parent_slot[g, vg].long()
        av = tree.parent_action[g, vg].long()
        root_edge = (pv == 0) & (sv == NONE)
        sel = root_edge & (av >= 0) & (av < A)
        tree.root_child[g[sel], av[sel]] = NONE
        sel = ~root_edge & (pv >= 0) & (sv >= 0) & (sv < K)
        tree.edge_child[g[sel], pv[sel], sv[sel]] = NONE
        sel = pv >= 0
        tree.child_count[g[sel], pv[sel]] -= 1
        tree.expanded[g, vg] = False
        tree.node_n[g, vg] = 0
    slot = torch.where(fresh, nf, victim)
    ok = want & (fresh | have)
    return slot, ok, nf + (want & fresh).long()


def _descend_plain(tree: Tree, V: int, base: float, init: float,
                   recycle: bool):
    B, M, K = tree.edge_n.shape
    dev = tree.n0.device
    b = torch.arange(B, device=dev)
    leaves = torch.zeros((B, V), dtype=torch.int32, device=dev)
    created = torch.zeros((B, V), dtype=torch.bool, device=dev)
    bias = torch.where(tree.root_legal, torch.zeros_like(tree.root_prior),
                       torch.full_like(tree.root_prior, float("-inf")))
    zero_b = torch.zeros(B, dtype=torch.long, device=dev)
    none_b = torch.full((B,), NONE, dtype=torch.long, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    nf = tree.next_free.long()
    for v in range(V):
        pair = _victim_pair(tree) if recycle else None

        # ---- root selection: dense PUCT over the full action space ----
        rv, rn = tree.root_virt, tree.root_n
        tot = (rn + rv).float()
        q = torch.where(tot > 0, (tree.root_w - rv.float())
                        / torch.clamp(tot, min=1.0), torch.zeros_like(tot))
        n0f = (tree.n0 + tree.virt0).float()
        u = (_c_puct(n0f, base, init)[:, None] * tree.root_prior
             * torch.sqrt(n0f)[:, None] / (1.0 + tot))
        a0 = _last_argmax(q + u + bias)
        c0 = tree.root_child[b, a0].long()
        rn_a0 = rn[b, a0]
        nv0 = (rn_a0 + rv[b, a0]).long()
        slot0, ok0, nf = _alloc(tree, c0 == NONE, nf, zero_b, pair, recycle)
        proceed0 = (c0 != NONE) | ok0
        tree.root_virt[b, a0] += proceed0.int()
        tree.virt0 += 1
        if bool(ok0.any()):
            g = torch.nonzero(ok0).flatten()
            s0 = slot0[g]
            tree.root_child[g, a0[g]] = s0.int()
            tree.parent[g, s0] = 0
            tree.parent_slot[g, s0] = NONE
            tree.expanded[g, s0] = False
            tree.parent_action[g, s0] = a0[g].int()
            if recycle:
                tree.child_count[g, 0] += 1
                tree.node_n[g, s0] = rn_a0[g]
        leaf_v = torch.where(ok0, slot0, zero_b)
        created_v = ok0.clone()
        cur = torch.where(ok0, none_b, c0)
        nv = nv0

        # ---- walk down until a leaf resolves ---------------------------
        while bool((cur != NONE).any()):
            act = cur != NONE
            ci = torch.clamp(cur, min=0)
            exp = tree.expanded[b, ci] & act
            ea = tree.edge_action[b, ci]
            ev = tree.edge_virt[b, ci]
            en = tree.edge_n[b, ci]
            tot = (en + ev).float()
            q = torch.where(tot > 0, (tree.edge_w[b, ci] - ev.float())
                            / torch.clamp(tot, min=1.0), torch.zeros_like(tot))
            npf = nv.float()
            u = (_c_puct(npf, base, init)[:, None] * tree.edge_prior[b, ci]
                 * torch.sqrt(npf)[:, None] / (1.0 + tot))
            slot = _last_argmax(torch.where(ea != NONE, q + u, neg_inf))
            child = tree.edge_child[b, ci, slot].long()
            action = ea[b, slot]
            en_s = en[b, slot]
            cnv = (en_s + ev[b, slot]).long()
            want = exp & (child == NONE)
            slot_c, ok_c, nf = _alloc(tree, want, nf, cur, pair, recycle)
            g = torch.nonzero(exp).flatten()
            tree.edge_virt[g, ci[g], slot[g]] += 1
            if bool(ok_c.any()):
                g = torch.nonzero(ok_c).flatten()
                sc = slot_c[g]
                tree.edge_child[g, ci[g], slot[g]] = sc.int()
                tree.parent[g, sc] = cur[g].int()
                tree.parent_slot[g, sc] = slot[g].int()
                tree.expanded[g, sc] = False
                tree.parent_action[g, sc] = action[g]
                if recycle:
                    tree.child_count[g, ci[g]] += 1
                    tree.node_n[g, sc] = en_s[g]
            stopping = act & (~exp | want)
            leaf_v = torch.where(stopping, torch.where(ok_c, slot_c, cur),
                                 leaf_v)
            created_v = created_v | ok_c
            cur = torch.where(stopping | ~act, none_b, child)
            nv = torch.where(stopping, nv, cnv)

        if recycle:
            tree.node_virt[b, leaf_v] += 1
        leaves[:, v] = leaf_v.int()
        created[:, v] = created_v
    tree.next_free.copy_(nf)
    return leaves, created


def _backup_plain(tree: Tree, pending: Pending, recycle: bool):
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
        if recycle:
            tree.node_virt[b, cur] -= 1

        # expansion: install the leaf's top-K prior row
        do_exp = (res == ONGOING) & (cur != 0) & ~tree.expanded[b, cur]
        if bool(do_exp.any()):
            g = torch.nonzero(do_exp).flatten()
            cg = cur[g]
            va = pending.topk_vals[g, v]
            ai = pending.topk_aidx[g, v]
            okm = va >= 0.0
            tree.edge_action[g, cg] = torch.where(okm, ai, torch.full_like(ai, NONE))
            tree.edge_child[g, cg] = NONE
            tree.edge_prior[g, cg] = torch.where(okm, va, torch.zeros_like(va))
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
            is_root_edge = active & (p == 0) & (s == NONE)
            is_edge = active & (p != NONE) & ~is_root_edge
            a = tree.parent_action[b, ci].long()
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


def backup_descend_plain(tree: Tree, pending: Pending, *, base: float,
                         init: float, recycle: bool):
    if pending.valid:
        _backup_plain(tree, pending, recycle)
    return _descend_plain(tree, pending.leaves.shape[1], base, init, recycle)


def expand_backup_plain(tree: Tree, pending: Pending, *, recycle: bool):
    _backup_plain(tree, pending, recycle)


# ---------------------------------------------------------------------------
# Wrappers: CUDA tensors launch the kernel, CPU tensors run the plain version
# ---------------------------------------------------------------------------

MAX_WAVE = 1024              # leaves whose recorded paths fit shared memory
MAX_RECYCLE_NODES = 8192     # pool nodes whose mirrors fit shared memory

_TREE_ARGS = (
    ("parent", torch.int32, "M"), ("parent_slot", torch.int32, "M"),
    ("parent_action", torch.int32, "M"), ("expanded", torch.bool, "M"),
    ("node_n", torch.int32, "M"), ("node_virt", torch.int32, "M"),
    ("child_count", torch.int32, "M"),
    ("edge_action", torch.int32, "MK"), ("edge_prior", torch.float32, "MK"),
    ("edge_child", torch.int32, "MK"), ("edge_n", torch.int32, "MK"),
    ("edge_virt", torch.int32, "MK"), ("edge_w", torch.float32, "MK"),
    ("root_prior", torch.float32, "A"), ("root_child", torch.int32, "A"),
    ("root_legal", torch.bool, "A"), ("root_n", torch.int32, "A"),
    ("root_virt", torch.int32, "A"), ("root_w", torch.float32, "A"),
    ("n0", torch.int32, ""), ("virt0", torch.int32, ""),
    ("next_free", torch.int32, ""),
)
_PENDING_ARGS = (
    ("leaves", torch.int32, "V"), ("topk_vals", torch.float32, "VK"),
    ("topk_aidx", torch.int32, "VK"), ("results", torch.int32, "V"),
    ("values", torch.float32, "V"), ("to_move", torch.int32, "V"),
)


def _check(obj, spec, dims, dev, what):
    for name, dtype, shape in spec:
        x = getattr(obj, name)
        want = (dims["B"],) + tuple(dims[c] for c in shape)
        if x.dtype != dtype or tuple(x.shape) != want:
            raise ValueError(f"{what}: {name} is {x.dtype} {tuple(x.shape)}, "
                             f"want {dtype} {want}")
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on {dev}")


def _dims(tree: Tree, V: int, recycle: bool) -> dict:
    """The kernels' dimensions; raises on a shape they do not take."""
    B, M, K = tree.edge_n.shape
    if K > 1024:
        raise ValueError(f"max_children {K} above the kernel's 1024")
    if M * K >= 2 ** 31:
        raise ValueError(f"{M} nodes x {K} children: an edge index does not "
                         "fit the 32-bit path codes of the backup")
    if not 1 <= V <= MAX_WAVE:
        raise ValueError(f"wave size {V} outside 1..{MAX_WAVE}: the backup "
                         "keeps every leaf's path in shared memory")
    if recycle and M > MAX_RECYCLE_NODES:
        raise ValueError(f"a recycling pool of {M} nodes above the kernel's "
                         f"{MAX_RECYCLE_NODES}: it mirrors the node tier in "
                         "shared memory")
    return {"B": B, "M": M, "K": K, "A": tree.root_n.shape[1], "V": V}


def _launch(entry, tree: Tree, pending: Pending, *, base, init, recycle,
            valid, descend):
    dev = tree.n0.device
    dims = _dims(tree, pending.leaves.shape[1], recycle)
    B, M, K, A, V = (dims[c] for c in "BMKAV")
    _check(tree, _TREE_ARGS, dims, dev, entry)
    _check(pending, _PENDING_ARGS, dims, dev, entry)
    leaves = torch.empty((B, V), dtype=torch.int32, device=dev)
    created = torch.empty((B, V), dtype=torch.bool, device=dev)
    lib = kb.library("tree_wave")
    args = [kb.ptr(getattr(tree, f)) for f, _, _ in _TREE_ARGS]
    args += [kb.ptr(getattr(pending, f)) for f, _, _ in _PENDING_ARGS]
    err = getattr(lib, entry)(
        B, M, K, A, V, int(recycle), base, init, int(valid), *args,
        kb.ptr(leaves), kb.ptr(created), kb.stream_ptr(dev))
    kb.check(err, entry)
    return (leaves, created) if descend else None


def backup_descend_wave(tree: Tree, pending: Pending, *, base: float,
                        init: float, recycle: bool):
    """Apply `pending` (when pending.valid), then run V descents per game;
    the tree is updated in place.  Returns (leaves [B, V] int32,
    created [B, V] bool).  With pending.valid == 0 this is the descend
    wave (counted as `descend_wave`)."""
    if tree.n0.device.type == "cpu":
        return backup_descend_plain(tree, pending, base=base, init=init,
                                    recycle=recycle)
    out = _launch("tak_backup_descend_wave", tree, pending, base=base,
                  init=init, recycle=recycle, valid=pending.valid,
                  descend=True)
    kb.LAUNCHES["backup_descend_wave" if pending.valid
                else "descend_wave"] += 1
    return out


def descend_wave(tree: Tree, wave_size: int, *, base: float, init: float,
                 recycle: bool):
    """V descents per game with nothing pending (the merged kernel at
    valid=0).  Returns (leaves, created)."""
    B, _, K = tree.edge_n.shape
    pending = Pending.zeros(B, wave_size, K, tree.n0.device)
    return backup_descend_wave(tree, pending, base=base, init=init,
                               recycle=recycle)


def expand_backup_wave(tree: Tree, pending: Pending, *, recycle: bool):
    """Install the pending leaves' edge rows and apply their V backups,
    in place (the flush after each chunk of waves)."""
    if tree.n0.device.type == "cpu":
        expand_backup_plain(tree, pending, recycle=recycle)
        return
    _launch("tak_expand_backup_wave", tree, pending, base=0.0, init=0.0,
            recycle=recycle, valid=1, descend=False)
    kb.LAUNCHES["expand_backup_wave"] += 1
