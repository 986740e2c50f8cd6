"""The yardstick's arithmetic: peaks, operation and byte counts, and the
classification of device kernels, frozen here so that a change to the
program cannot move it.

Copies, each named by its origin in `chip_smoke.py`:
  * `forward_flops_per_row`            <- `forward_flops_per_row`
  * `tree_bytes`, `tree_ops`, `bound`  <- `tree_bytes`, `tree_ops`, `bound`
  * `hbm_wave_work`                    <- `hbm_wave_work` (the large tier),
    with one change: an expand+backup's levels are the visit-count
    entries it changed, not the summed change of those counts, which
    goes below 0 where a wave's backups lower counts that its descents
    raised (seen on the Player's reused trees) and made the bound
    negative
  * `kernel_family`                    <- `profile_learner_step.family`
  * `busy_union`                       <- `device_profile`'s busy/idle
    arithmetic, done on the trace's device intervals (a union, so that
    overlapping streams count once) instead of summed per-name totals.
The peaks are NVIDIA's data sheet for the H100 SXM (dense, 700 W).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # bf16 dense, tensor cores


def forward_flops_per_row(n: int, filters: int, blocks: int,
                          in_channels: int, move_channels: int) -> int:
    """Operations of one forward row: the 3x3 convolutions and the value
    Linear (2 per multiply-add)."""
    f = filters
    pairs = ([(in_channels, f)] + [(f, f)] * (2 * blocks)
             + [(f, move_channels)])
    return sum(2 * 9 * n * n * ci * co for ci, co in pairs) + 2 * f * n * n


def tree_bytes(before, after, V, descend: bool, backup: bool):
    """Least bytes a pool-tier wave must move, from this run's data: the
    root tier read once per launch when descending, the root entries the
    wave changed, the node tier, the edge rows the wave changed (read and
    written), the pending inputs and the outputs.  `before`/`after` hold
    the tree's tensors by field name."""
    import torch

    B, M, Kk = before["edge_n"].shape
    A = before["root_n"].shape[1]
    total = 0
    if descend:
        total += B * A * (4 + 1 + 4 + 4 + 4 + 4)   # prior legal n virt w child
        total += B * V * (4 + 1)                   # leaves, created
        total += 2 * B * M * (4 * 6 + 1)           # node tier read + written
    changed_root = torch.zeros_like(before["root_n"], dtype=torch.bool)
    for f in ("root_n", "root_virt", "root_w", "root_child"):
        changed_root |= before[f] != after[f]
    total += int(changed_root.sum()) * 4 * 4 * 2
    rows = torch.zeros_like(before["edge_n"][..., 0], dtype=torch.bool)
    for f in ("edge_action", "edge_prior", "edge_child", "edge_n",
              "edge_virt", "edge_w"):
        rows |= (before[f] != after[f]).any(-1)
    total += int(rows.sum()) * Kk * 4 * 6 * 2
    if backup:
        total += B * V * (4 * 5 + Kk * 8)          # pending rows
    return total


TREE_BYTES_FIELDS = ("root_n", "root_virt", "root_w", "root_child",
                     "edge_action", "edge_prior", "edge_child", "edge_n",
                     "edge_virt", "edge_w")


def tree_ops(B, V, A, M, descend: bool, recycle: bool = True):
    """Operations of a pool-tier wave's descents: the root PUCT score
    (about 10 operations per action) and, when recycling, the victim scans
    (about 5 per node, twice) per descent; the walk and backups are
    negligible."""
    if not descend:
        return B * V * 64
    return B * V * (10 * A + (10 * M if recycle else 0))


def bound(nbytes, ops):
    """(least seconds, "bytes" | "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


HBM_FIELDS = ("edge_virt", "edge_child", "edge_n", "parent", "parent_slot",
              "parent_action", "root_virt", "root_child", "root_n",
              "expanded")


def hbm_wave_work(before, after, V, descend: bool):
    """(bytes, operations) a large-tier wave must move and do, from this
    run's data.  Descend: 17 B per root action read once and the chosen
    action's child entry per descent; the five K-wide rows the pick reads
    of every node the walks passed, and per level the chosen slot's child
    entry and its mark; the root marks and the links of created nodes
    written; the outputs.  About 10 operations per root action and per
    edge slot scored.  Expand+backup: the pending inputs, the installed
    rows, and three read-modify-writes plus the node links per level
    walked."""
    B, M, Kk = before["edge_n"].shape
    A = before["root_n"].shape[1]

    def diff(*fields):
        out = None
        for f in fields:
            d = before[f] != after[f]
            out = d if out is None else out | d
        return out

    if descend:
        levels = int((after["edge_virt"] - before["edge_virt"]).sum())
        rows = int(diff("edge_virt", "edge_child").any(-1).sum())
        created = int(diff("parent", "parent_slot", "parent_action").sum())
        root_marks = int(diff("root_virt", "root_child").sum())
        nbytes = (B * A * (4 + 1 + 4 + 4 + 4) + B * V * 4 + root_marks * 8
                  + rows * (Kk * 4 * 5 + 1) + levels * (4 + 4)
                  + created * (4 + 12) + B * V * (4 + 1))
        return nbytes, B * V * 10 * A + levels * 10 * Kk
    installed = int(diff("expanded").sum())
    levels = int(diff("edge_n").sum() + diff("root_n").sum())
    nbytes = (B * V * 4 * 5 + installed * Kk * (8 + 4 * 6)
              + levels * (12 * 2 + 12))
    return nbytes, B * V * 16 + levels * 8 + installed * Kk * 2


def kernel_family(name: str) -> str:
    """A device kernel's family, from cuDNN's and PyTorch's names."""
    name = name.lower()
    if "fprop" in name:
        return "conv_forward"
    if "dgrad" in name or "wgrad" in name:
        return "conv_backward"
    if any(w in name for w in ("conv", "xmma", "cudnn", "gemm", "cutlass",
                               "implicit", "winograd")):
        return "conv_other"
    if "multi_tensor" in name:
        return "adam"
    return "other"


def busy_union(intervals, lo: float, hi: float):
    """(busy seconds, [(gap start, gap end), ...]) of device intervals
    [(start, end), ...] in seconds, clipped to [lo, hi]."""
    busy = 0.0
    gaps = []
    cur = lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps
