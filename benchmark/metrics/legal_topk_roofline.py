"""The legal top-K kernel's share of its roofline: the least time of the
rows it ran (the program's count `search.legal_topk_rows` in the traced
window; bytes by `reference/topk_counts.py` at the cell's size and K, over
3.35 TB/s) over the device time of the kernels whose name holds
`tak_legal_topk` (`tak_tpu_torch/csrc/legal_topk.cu`).  None where the
program counts no such rows or runs no such kernel."""

from benchmark.reference import topk_counts
from tak_tpu_torch.utils import profiling


def read(trace):
    if not hasattr(profiling, "counts"):
        return None
    t0, t1 = trace.window
    rows = profiling.counts(t0, t1).get("search.legal_topk_rows", 0)
    device = trace.device_s(pred=lambda name: "tak_legal_topk" in name)
    if not rows or device <= 0:
        return None
    least = topk_counts.least_seconds(rows, trace.config["board_size"],
                                      trace.workload["k"])
    return 100.0 * least / device
