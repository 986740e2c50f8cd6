"""The SE epilogue's share of its roofline: the least time of the rows it
ran (the program's count `network.se_rows`, rows x SE blocks, in the
traced window; bytes and operations by `reference/se_counts.py`, over
3.35 TB/s and 67 TOP/s) over the device time of the kernels whose name
holds `tak_se_`.  None where the program counts no SE rows or runs no
such kernel."""

from benchmark.reference import se_counts
from tak_tpu_torch.utils import profiling


def read(trace):
    if not hasattr(profiling, "counts"):
        return None
    t0, t1 = trace.window
    rows = profiling.counts(t0, t1).get("network.se_rows", 0)
    device = trace.device_s(pred=lambda name: "tak_se_" in name)
    c = trace.config
    if not rows or device <= 0 or not c.get("se_channels"):
        return None
    least = se_counts.least_seconds(rows, c["board_size"], c["filters"],
                                    c["se_channels"])
    return 100.0 * least / device
