"""Device milliseconds a training chunk spends in NCCL on rank 0's card:
the kernels whose name holds `nccl` (the all-reduces of the BatchNorms'
statistics and gradient sums, and of the step's gradients; a kernel's
time includes its wait for the other ranks) in the traced window, over
the program's count `train.chunks` there.  None where no such kernel
ran (one process, or a gloo group) or the program counts no chunks."""

from tak_tpu_torch.utils import profiling


def read(trace):
    if not hasattr(profiling, "counts"):
        return None
    device = trace.device_s(pred=lambda name: "nccl" in name.lower())
    if device <= 0:
        return None
    t0, t1 = trace.window
    chunks = profiling.counts(t0, t1).get("train.chunks", 0)
    if not chunks:
        return None
    return 1e3 * device / chunks
