"""Device milliseconds a training chunk spends in train-mode BatchNorm:
the kernels whose name holds `tak_bn_` (`tak_tpu_torch/csrc/batch_norm.cu`:
statistics, finalize, normalize; gradient sums, finalize, input gradient)
in the traced window, over the program's count `train.chunks` there
(`tak_tpu_torch.utils.profiling`).  None where no such kernel ran (a
program whose BatchNorm is torch ops) or the program counts no chunks."""

from tak_tpu_torch.utils import profiling


def read(trace):
    if not hasattr(profiling, "counts"):
        return None
    device = trace.device_s(pred=lambda name: "tak_bn_" in name)
    if device <= 0:
        return None
    t0, t1 = trace.window
    chunks = profiling.counts(t0, t1).get("train.chunks", 0)
    if not chunks:
        return None
    return 1e3 * device / chunks
