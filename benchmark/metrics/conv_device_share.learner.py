"""The share of the learner's device busy time spent in cuDNN's
convolution kernels (forward `fprop`, backward `dgrad`/`wgrad`), by the
frozen classification of kernel names."""

from benchmark.reference import counts


def read(trace):
    busy = trace.device_s()
    if busy <= 0:
        return None
    conv = trace.device_s(pred=lambda n: counts.kernel_family(n) in (
        "conv_forward", "conv_backward"))
    return 100.0 * conv / busy
