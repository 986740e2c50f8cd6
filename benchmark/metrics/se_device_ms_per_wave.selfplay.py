"""Device milliseconds a self-play wave spends in the SE epilogue: the
kernels whose name holds `tak_se_` (`tak_tpu_torch/csrc/squeeze_excite.cu`,
one launch a block a network call) in the traced window, over the
window's waves.  None where no such kernel ran (a network without SE
blocks, or a program without the kernel)."""


def read(trace):
    waves = trace.counts.get("waves", 0)
    device = trace.device_s(pred=lambda name: "tak_se_" in name)
    if not waves or device <= 0:
        return None
    return 1e3 * device / waves
