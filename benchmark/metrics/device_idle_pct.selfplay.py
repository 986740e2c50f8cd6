"""The device's idle share of the traced self-play window: 1 - busy/wall,
busy the union of the device's kernel, copy and memset intervals."""


def read(trace):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
