"""The whole learner step's share of the card's bf16 dense peak: three
times the forward operations of a row (forward, and the backward's data
and weight gradients) times the rows trained in the window (examples x 8
symmetries) over the traced window and the peak."""

from benchmark.reference import counts


def read(trace):
    rows = trace.counts.get("rows", 0)
    if not rows or trace.window_s <= 0:
        return None
    flops = 3 * rows * trace.extras["flops_per_row"]
    return 100.0 * flops / trace.window_s / counts.BF16_FLOPS_PER_S
