"""The share of the learner's chunks whose model forward and backward
both replayed as CUDA graphs: 100 x the program's count
`train.graph_replays` over its count `train.chunks` in the traced window
(`tak_tpu_torch/model/train_graph.py`, `tak_tpu_torch.utils.profiling`).
None where the program counts no chunks, or has no graphed chunk."""

import importlib.util

from tak_tpu_torch.utils import profiling


def read(trace):
    if (not hasattr(profiling, "counts") or importlib.util.find_spec(
            "tak_tpu_torch.model.train_graph") is None):
        return None
    t0, t1 = trace.window
    counted = profiling.counts(t0, t1)
    chunks = counted.get("train.chunks", 0)
    if not chunks:
        return None
    return 100.0 * counted.get("train.graph_replays", 0) / chunks
