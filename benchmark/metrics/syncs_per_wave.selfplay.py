"""Blocking copies between host and card a wave: the program's count
`sync` (every readback, and every copy from pageable host memory, of
the move loop and the search; `tak_tpu_torch.utils.profiling`) in the
traced window over its count `search.waves`.  None where the program
records no counts."""

from tak_tpu_torch.utils import profiling


def read(trace):
    if not hasattr(profiling, "counts"):
        return None
    t0, t1 = trace.window
    got = profiling.counts(t0, t1)
    waves = got.get("search.waves", 0)
    if not waves:
        return None
    return got.get("sync", 0) / waves
