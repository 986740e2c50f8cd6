"""The share of the evaluated rows whose legal top-K the kernel took:
100 x the program's count `search.legal_topk_rows` (rows handed to
`tak_tpu_torch/csrc/legal_topk.cu`) over the benchmark's count `rows`
(rows evaluated), both in the traced window.  The roots' evaluations
(`prepare_root`, a dense mask) are in `rows` and not in the kernel's.
None where the program counts no such rows."""

from tak_tpu_torch.utils import profiling


def read(trace):
    if not hasattr(profiling, "counts"):
        return None
    rows = trace.counts.get("rows", 0)
    t0, t1 = trace.window
    taken = profiling.counts(t0, t1).get("search.legal_topk_rows", 0)
    if not rows or not taken:
        return None
    return 100.0 * taken / rows
