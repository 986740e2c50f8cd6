"""Host milliseconds a wave spends enqueueing work: the program's own
`search` spans (`tak_tpu_torch.utils.profiling`) in the traced window
less the blocking readbacks inside them (`sync` spans), over the waves
they ran (the program's count `search.waves`).  None where the program
records no spans."""

from tak_tpu_torch.utils import profiling


def read(trace):
    if not hasattr(profiling, "spans"):
        return None
    t0, t1 = trace.window
    waves = profiling.counts(t0, t1).get("search.waves", 0)
    if not waves:
        return None
    spans = profiling.spans(t0, t1)
    inside = sum(s.end - s.start for s in spans if s.name == "search")
    return 1e3 * (inside - profiling.sync_seconds(spans, "search")) / waves
