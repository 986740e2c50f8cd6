"""Host milliseconds a wave waits for the card: the blocking readbacks
(`sync` spans of `tak_tpu_torch.utils.profiling`) inside the program's
`search` spans in the traced window, over the waves they ran (the
program's count `search.waves`).  None where the program records no
spans."""

from tak_tpu_torch.utils import profiling


def read(trace):
    if not hasattr(profiling, "spans"):
        return None
    t0, t1 = trace.window
    waves = profiling.counts(t0, t1).get("search.waves", 0)
    if not waves:
        return None
    return 1e3 * profiling.sync_seconds(profiling.spans(t0, t1), "search") \
        / waves
