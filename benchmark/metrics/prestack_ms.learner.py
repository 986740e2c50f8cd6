"""Host milliseconds of the prestack (`Network._prestack`: the epoch's
examples stacked into arrays) a `Network.train` call: the program's
`train.prestack` spans (`tak_tpu_torch.utils.profiling`) in the traced
window, over their number (one a call).  None where the program records
no spans."""

from tak_tpu_torch.utils import profiling


def read(trace):
    if not hasattr(profiling, "spans"):
        return None
    t0, t1 = trace.window
    spans = [s for s in profiling.spans(t0, t1) if s.name == "train.prestack"]
    if not spans:
        return None
    return 1e3 * sum(s.end - s.start for s in spans) / len(spans)
