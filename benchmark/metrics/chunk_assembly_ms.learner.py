"""Host milliseconds a training chunk spends being assembled: the
program's `train.assemble` spans (`Network._chunk_arrays`: the host
gather and the copies to the card, `tak_tpu_torch.utils.profiling`) in
the traced window, over the program's count `train.chunks`.  None where
the program records no spans."""

from tak_tpu_torch.utils import profiling


def read(trace):
    if not hasattr(profiling, "spans"):
        return None
    t0, t1 = trace.window
    chunks = profiling.counts(t0, t1).get("train.chunks", 0)
    if not chunks:
        return None
    spent = sum(s.end - s.start for s in profiling.spans(t0, t1)
                if s.name == "train.assemble")
    return 1e3 * spent / chunks
