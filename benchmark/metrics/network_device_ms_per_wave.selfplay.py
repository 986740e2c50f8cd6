"""Device milliseconds a wave spends in the network: the kernels launched
inside the `eval` spans that lie in `search` spans, over the waves."""


def read(trace):
    waves = trace.counts.get("waves", 0)
    if not waves:
        return None
    sec = sum(e - s for _, s, e, spans in trace.kernels
              if "bench.eval" in spans and "bench.search" in spans)
    return 1e3 * sec / waves if sec > 0 else None
