"""Host milliseconds of `MCTS.run_sims` per wave: the `search` spans'
wall time in the window over the waves they ran."""


def read(trace):
    waves = trace.counts.get("waves", 0)
    if not waves:
        return None
    t0, t1 = trace.window
    return 1e3 * sum(b - a for a, b in trace.rec.in_window("search", t0, t1)) \
        / waves
