"""Host milliseconds a self-play move spends outside `prepare_root` and
`run_sims` (win-in-one scan, reroot, move choice, examples): the window's
wall time less its `search` and `prepare_root` spans, over its moves."""


def read(trace):
    moves = trace.counts.get("moves", 0)
    if not moves:
        return None
    t0, t1 = trace.window
    inside = sum(b - a for name in ("search", "prepare_root")
                 for a, b in trace.rec.in_window(name, t0, t1))
    return 1e3 * (t1 - t0 - inside) / moves
