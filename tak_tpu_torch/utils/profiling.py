"""Tracing of the port (counterpart of `tak_tpu/utils/profiling.py`).

`span(name)` and `count(name, n)` mark the program's stages where the
work happens: the self-play move loop, the search's waves, the network's
evaluation (and `network.se_rows`, its rows times its SE blocks),
`Network.train`'s chunks and steps, and the data-parallel all-reduces
(`mesh.all_reduce`).  They record only
while a `torch.profiler` records on the calling thread; otherwise a span
is one flag test that returns a shared no-op context, and a count does
nothing.  While recording:

  * a span enters `torch.profiler.record_function("tak." + name)`, so it
    sits on the device trace's clock beside the kernels it launches, and
    keeps (id, name, start, end, parent id, sync) on `time.perf_counter`;
  * `sync=n` marks a span that wraps n blocking copies (readbacks to the
    host, and copies from pageable host memory, which wait for the card's
    queue): its duration is time the host waited for the card, and n is
    added to the count `sync`;
  * a count keeps its name, its host time and n.

The record is one buffer of the process, like the profiler's own state:
`spans(t0, t1)` and `counts(t0, t1)` read what lies inside [t0, t1],
`self_times` and `sync_seconds` do the arithmetic, `clear()` empties it.
Spans never synchronise, touch device memory or allocate tensors.

`trace(log_dir)` is the operator's entry point: it records the enclosed
block with `torch.profiler` (host and, on a card, CUDA activity), writes
the Chrome trace (chrome://tracing, Perfetto) and the spans, counts and
`kernels.build.LAUNCHES` beside it, and logs a table by `tak.` range.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch

PREFIX = "tak."

# True exactly while a torch.profiler records on the calling thread
_recording = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    id: int
    name: str
    start: float            # time.perf_counter seconds
    end: float
    parent: int | None      # id of the enclosing recorded span
    sync: int               # blocking copies it wraps (0: none)


_spans: list[Span] = []
_counts: list[tuple[str, float, int]] = []     # (name, host time, n)
_ids = itertools.count()
_local = threading.local()                     # .stack: open span ids


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "sync", "id", "parent", "start", "range")

    def __init__(self, name: str, sync: int):
        self.name = name
        self.sync = int(sync)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.start = time.perf_counter()
        self.range.__enter__()
        return None

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        end = time.perf_counter()
        _local.stack.pop()
        _spans.append(Span(self.id, self.name, self.start, end, self.parent,
                           self.sync))
        if self.sync:
            _counts.append(("sync", end, self.sync))
        return False


def span(name: str, sync: int = 0):
    """A context marking one stage `name`; `sync` = the blocking copies
    it wraps (True: one)."""
    if not _recording():
        return _OFF
    return _On(name, sync)


def count(name: str, n: int = 1) -> None:
    if _recording():
        _counts.append((name, time.perf_counter(), n))


def clear() -> None:
    _spans.clear()
    _counts.clear()


def spans(t0: float = float("-inf"), t1: float = float("inf")) -> list:
    """The recorded spans that lie inside [t0, t1], by start time."""
    return sorted((s for s in _spans if s.start >= t0 and s.end <= t1),
                  key=lambda s: s.start)


def counts(t0: float = float("-inf"), t1: float = float("inf")) -> dict:
    """Name -> the sum of the counts made inside [t0, t1]."""
    out = collections.Counter()
    for name, t, n in _counts:
        if t0 <= t <= t1:
            out[name] += n
    return dict(out)


def self_times(items) -> dict:
    """Span id -> its duration less what its children among `items`
    cover (children run one after another on the span's thread)."""
    out = {s.id: s.end - s.start for s in items}
    for s in items:
        if s.parent in out:
            out[s.parent] -= s.end - s.start
    return out


def sync_seconds(items, under: str) -> float:
    """Seconds of the outermost `sync` spans among `items` that lie inside
    a span named `under`."""
    by_id = {s.id: s for s in items}

    def ancestors(s):
        while s.parent in by_id:
            s = by_id[s.parent]
            yield s

    total = 0.0
    for s in items:
        if not s.sync:
            continue
        up = list(ancestors(s))
        if any(a.name == under for a in up) and not any(a.sync for a in up):
            total += s.end - s.start
    return total


def _device_ms(path: str) -> dict:
    """`tak.` range -> device ms of the kernels, copies and memsets whose
    launch falls inside it (its children's included), from the Chrome
    trace at `path`.  By time, on any thread: the backward's kernels,
    launched from autograd's own thread while the range waits, count in
    it, as do the port's own kernels, which no PyTorch operation wraps."""
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    ranges = collections.defaultdict(list)
    launches, device = {}, []                   # correlation -> launch
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev.get("ts", 0)), float(ev.get("dur", 0))
        corr = ev.get("args", {}).get("correlation")
        if cat == "user_annotation" and name.startswith(PREFIX):
            ranges[name[len(PREFIX):]].append((ts, ts + dur))
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launches[corr] = ts
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((corr, dur))
    launched = [(launches[c], dur) for c, dur in device if c in launches]
    out = {}
    for name, iv in ranges.items():
        iv.sort()
        starts = [a for a, _ in iv]
        us = 0.0
        for t, dur in launched:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= iv[i][1]:
                us += dur
        out[name] = us / 1e3
    return out


def table(device_ms=None) -> str:
    """Calls, host self ms and (given `device_ms`, by range) device ms by
    `tak.` range of the record."""
    items = spans()
    selfs = self_times(items)
    calls, host = collections.Counter(), collections.Counter()
    for s in items:
        calls[s.name] += 1
        host[s.name] += selfs[s.id] * 1e3
    dev = device_ms or {}
    width = max([len(n) for n in calls] + [5])
    lines = [f"{'range':<{width}}  {'calls':>7}  {'host self ms':>12}  "
             f"{'device ms':>10}"]
    for name in sorted(calls):
        d = dev.get(name)
        d = f"{d:>10.3f}" if d is not None else f"{'-':>10}"
        lines.append(f"{name:<{width}}  {calls[name]:>7}  "
                     f"{host[name]:>12.3f}  {d}")
    c = counts()
    if c:
        lines.append("counts: " + ", ".join(f"{k} {v}"
                                            for k, v in sorted(c.items())))
    return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str, log=print):
    """Profile the enclosed block; the Chrome trace goes to
    `log_dir/trace.json`, the spans, counts and kernel launches to
    `log_dir/spans.json`, and `log` gets the table by `tak.` range.
    Yields the `torch.profiler.profile` (its `key_averages()` sums time
    by operation and kernel)."""
    from torch.profiler import ProfilerActivity, profile

    from ..kernels import build as kb

    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if card:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear()
    with profile(activities=activities) as prof:
        yield prof
        if card:
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump({"spans": [s._asdict() for s in spans()],
                   "counts": counts(), "launches": dict(kb.LAUNCHES)}, f)
    dev = _device_ms(path) if card else None
    log(f"profiler trace written to {path}; by range (device ms include "
        f"the ranges inside):\n{table(dev)}")
