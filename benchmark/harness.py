"""The benchmark's general part: finding a cell's files by name, spans
around the program's calls, the window, the trace, and the result line.

A cell (`BENCHMARK.json` `workloads[i]`) names a configuration and a
traffic mix.  Everything that belongs to one of them is data, found by
name:
  * `configs/<config>.json`    the model's widths and weights file;
  * `workloads/<cell>.json`    the traffic's parameters, the driver module that
    runs them and the limits of the comparison that decides `correct`;
  * `drivers/<driver>.py`      `run(ctx) -> Outcome`;
  * `metrics/<metric>.py`      `read(trace) -> float | None`.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

from .reference import counts

HERE = Path(__file__).resolve().parent
MANIFEST = HERE.parent / "BENCHMARK.json"
SPAN_PREFIX = "bench."
# a traced run profiles the first seconds of its window only: a 30 s
# trace of the host-bound cells is 1.5-1.9 GB and takes two and a half
# minutes to read
TRACE_SECONDS = 10.0


def note(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Layout:
    """Where a cell's files are found (the benchmark's own folders; tests
    point it at copies)."""
    root: Path = HERE
    manifest: Path = MANIFEST

    def workload(self, name: str) -> dict:
        return load_json(self.root / "workloads" / f"{name}.json")

    def config(self, name: str) -> dict:
        return load_json(self.root / "configs" / f"{name}.json")

    def driver(self, name: str):
        return load_module(self.root / "drivers" / f"{name}.py",
                           f"benchmark_driver_{name}")

    def metric(self, name: str):
        return load_module(self.root / "metrics" / f"{name}.py",
                           "benchmark_metric_" + name.replace(".", "_"))


def cell_metrics(manifest: dict, cell: str):
    """(end-to-end names, per-layer names) this cell reports."""
    def here(m):
        return "workloads" not in m or cell in m["workloads"]

    return ([m["name"] for m in manifest["end_to_end"] if here(m)],
            [m["name"] for m in manifest["per_layer"] if here(m)])


class Recorder:
    """Host spans (perf_counter) around the program's calls, counters, and
    with tracing on the same spans as `torch.profiler.record_function`
    ranges, so that device kernels can be attributed to them."""

    def __init__(self, trace: bool):
        self.trace = trace
        self.spans = collections.defaultdict(list)
        self.counters = collections.Counter()

    @contextlib.contextmanager
    def span(self, name: str):
        name = SPAN_PREFIX + name
        ctx = (torch.profiler.record_function(name) if self.trace
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            yield
        self.spans[name].append((t0, time.perf_counter()))

    def count(self, name: str, by: int = 1) -> None:
        self.counters[name] += by

    def in_window(self, name: str, t0: float, t1: float):
        """The spans of `name` that lie inside [t0, t1]."""
        return [(a, b) for a, b in self.spans[SPAN_PREFIX + name]
                if a >= t0 and b <= t1]


class Stop(Exception):
    """Raised by a driver's wrapper to end the program's loop once the
    window has closed."""


class Window:
    """The measured window: opened and closed at points where the device
    has finished its queued work.  With tracing, a profiler runs over its
    first TRACE_SECONDS (to the first of the driver module's `due()` checks
    after them); the recorder's counters are copied when it stops."""

    def __init__(self, device, recorder: Recorder, seconds: float):
        self.device = device
        self.rec = recorder
        self.seconds = seconds
        self.t0 = self.t1 = None
        self.prof = None
        self.tracing = False
        self.trace_end = None
        self.traced_counts = {}
        self._range = None
        self.setup_end = None

    @property
    def open(self) -> bool:
        return self.t0 is not None and self.t1 is None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self.sync()
        self.setup_end = time.perf_counter()
        if self.rec.trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
            self._range = torch.profiler.record_function(
                SPAN_PREFIX + "window")
            self._range.__enter__()
            self.tracing = True
        self.t0 = time.perf_counter()

    def due(self) -> bool:
        """Whether the window's time is up (read without a sync); ends the
        trace once its seconds are up."""
        elapsed = time.perf_counter() - self.t0
        if self.tracing and elapsed >= TRACE_SECONDS:
            self._end_trace()
        return elapsed >= self.seconds

    def _end_trace(self):
        self.sync()
        self.trace_end = time.perf_counter()
        self.traced_counts = dict(self.rec.counters)
        self._range.__exit__(None, None, None)
        self.prof.stop()
        self.tracing = False
        note(f"profiler stopped in {time.perf_counter() - self.trace_end:.1f}"
             " s")

    def count(self, name: str, by: int = 1) -> None:
        """Count work done inside the window (the traced part's counts
        are what the per-layer readers read)."""
        if self.open:
            self.rec.count(name, by)

    def close(self):
        self.sync()
        self.t1 = time.perf_counter()
        if self.tracing:
            self._end_trace()

    @property
    def wall(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class Check:
    """One number of the comparison and its limit (correct: value <= limit)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a driver hands back once its window has closed."""
    end_to_end: dict              # metric name -> value
    attempted: int
    extras: dict                  # counts the per-layer readers take
    check: object                 # callable() -> list[Check], run last
    release: object = None        # callable(): frees the program's state
    control: object = None        # callable() -> {check: the control's value}


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's data, the device and the tools."""
    cell: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    device: torch.device
    rec: Recorder
    window: Window
    layout: Layout

    def path(self, rel: str) -> Path:
        """A file of the repository, relative to its root."""
        return self.layout.root.parent / rel


# -- the trace ---------------------------------------------------------------

@dataclasses.dataclass
class Trace:
    """What a per-layer reader reads."""
    window_s: float
    busy_s: float
    rec: Recorder
    window: tuple                  # host (start, end) of the traced part
    config: dict
    workload: dict
    extras: dict
    counts: dict                   # the window's counters over that part
    kernels: list                  # (name, start s, end s, frozenset spans)
    gaps: list                     # (seconds, label)

    def device_s(self, span: str | None = None, pred=None) -> float:
        """Device seconds of the kernels launched inside `span` (any when
        None) whose name satisfies `pred`."""
        tag = None if span is None else SPAN_PREFIX + span
        return sum(e - s for name, s, e, spans in self.kernels
                   if (tag is None or tag in spans)
                   and (pred is None or pred(name)))


def read_trace(prof, rec: Recorder, host_window, config, workload, extras,
               traced_counts):
    """Kernels with the bench spans their launches fell in, the device's
    busy seconds and idle gaps inside the `bench.window` range."""
    t0 = time.perf_counter()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        t1 = time.perf_counter()
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    note(f"trace: {size / 1e6:.0f} MB exported in {t1 - t0:.1f} s, read in "
         f"{time.perf_counter() - t1:.1f} s")
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    ranges = collections.defaultdict(list)
    launches = {}
    device = []
    host_ops = []                  # (start, end, name, thread) on the host
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        name = ev.get("name", "")
        ts, dur = float(ev.get("ts", 0)), float(ev.get("dur", 0))
        if cat in ("cpu_op", "user_annotation"):
            host_ops.append((ts, ts + dur, name, ev.get("tid")))
        if cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            ranges[name].append((ts, ts + dur))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((name, ts, ts + dur,
                           ev.get("args", {}).get("correlation")))
    for v in ranges.values():
        v.sort()
    win = ranges.get(SPAN_PREFIX + "window", [])
    if not win:
        raise RuntimeError("the trace holds no bench.window range")
    lo, hi = win[0]

    def inside(name, ts):
        # ranges of one name follow each other without overlapping
        iv = ranges[name]
        i = bisect.bisect_right(iv, (ts, float("inf"))) - 1
        return i >= 0 and iv[i][0] <= ts <= iv[i][1]

    names = [n for n in ranges if n != SPAN_PREFIX + "window"]
    kernels = []
    for name, s, e, corr in device:
        if e < lo or s > hi:
            continue
        t = launches.get(corr)
        spans = frozenset(n for n in names if t is not None and inside(n, t))
        kernels.append((name, s * 1e-6, e * 1e-6, spans))
    busy, gaps = counts.busy_union([(s, e) for _, s, e, _ in kernels],
                                   lo * 1e-6, hi * 1e-6)
    labels = _host_at(host_ops, [a * 1e6 for a, _ in gaps])
    labelled = [(b - a, f"{op} (in {_innermost(ranges, names, a * 1e6)})")
                for (a, b), op in zip(gaps, labels)]
    window_s = (hi - lo) * 1e-6
    return Trace(window_s=window_s, busy_s=busy, rec=rec,
                 window=host_window, config=config, workload=workload,
                 extras=extras, counts=traced_counts, kernels=kernels,
                 gaps=labelled)


def _host_at(host_ops, times) -> list:
    """The innermost host operation running at each time (on the thread of
    the `bench.window` range, where the host ops nest), or "idle host"."""
    window = [op for op in host_ops if op[2] == SPAN_PREFIX + "window"]
    tid = window[0][3] if window else None
    ops = sorted((op for op in host_ops if op[3] == tid),
                 key=lambda op: (op[0], -op[1]))
    out = {}
    stack, i = [], 0
    for t in sorted(times):
        while i < len(ops) and ops[i][0] <= t:
            while stack and stack[-1][1] < ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[t] = stack[-1][2] if stack else "idle host"
    return [out[t] for t in times]


def _innermost(ranges, names, t) -> str:
    best = None
    for n in names:
        iv = ranges[n]
        i = bisect.bisect_right(iv, (t, float("inf"))) - 1
        if i >= 0 and iv[i][0] <= t <= iv[i][1]:
            if best is None or iv[i][1] - iv[i][0] < best[0]:
                best = (iv[i][1] - iv[i][0], n)
    return best[1][len(SPAN_PREFIX):] if best else "window"


def breakdown(trace: Trace) -> dict:
    """The ten device operations that took most time and the idle time by
    what the host was doing: the gaps summed by the innermost host
    operation running when each began, and the innermost bench span."""
    ops = collections.defaultdict(float)
    for name, s, e, _ in trace.kernels:
        ops[name[:160]] += e - s
    idle = collections.defaultdict(float)
    for sec, label in trace.gaps:
        idle[label] += sec
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}
