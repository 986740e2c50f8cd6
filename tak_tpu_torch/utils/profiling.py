"""Profiling and throughput instrumentation (counterpart of
`tak_tpu/utils/profiling.py`).

`trace` records the enclosed block with `torch.profiler` (host and, on a
card, CUDA activity: every kernel launch of the port's own kernels and of
the libraries appears by its symbol name) and writes a Chrome trace
(chrome://tracing, Perfetto) into `log_dir`; `RateMeter` counts sims/s,
env-steps/s or examples/s.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str, log=print):
    """Profile the enclosed block; the Chrome trace goes to
    `log_dir/trace.json`.  Yields the `torch.profiler.profile` (its
    `key_averages()` sums time by operation and kernel)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    log(f"profiler trace written to {path}")


class RateMeter:
    """Sliding throughput counter (sims/s, env-steps/s, examples/s)."""

    def __init__(self, name: str = "items"):
        self.name = name
        self.reset()

    def reset(self):
        self.t0 = time.perf_counter()
        self.count = 0

    def add(self, n: int) -> None:
        self.count += n

    @property
    def rate(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.count / dt if dt > 0 else 0.0

    def __str__(self) -> str:
        return f"{self.rate:,.0f} {self.name}/s"
