"""What the profiling harnesses (`profile_*.py`, `diag_bn_mismatch.py`)
share: the `--cpu` flag and the device, the knobs and the timers.  Their
roots are `bench.mcts_roots`: fresh games at half komi 4 after a1 and the
far corner, as every `tools/profile_*.py` makes them.

Every JAX script under the repository's `tools/` copies one `timeit`: a
warm call, then `reps` calls back to back on the host clock up to one
readback.  The port's `timeit` times each call on its own instead: on the
card with CUDA events around the call, behind a spin of the card long
enough for the host to queue the call's launches (`span`, which
`chip_smoke.py`'s `cuda_ms` also times with); on the CPU with
`perf_counter`.  Its optional `setup` runs
before each call, outside the span.  The port's tree kernels write the
tree in place, where the JAX ones return a new tree, so every timed call
of a kernel, a wave or a search gets a fresh copy of its tree from
`setup`: twenty calls on one tree would time twenty different trees, the
virtual marks piling up and the pool filling.

Knobs are read from the `env` mapping that `main(argv, env)` receives
(`os.environ` by default), never when a module is imported.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..kernels import build as kb
from ..utils.device import (
    resolve_device,
    setup_performance_defaults,
    synchronize,
)

SPIN_CYCLES = 1_000_000    # about half a millisecond of the card


def knob(env, name: str, default: int) -> int:
    """The integer knob `name` of `env`, or `default` when it is unset."""
    return int(env.get(name, default))


def flag(env, name: str, default: str = "0") -> bool:
    """A knob that is on when it reads "1"."""
    return env.get(name, default) == "1"


def parser(prog: str, doc: str) -> argparse.ArgumentParser:
    """An argument parser with the harnesses' one flag, `--cpu`."""
    ap = argparse.ArgumentParser(
        prog=f"python -m tak_tpu_torch.tools.{prog}", description=doc,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions) "
                         "instead of the CUDA device")
    return ap


def open_device(cpu: bool) -> torch.device:
    """The CUDA device, or the CPU with `cpu`; on the card cuDNN's
    autotuning is on and the kernels are built before any timer starts.
    Without a card and without `cpu` it raises."""
    device = resolve_device("cpu" if cpu else None)
    setup_performance_defaults(device)
    if device.type == "cuda":
        kb.build()
    return device


def clock(fn, device, setup=None):
    """(fn(*setup()), host seconds of the call up to a synchronization);
    `setup` runs before the clock starts."""
    args = setup() if setup is not None else ()
    synchronize(device)
    t0 = time.perf_counter()
    out = fn(*args)
    synchronize(device)
    return out, time.perf_counter() - t0


def span(fn, device, setup=None, args=(), spin: int = SPIN_CYCLES):
    """(fn(*setup()) or fn(*args), seconds of the call alone): the host
    clock on the CPU; on the card CUDA events around the call, behind a
    spin of `spin` cycles, so that the host has queued the call before the
    card reaches it and the span holds the card's work, not the host's
    way to the launch."""
    if setup is not None:
        args = setup()
    if device.type != "cuda":
        return clock(fn, device, lambda: args)
    synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin)
    start.record()
    out = fn(*args)
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3


def timeit(name: str, fn, device, *args, setup=None, reps: int = 20,
           width: int = 30):
    """One warm call, then the mean time of `reps` calls of fn(*args), or
    of fn(*setup()) with a fresh `setup()` before each, each call timed
    alone (`span`).  Prints `name` padded to `width` and the milliseconds,
    as the JAX scripts do.  Returns (the last output, mean seconds)."""
    out, _ = span(fn, device, setup, args)
    total = 0.0
    for _ in range(reps):
        out, dt = span(fn, device, setup, args)
        total += dt
    dt = total / reps
    print(f"{name:{width}s} {dt * 1e3:8.2f} ms", flush=True)
    return out, dt
