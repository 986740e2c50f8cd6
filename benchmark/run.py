"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for (`BENCHMARK.json`).  Notes go to stderr; the last line of stdout
is one JSON object: `correct`, `attempted`, `failed`, `metrics`, `device`,
with `--trace 1` also `breakdown`, and last `checks`, each number the
comparison held beside its limit (also the last lines of stderr).  With
`--trace 0` the metrics are the cell's end-to-end metrics, with
`--trace 1` its per-layer ones, read from a torch.profiler trace of the
window.

It exits non-zero without a result when no CUDA card (or too few) is
there, when the program cannot be imported, and when `jax`, `jaxlib`,
`flax` or `tak_tpu` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tak_tpu")
CHECKOUT = Path(__file__).resolve().parent.parent


def note(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else \
        f"nvidia-smi exited {out.returncode}"


def environment() -> None:
    """Fixed build and kernel cache directories inside the checkout, and
    one host thread for the math libraries, so that a run's host work is
    one process's one thread (set before torch is imported)."""
    base = CHECKOUT / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(base / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def run_cell(layout, manifest: dict, cell: str, seed: int, seconds: float,
             trace: bool, device, t_start: float = T_START,
             card: str = "", control: bool = False) -> tuple:
    """Run the cell once on `device`: (result line dict, [Check]).  With
    `control`, the line also holds the control's readings of the same
    numbers (`calibrate.py`; a run of the benchmark never computes it)."""
    import torch

    from . import harness as h

    entry = next(w for w in manifest["workloads"] if w["name"] == cell)
    workload = layout.workload(cell)
    config = layout.config(entry["config"])
    driver = layout.driver(workload["driver"])
    e2e_names, layer_names = h.cell_metrics(manifest, cell)
    units = {m["name"]: m["unit"]
             for m in manifest["end_to_end"] + manifest["per_layer"]}

    if device.type == "cuda":
        from tak_tpu_torch.kernels import build as kb
        from tak_tpu_torch.utils.device import setup_performance_defaults

        note(f"kernels built in {kb.build():.1f} s")
        setup_performance_defaults(device)
    rec = h.Recorder(trace)
    window = h.Window(device, rec, seconds)
    ctx = h.Context(cell=cell, workload=workload, config=config, seed=seed,
                    seconds=seconds, device=device, rec=rec, window=window,
                    layout=layout)
    out = driver.run(ctx)
    setup_s = window.setup_end - t_start
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded after the window: {', '.join(found)}")
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)}
    if card:
        dev["card"] = card
    metrics = {}
    line = {}
    if trace:
        tr = h.read_trace(window.prof, rec, (window.t0, window.trace_end),
                          config, workload, out.extras, window.traced_counts)
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        for name in layer_names:
            value = layout.metric(name).read(tr)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
        line["breakdown"] = h.breakdown(tr)
        window.prof = None
        note(f"trace read {time.perf_counter() - window.t1:.1f} s after the "
             "window")
    else:
        values = dict(out.end_to_end, setup_s=setup_s)
        for name in e2e_names:
            metrics[name] = {"value": values[name], "unit": units[name]}
    if out.release is not None:
        out.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = out.check()
    failed = sum(not c.ok for c in checks)
    result = {"correct": failed == 0 and bool(checks),
              "attempted": out.attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    result.update(line)
    if control:
        result["control"] = out.control()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()

    import torch

    from . import harness as h

    manifest = h.load_json(h.MANIFEST)
    entry = [w for w in manifest["workloads"] if w["name"] == args.workload]
    if not entry:
        note(f"no cell {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available():
        note("torch.cuda.is_available() is False: no card, no result")
        return 3
    if torch.cuda.device_count() < entry[0]["chips"]:
        note(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
             f"{entry[0]['chips']}: no result")
        return 3
    card = card_line()
    note(f"card: {card}; cell {args.workload}, seed {args.seed}, "
         f"{args.seconds} s, trace {args.trace}")
    result, checks = run_cell(h.Layout(), manifest, args.workload, args.seed,
                              args.seconds, bool(args.trace),
                              torch.device("cuda"), card=card)
    for c in checks:
        note(f"check {c.name} {c.value!r} limit {c.limit!r} "
             f"{'ok' if c.ok else 'FAILED'}")
    found = forbidden_modules()
    if found:
        note(f"loaded by the end of the run: {', '.join(found)}")
        return 4
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
