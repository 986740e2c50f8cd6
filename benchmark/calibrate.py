"""Readings for the limits of `correct`: the program's and the control's.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--trace 0|1]

runs the cell once per seed in one process (set-up paid per seed, the
kernel build and cuDNN's choices once) and prints one JSON line per seed
with its result line, where `control` holds the same numbers with the
plain reference in the precision below the configuration's (float8 e4m3
for bfloat16) in the program's place, on the same inputs.  The limits in
`workloads/<cell>.json` lie between the program's largest reading and the
control's smallest.  Needs a CUDA card, as `run.py`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    from . import harness as h
    from . import run

    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    run.environment()

    import torch

    if not torch.cuda.is_available():
        run.note("torch.cuda.is_available() is False")
        return 3
    manifest = h.load_json(h.MANIFEST)
    card = run.card_line()
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result, _ = run.run_cell(h.Layout(), manifest, args.workload, seed,
                                 args.seconds, bool(args.trace),
                                 torch.device("cuda"), t_start=t0, card=card,
                                 control=True)
        result["seed"] = seed
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
