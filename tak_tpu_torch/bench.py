"""The port's headline benchmark (counterpart of the repository's
`bench.py`): env steps/s, MCTS sims/s and self-play sims/s on one card.

    python -m tak_tpu_torch.bench [--cpu]

Prints ONE JSON line on stdout, with `bench.py`'s keys:

    {"metric": "mcts_sims_per_s_6x6", "value": N, "unit": "sims/s",
     "vs_baseline": N, "env_steps_per_s": N, "env_vs_baseline": N,
     "device": "...", "config": {...},
     "selfplay_sims_per_s": N, "selfplay_config": {...}}

`vs_baseline` is against 100,000 MCTS sims/s and `env_vs_baseline`
against 1,000,000 env steps/s, as in `bench.py`.  Progress notes, the
card's name and power limit, the kernel build and each tier's seconds go
to stderr.  The sizes come from `bench.py`'s `BENCH_*` environment
variables, with its defaults (`BenchConfig`).

The tiers, in order, each on the one device:
  1. env: `Engine.env_rollout_fn(ENV_STEPS)` on ENV_BATCH fresh games at
     half komi 4; one warm-up launch, then 8 launches (seeds 1..8) and
     one synchronization;
  2. MCTS: MCTS_BATCH roots (a1, then the far corner) searched by Net6
     (16 x 128, bf16, random weights from seed 0) with
     `SearchConfig(num_sims=MCTS_SIMS, wave_size=MCTS_WAVE,
     max_children=MCTS_K)`: at 6x6 the pool tier on 514 nodes without
     recycling.  One untimed search, then 3 timed searches on fresh trees
     allocated before the timer;
  3. self-play: `SelfPlayActor` at the reference config (SP_WORKERS
     games, SP_SIMS sims a move, wave SP_WAVE, K=32, the recycled pool),
     timed from the end of its 2nd search to the end of its
     (SP_MOVES + 2)th.

Unlike `bench.py`, a tier that fails fails the run: `BENCH_SP=0` is the
only way to leave the self-play keys out.  Runs on the CUDA device
unless `--cpu` is given (the kernels' plain versions); without a card it
raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

from .engine.core import get_engine
from .kernels import build as kb
from .mcts.search import MCTS, SearchConfig
from .model.network import Network
from .selfplay import SelfPlayActor, SelfPlayConfig
from .utils.device import (
    resolve_device,
    setup_performance_defaults,
    synchronize,
)

HALF_KOMI = 4          # the roots' and the env games' komi (bench.py)
ENV_REPS = 8           # timed env launches (bench.py:75)
MCTS_REPS = 3          # timed searches (bench.py:155)
MCTS_BASELINE = 100_000
ENV_BASELINE = 1_000_000


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """`bench.py:27-57`'s sizes; its comments give the reasons for them."""
    size: int = 6
    env_batch: int = 8192
    env_steps: int = 64
    mcts_batch: int = 512
    mcts_sims: int = 512
    mcts_wave: int = 32
    mcts_k: int = 32
    sp: bool = True
    sp_workers: int = 32
    sp_sims: int = 10_240
    sp_moves: int = 4
    sp_wave: int = 256

    @classmethod
    def from_env(cls, environ) -> "BenchConfig":
        """The defaults, overridden by each `BENCH_*` variable that is set
        (`BENCH_SP` is on when it is "1")."""
        fields = {f.name: f for f in dataclasses.fields(cls)}
        values = {name: int(environ.get(f"BENCH_{name.upper()}", f.default))
                  for name, f in fields.items() if name != "sp"}
        return cls(**values, sp=environ.get("BENCH_SP", "1") == "1")


def env_tier(engine, device, batch: int, steps: int):
    """Random legal playouts (`bench.py:60-81`): (env steps/s, the final
    states).  `bench.py` falls back to an XLA loop where its backend lacks
    the fused rollout; the port's rollout kernel takes every size 3-8, and
    on the CPU the same call runs its plain version, so there is no other
    loop."""
    rollout = engine.env_rollout_fn(steps)
    states = rollout(engine.initial_batch(batch, HALF_KOMI, device), 0)
    synchronize(device)
    t0 = time.perf_counter()
    for i in range(ENV_REPS):
        states = rollout(states, i + 1)
    synchronize(device)
    return batch * steps * ENV_REPS / (time.perf_counter() - t0), states


def mcts_roots(engine, batch: int, device):
    """`bench.py:135-139`: fresh games at half komi 4 after a1 and the far
    corner."""
    states = engine.initial_batch(batch, HALF_KOMI, device)
    dev = states.ply.device
    states = engine.step(states, torch.zeros(batch, dtype=torch.int32,
                                             device=dev))
    return engine.step(states, torch.full((batch,), engine.num_squares - 1,
                                          dtype=torch.int32, device=dev))


def mcts_config(sims: int, wave: int, k: int) -> SearchConfig:
    """The MCTS tier's search; every other field at its default."""
    return SearchConfig(num_sims=sims, wave_size=wave, max_children=k)


def mcts_tier(engine, eval_fn, params, device, batch: int = 512,
              sims: int = 512, wave: int = 32, k: int = 32):
    """Batched search throughput (`bench.py:126-164`): (sims/s, the
    MCTS_REPS + 1 searched trees, the timed ones first).  Every tree is
    allocated before the timer; the untimed search runs on the last one
    (on the card it pays cuDNN's autotuning at batch x wave rows).  A
    timed search is prepare_root + run_sims + a synchronization."""
    mcts = MCTS(engine, eval_fn, mcts_config(sims, wave, k))
    roots = mcts_roots(engine, batch, device)
    trees = [mcts.init_batch(roots) for _ in range(MCTS_REPS + 1)]

    def run(tree):
        mcts.run_sims(params, mcts.prepare_root(params, tree))
        synchronize(device)

    run(trees[-1])
    t0 = time.perf_counter()
    for tree in trees[:MCTS_REPS]:
        run(tree)
    sec = time.perf_counter() - t0
    cfg = mcts.config
    return batch * cfg.num_waves * cfg.wave_size * MCTS_REPS / sec, trees


class _Stop(Exception):
    """Ends the self-play run once the timed window is over."""


def selfplay_tier(engine, eval_fn, params, device, workers: int = 32,
                  sims: int = 10_240, moves: int = 4, wave: int = 256):
    """Whole self-play moves at the reference config (`bench.py:167-215`):
    sims/s over `moves` searches.  The clock starts when the 2nd search
    ends (move 1 pays cuDNN's autotuning) and stops when search
    `moves + 2` ends; each search is followed by a synchronization."""
    cfg = SelfPlayConfig(
        games=10_000_000,   # stopped by the search count below
        workers=workers,
        search=SearchConfig(num_sims=sims, wave_size=wave, max_children=32,
                            recycle=True))
    actor = SelfPlayActor(engine, eval_fn, cfg, device=device)
    search = actor.mcts.run_sims
    clock = {"searches": 0}

    def timed_search(p, tree):
        out = search(p, tree)
        synchronize(device)
        clock["searches"] += 1
        if clock["searches"] == 2:
            clock["start"] = time.perf_counter()
        if clock["searches"] >= moves + 2:
            clock["end"] = time.perf_counter()
            raise _Stop
        return out

    actor.mcts.run_sims = timed_search
    try:
        actor.run(params, seed=0, log=lambda *a, **k: None)
    except _Stop:
        pass
    else:
        raise RuntimeError(f"self-play ended after {clock['searches']} "
                           f"searches, before search {moves + 2}")
    return workers * sims * moves / (clock["end"] - clock["start"])


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
    if out.returncode != 0 or not lines:
        return f"nvidia-smi exited {out.returncode}: {out.stderr.strip()}"
    return lines[0]


def result_line(cfg: BenchConfig, device, env_rate: float, mcts_rate: float,
                sp_rate) -> dict:
    """`bench.py:248-259`'s line; the self-play keys only with a rate."""
    n = cfg.size
    line = {
        "metric": f"mcts_sims_per_s_{n}x{n}",
        "value": round(mcts_rate),
        "unit": "sims/s",
        "vs_baseline": round(mcts_rate / MCTS_BASELINE, 3),
        "env_steps_per_s": round(env_rate),
        "env_vs_baseline": round(env_rate / ENV_BASELINE, 3),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "config": {"env_batch": cfg.env_batch, "mcts_batch": cfg.mcts_batch,
                   "mcts_sims": cfg.mcts_sims, "wave": cfg.mcts_wave,
                   "k": cfg.mcts_k},
    }
    if sp_rate is not None:
        line["selfplay_sims_per_s"] = round(sp_rate)
        line["selfplay_config"] = {
            "workers": cfg.sp_workers, "rollouts": cfg.sp_sims,
            "recycle": True, "wave": cfg.sp_wave}
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m tak_tpu_torch.bench", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions) "
                         "instead of the CUDA device")
    args = ap.parse_args(argv)
    cfg = BenchConfig.from_env(os.environ)
    device = resolve_device("cpu" if args.cpu else None)
    setup_performance_defaults(device)

    def note(msg):  # progress on stderr; stdout stays the one JSON line
        print(f"[bench] {msg}", file=sys.stderr, flush=True)

    note(f"config {cfg}")
    if device.type == "cuda":
        note(f"card: {card_line()}")
        # outside every timer: the kernels otherwise build at first use
        note(f"kernels built in {kb.build():.1f} s")
    engine = get_engine(cfg.size)
    network = Network(engine, device=device)
    params = network.init_variables(0)
    eval_fn = network.policy_eval_states

    t0 = time.perf_counter()
    note("env tier starting")
    env_rate, _ = env_tier(engine, device, cfg.env_batch, cfg.env_steps)
    note(f"env tier done at {time.perf_counter() - t0:.1f} s: "
         f"{env_rate:,.0f} env steps/s over {ENV_REPS} launches; "
         "MCTS tier starting")
    mcts_rate, trees = mcts_tier(engine, eval_fn, params, device,
                                 cfg.mcts_batch, cfg.mcts_sims,
                                 cfg.mcts_wave, cfg.mcts_k)
    del trees  # about 2 GB on the card at the defaults
    note(f"MCTS tier done at {time.perf_counter() - t0:.1f} s: "
         f"{mcts_rate:,.0f} sims/s over {MCTS_REPS} searches")
    sp_rate = None
    if cfg.sp:
        note("self-play tier starting")
        sp_rate = selfplay_tier(engine, eval_fn, params, device,
                                cfg.sp_workers, cfg.sp_sims, cfg.sp_moves,
                                cfg.sp_wave)
        note(f"self-play tier done at {time.perf_counter() - t0:.1f} s: "
             f"{sp_rate:,.0f} sims/s over {cfg.sp_moves} moves")
    print(json.dumps(result_line(cfg, device, env_rate, mcts_rate, sp_rate)),
          flush=True)


if __name__ == "__main__":
    main()
