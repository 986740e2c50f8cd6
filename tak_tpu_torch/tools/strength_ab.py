"""Head-to-head strength A/B between two SEARCH configurations
(counterpart of `tools/strength_ab.py`).

The strength guardrail for search changes (node recycling, wave size,
the top-K and leaf-legal options) at deep sim budgets, where root-policy
TV is meaningless (`quality_control`): what matters is whether the
changed search WINS GAMES at the same budget, measured with
paired-opening pit games, the same net on both sides, a SearchConfig per
side (`pit.PitConfig.search_b`).

    python -m tak_tpu_torch.tools.strength_ab --preset recycle --games 32 \\
        --sims 2000 --model runs/train6_r4/_models/1787285471.model [--cpu]

Sequential mode (--sprt): rounds of `--games` paired games at fresh seeds
accumulate until an SPRT on decisive games decides between H0: p = --p0
(A meaningfully weaker) and H1: p = --p1, or --max-games is reached;
every round also reports the Wilson 95% CI on the decisive win rate.
`--subprocess-rounds` runs each round in a fresh child process (same
flags, round-indexed seed) and adds up their JSON lines, printing each
child's peak resident memory.

Presets:
    recycle   A = recycled 1280-node pool (pool tier)  vs B = large-tree
              tier, K=128, budget 2*sims+2
    wave      A = wave 32 (recycled)             vs B = wave 16 (recycled)
    waves     A = --wave-a (recycled)            vs B = --wave-b (recycled)
    wave1     A = wave 16 (recycled)             vs B = wave 1 (recycled);
              NB ~16x slower for side B

Runs on the CUDA device unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

from ..mcts.search import SearchConfig

PRESETS = ("recycle", "wave", "wave1", "waves")


def wilson_ci(wins: int, n: int, z: float = 1.96):
    """95% Wilson score interval on a binomial proportion."""
    if n == 0:
        return 0.0, 1.0
    p = wins / n
    den = 1.0 + z * z / n
    center = (p + z * z / (2 * n)) / den
    half = (z / den) * ((p * (1 - p) / n + z * z / (4 * n * n)) ** 0.5)
    return max(0.0, center - half), min(1.0, center + half)


def sprt_llr(wins: int, losses: int, p0: float, p1: float) -> float:
    """Log-likelihood ratio of H1 (p=p1) vs H0 (p=p0) on decisive games
    (Bernoulli SPRT; draws carry no information under this model)."""
    return (wins * math.log(p1 / p0)
            + losses * math.log((1 - p1) / (1 - p0)))


def sprt_bounds(alpha: float, beta: float):
    """(accept-H1 bound, accept-H0 bound) of the LLR."""
    return math.log((1 - beta) / alpha), math.log(beta / (1 - alpha))


def preset_configs(preset: str, sims: int, sims_b: int, budget: int,
                   wave_a: int = 32, wave_b: int = 16):
    """(side A's SearchConfig, side B's) of a preset
    (`tools/strength_ab.py:205-222`)."""
    rec = dict(max_children=32, recycle=True, node_budget=budget,
               scan_chunk=512)
    if preset == "recycle":
        a = SearchConfig(num_sims=sims, wave_size=16, **rec)
        b = SearchConfig(num_sims=sims_b, wave_size=16, max_children=128,
                         node_budget=2 * sims_b + 2, backend="pallas_hbm")
    elif preset == "wave":
        a = SearchConfig(num_sims=sims, wave_size=32, **rec)
        b = SearchConfig(num_sims=sims_b, wave_size=16, **rec)
    elif preset == "waves":
        a = SearchConfig(num_sims=sims, wave_size=wave_a, **rec)
        b = SearchConfig(num_sims=sims_b, wave_size=wave_b, **rec)
    elif preset == "wave1":
        a = SearchConfig(num_sims=sims, wave_size=16, **rec)
        b = SearchConfig(num_sims=sims_b, wave_size=1, **rec)
    else:
        raise ValueError(f"unknown preset {preset!r}")
    return a, b


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", default="recycle", choices=PRESETS)
    ap.add_argument("--wave-a", type=int, default=32,
                    help="preset=waves: wave size for side A")
    ap.add_argument("--wave-b", type=int, default=16,
                    help="preset=waves: wave size for side B")
    ap.add_argument("--json-out", default=None,
                    help="append one JSON result line to this file")
    ap.add_argument("--games", type=int, default=32)
    ap.add_argument("--sims", type=int, default=2000)
    ap.add_argument("--sims-b", type=int, default=None,
                    help="sim budget for side B (default: --sims); a deep-"
                    "vs-shallow control that SHOULD show a decisive gap")
    ap.add_argument("--size", type=int, default=6)
    ap.add_argument("--budget", type=int, default=1280)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-plies", type=int, default=200)
    ap.add_argument("--model", default=None,
                    help="trained weights file (either package's) for BOTH "
                    "sides; untrained nets drown in reversible-ply draws")
    ap.add_argument("--blocks", type=int, default=None)
    ap.add_argument("--sprt", action="store_true",
                    help="sequential mode: rounds of --games paired "
                    "games until the SPRT decides or --max-games")
    ap.add_argument("--p0", type=float, default=0.45,
                    help="SPRT H0 decisive win rate (A meaningfully "
                    "weaker)")
    ap.add_argument("--p1", type=float, default=0.55,
                    help="SPRT H1 decisive win rate")
    ap.add_argument("--alpha", type=float, default=0.05)
    ap.add_argument("--beta", type=float, default=0.05)
    ap.add_argument("--max-games", type=int, default=256,
                    help="sequential-mode total-games cap")
    ap.add_argument("--subprocess-rounds", action="store_true",
                    help="run each SPRT round in a FRESH child process "
                    "(same flags minus --sprt/--subprocess-rounds, one "
                    "--games round per child, round-indexed --seed); "
                    "results accumulate here via --json-out, and each "
                    "child's peak resident memory is printed")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    return ap


def round_line(rnd: int, n_rounds: int, W, L, D, U, args, dt) -> str:
    """The running total after round `rnd` (0-based)."""
    upper, lower = sprt_bounds(args.alpha, args.beta)
    n = W + L
    rate = W / n if n else 0.0
    lo, hi = wilson_ci(W, n)
    llr = sprt_llr(W, L, args.p0, args.p1) if n else 0.0
    return (f"[round {rnd + 1}/{n_rounds}] total {W}-{L}-{D}"
            f"{f'-{U}u' if U else ''}  win_rate={rate:.3f} "
            f"CI95=[{lo:.3f},{hi:.3f}]  LLR={llr:+.2f} "
            f"(accept H1 at {upper:+.2f} / H0 at {lower:+.2f})  "
            f"[{dt:.0f}s]")


def sprt_decision(W: int, L: int, args):
    """"H1" (A not weaker), "H0" (A meaningfully weaker) or None."""
    upper, lower = sprt_bounds(args.alpha, args.beta)
    llr = sprt_llr(W, L, args.p0, args.p1) if W + L else 0.0
    if llr >= upper:
        return "H1"
    if llr <= lower:
        return "H0"
    return None


def n_rounds_of(args) -> int:
    return max(1, -(-args.max_games // args.games))


def play_rounds(args, log=print) -> dict:
    """Play the A/B of parsed `args` (one round, or SPRT rounds with
    `args.sprt`) on the card unless `args.cpu`; print the reference's
    lines and return its JSON record."""
    from ..engine.core import get_engine
    from ..model.network import Network
    from ..model.resnet import NetConfig
    from ..pit import PitConfig, pit
    from ..utils.device import resolve_device, setup_performance_defaults

    device = resolve_device("cpu" if args.cpu else "cuda")
    setup_performance_defaults(device)
    engine = get_engine(args.size)
    blocks = args.blocks or (16 if args.size >= 6 else 8)
    net = Network(engine, NetConfig(n=args.size, blocks=blocks),
                  device=device)
    variables = net.load(args.model) if args.model else net.init_variables(0)

    sims_b = args.sims_b or args.sims
    a, b = preset_configs(args.preset, args.sims, sims_b, args.budget,
                          args.wave_a, args.wave_b)
    cfg = PitConfig(games=args.games, search=a, search_b=b,
                    max_plies=args.max_plies)
    n_rounds = n_rounds_of(args) if args.sprt else 1

    W = L = D = U = 0
    decision = "single-round" if not args.sprt else "inconclusive"
    t0 = time.perf_counter()
    for rnd in range(n_rounds):
        res = pit(engine, net.policy_eval_states, variables, variables, cfg,
                  seed=args.seed + 1000 * rnd, log=log, device=device)
        W += res.wins
        L += res.losses
        D += res.draws
        U += res.unfinished
        log(round_line(rnd, n_rounds, W, L, D, U, args,
                       time.perf_counter() - t0))
        if args.sprt:
            decided = sprt_decision(W, L, args)
            if decided:
                decision = decided
                break
    dt = time.perf_counter() - t0
    n = W + L
    rate = W / n if n else 0.0
    lo, hi = wilson_ci(W, n)
    log(f"preset={args.preset} sims={args.sims} "
        f"games={W + L + D + U} ({dt:.0f}s):")
    log(f"  A (changed) vs B: {W}-{L}-{D}"
        f"{f'-{U}u' if U else ''}  win_rate={rate:.3f} "
        f"CI95=[{lo:.3f},{hi:.3f}]  (n={n} decisive)"
        + (f"  SPRT={decision} (p0={args.p0}, p1={args.p1})"
           if args.sprt else ""))
    record = {
        "preset": args.preset, "size": args.size, "sims": args.sims,
        "sims_b": sims_b, "games": W + L + D + U, "seed": args.seed,
        "model": args.model, "max_plies": args.max_plies,
        "wins": W, "losses": L, "draws": D,
        "unfinished": U, "win_rate": rate,
        "ci95": [round(lo, 4), round(hi, 4)],
        "seconds": round(dt),
    }
    if args.sprt:
        record["sprt"] = {
            "decision": decision, "llr": round(
                sprt_llr(W, L, args.p0, args.p1) if n else 0.0, 3),
            "p0": args.p0, "p1": args.p1,
            "alpha": args.alpha, "beta": args.beta,
        }
    if args.preset == "waves":
        record["wave_a"], record["wave_b"] = args.wave_a, args.wave_b
    return record


def child_argv(args, out: str) -> list:
    """The command line of one round's child process, but its seed."""
    base = [
        sys.executable, "-m", "tak_tpu_torch.tools.strength_ab",
        "--preset", args.preset,
        "--wave-a", str(args.wave_a), "--wave-b", str(args.wave_b),
        "--games", str(args.games), "--sims", str(args.sims),
        "--size", str(args.size), "--budget", str(args.budget),
        "--max-plies", str(args.max_plies), "--json-out", out,
    ]
    if args.sims_b is not None:
        base += ["--sims-b", str(args.sims_b)]
    if args.model:
        base += ["--model", args.model]
    if args.blocks is not None:
        base += ["--blocks", str(args.blocks)]
    if args.cpu:
        base.append("--cpu")
    return base


def run_child(cmd: list):
    """Run one round's child to its end: (exit code, its peak resident
    memory in MiB, from the kernel's accounting of that child)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH")
    env = {**os.environ,
           "PYTHONPATH": root + (os.pathsep + path if path else "")}
    proc = subprocess.Popen(cmd, env=env)
    try:
        _, status, usage = os.wait4(proc.pid, 0)
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    proc.returncode = os.waitstatus_to_exitcode(status)
    return proc.returncode, usage.ru_maxrss / 1024.0


def subprocess_rounds(args, log=print) -> dict:
    """Rounds of `args.games` games, each in a fresh child process, until
    the SPRT decides or `args.max_games`: the totals and the decision
    ({"wins", "losses", "draws", "unfinished", "decision", "rounds",
    "child_rss_mib"}).  Raises before the first child without a card
    unless `args.cpu`."""
    from ..utils.device import resolve_device

    resolve_device("cpu" if args.cpu else "cuda")
    n_rounds = n_rounds_of(args)
    W = L = D = U = 0
    decision = "inconclusive"
    rss = []
    t0 = time.perf_counter()
    out = args.json_out
    if out is None:
        fd, out = tempfile.mkstemp(suffix=".jsonl")
        os.close(fd)
    base = child_argv(args, out)
    try:
        for rnd in range(n_rounds):
            seed = args.seed + 1000 * rnd
            rc, peak = run_child(base + ["--seed", str(seed)])
            if rc != 0:
                log(f"[round {rnd + 1}] child exited {rc}; stopping")
                break
            rss.append(peak)
            log(f"[round {rnd + 1}] child peak RSS {peak:,.0f} MiB")
            with open(out) as f:
                last = json.loads(f.readlines()[-1])
            W += last["wins"]
            L += last["losses"]
            D += last["draws"]
            U += last["unfinished"]
            log(round_line(rnd, n_rounds, W, L, D, U, args,
                           time.perf_counter() - t0))
            decided = sprt_decision(W, L, args)
            if decided:
                decision = decided
                break
    finally:
        if args.json_out is None:
            os.unlink(out)
    log(f"subprocess-SPRT total: {W}-{L}-{D}"
        f"{f'-{U}u' if U else ''}  decision={decision}")
    return dict(wins=W, losses=L, draws=D, unfinished=U, decision=decision,
                rounds=len(rss), child_rss_mib=rss)


def main(argv=None):
    """Run the A/B; returns the record (or, with --subprocess-rounds, the
    totals of `subprocess_rounds`)."""
    args = build_parser().parse_args(argv)
    if args.subprocess_rounds:
        return subprocess_rounds(args, log=lambda m: print(m, flush=True))
    record = play_rounds(args, log=lambda m: print(m, flush=True))
    if args.json_out:
        with open(args.json_out, "a") as f:
            f.write(json.dumps(record) + "\n")
    return record


if __name__ == "__main__":
    main()
