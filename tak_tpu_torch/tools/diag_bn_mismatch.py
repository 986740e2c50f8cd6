"""Discriminate WHY gate candidates degrade (round-5 plateau forensics;
counterpart of `tools/diag_bn_mismatch.py`).

Reproduces the trainer's candidate exactly (same checkpoint, same
deterministic per-(seed, generation) shuffle), then pits three variants
against the champion at the gate's search budget:

  A: candidate as trained              (expect ~0.13 per the gen-17 gate)
  B: candidate params + CHAMPION batch_stats
  C: champion params + CANDIDATE batch_stats

If B recovers to ~0.5 while A is bad -> the BatchNorm running-stats
update during training is poisoning inference (train/inference
mismatch).  If C is bad while B is bad too -> the stats are fine and
the PARAMS themselves degrade (the weak-improvement-operator reading).

The port's variables are one state_dict: its batch statistics are the
BatchNorms' `running_mean`, `running_var` (and `num_batches_tracked`),
everything else is a parameter.  A checkpoint without `buffer.data`
reads as an empty buffer; training on it changes nothing, as in the JAX
package, so every variant is the champion.

    python -m tak_tpu_torch.tools.diag_bn_mismatch [--workdir runs/train6_r4] [--cpu]

Runs on the CUDA device unless `--cpu` is given.
"""

from __future__ import annotations

import numpy as np

from ..engine.core import get_engine
from ..mcts.search import SearchConfig
from ..model.network import Network
from ..pit import PitConfig, pit
from ..train_loop import load_training_run
from .timing import open_device, parser

STATS = (".running_mean", ".running_var", ".num_batches_tracked")


def mixed(params_from: dict, stats_from: dict) -> dict:
    """The parameters of `params_from` with the batch statistics of
    `stats_from`."""
    return {k: (stats_from if k.endswith(STATS) else params_from)[k]
            for k in params_from}


def run(engine, net: Network, workdir: str, *, games: int = 32,
        sims: int = 256, seed: int = 6, pit_seed: int = 99, passes: int = 2,
        search: SearchConfig | None = None, max_plies: int = 200,
        eval_fn=None, device=None, log=print) -> dict:
    """The tool on `workdir`'s checkpoint.  `search` (default the gate's:
    `sims` in waves of 16, K=128), `max_plies` and `eval_fn` (default the
    network's) let a test run it small.  Returns {"generation",
    "examples", "champion", "candidate", "variants": {name: variables},
    "results": {name: PitResult}}."""
    champion, buffer, gen = load_training_run(engine, net, workdir)
    champion = {k: v.to(net.device) for k, v in champion.items()}
    log(f"checkpoint: generation {gen}, buffer {len(buffer)} examples")
    candidate = net.train(
        champion, buffer.examples,
        rng=np.random.default_rng([seed, gen + 1]),
        passes=passes,
    )
    variants = {
        "A candidate(as-trained)": candidate,
        "B cand-params+champ-stats": mixed(candidate, champion),
        "C champ-params+cand-stats": mixed(champion, candidate),
    }
    cfg = PitConfig(
        games=games, komi=2,
        search=search or SearchConfig(num_sims=sims, wave_size=16,
                                      max_children=128),
        max_plies=max_plies,
    )
    eval_fn = eval_fn or net.policy_eval_states
    results = {}
    for name, v in variants.items():
        res = pit(engine, eval_fn, v, champion, cfg, seed=pit_seed,
                  log=lambda *a, **k: None, device=device)
        results[name] = res
        log(f"{name}: {res}  win_rate={res.win_rate():.3f}")
    return {"generation": gen, "examples": len(buffer),
            "champion": champion, "candidate": candidate,
            "variants": variants, "results": results}


def main(argv=None, env=None):
    """`env` is unused: the JAX script takes flags only."""
    ap = parser("diag_bn_mismatch", __doc__)
    ap.add_argument("--workdir", default="runs/train6_r4")
    ap.add_argument("--games", type=int, default=32)
    ap.add_argument("--sims", type=int, default=256)
    ap.add_argument("--seed", type=int, default=6, help="trainer seed")
    ap.add_argument("--pit-seed", type=int, default=99)
    ap.add_argument("--passes", type=int, default=2)
    args = ap.parse_args(argv)
    device = open_device(args.cpu)

    engine = get_engine(6)
    net = Network(engine, device=device)
    return run(engine, net, args.workdir, games=args.games, sims=args.sims,
               seed=args.seed, pit_seed=args.pit_seed, passes=args.passes,
               device=device, log=lambda m: print(m, flush=True))


if __name__ == "__main__":
    main()
