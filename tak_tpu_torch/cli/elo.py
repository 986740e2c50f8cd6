"""Elo ladder CLI — round-robin evaluation among saved checkpoints
(counterpart of `tak_tpu/cli/elo.py`).

    python -m tak_tpu_torch.cli.elo _models/*.model [--size 6] [--games 32] \\
        [--rollouts 400] [--adjacent] [--out ratings.json] [--cpu]

Fits Bradley-Terry/Elo ratings over all pooled games so checkpoint
strength can be tracked as a curve across generations.  "random" may be
passed as a player to include a fresh-weights baseline.  Weights files of
either package are read.  The matches run on the CUDA device unless
`--cpu` is given.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tak-elo", description=__doc__)
    p.add_argument("models", nargs="+",
                   help='checkpoint paths (or "random" for fresh weights)')
    p.add_argument("--size", type=int, default=6)
    p.add_argument("--komi", type=int, default=2)
    p.add_argument("--games", type=int, default=32, help="games per pairing")
    p.add_argument("--rollouts", type=int, default=400, help="sims per move")
    p.add_argument("--wave", type=int, default=16)
    p.add_argument("--adjacent", action="store_true",
                   help="only play checkpoint i vs i+1 (cheap curve)")
    p.add_argument("--max-plies", type=int, default=400,
                   help="cut unfinished games (count as draws)")
    p.add_argument("--filters", type=int, default=128)
    p.add_argument("--blocks", type=int, default=None)
    p.add_argument("--out", default=None, help="write ratings JSON here")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA device")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..elo import LadderConfig, elo_ladder
    from ..engine.core import get_engine
    from ..mcts.search import SearchConfig
    from ..model.network import Network
    from ..model.resnet import NetConfig
    from ..pit import PitConfig
    from ..utils.device import resolve_device, setup_performance_defaults

    device = resolve_device("cpu" if args.cpu else None)
    setup_performance_defaults(device)
    engine = get_engine(args.size)
    blocks = args.blocks if args.blocks is not None else (
        16 if args.size >= 6 else 8
    )
    network = Network(engine, NetConfig(n=args.size, filters=args.filters,
                                        blocks=blocks), device=device)
    players = []
    for i, path in enumerate(args.models):
        if path == "random":
            players.append((f"random-{i}", network.init_variables(i)))
        else:
            players.append((os.path.basename(path), network.load(path)))

    cfg = LadderConfig(
        pit=PitConfig(
            games=args.games, komi=args.komi,
            search=SearchConfig(num_sims=args.rollouts, wave_size=args.wave,
                                max_children=128),
            max_plies=args.max_plies,
        ),
        schedule="adjacent" if args.adjacent else "round_robin",
    )
    result = elo_ladder(engine, network.policy_eval_states, players, cfg,
                        seed=args.seed, device=device)
    print(result.table())
    if args.out:
        with open(args.out, "w") as f:
            f.write(result.to_json() + "\n")
        print(f"wrote {args.out}")
    return result


if __name__ == "__main__":
    main()
