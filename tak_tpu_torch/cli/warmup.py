"""Warm-up CLI (counterpart of `tak_tpu/cli/warmup.py`): run every stage of
one training generation at a configuration's real shapes and print each
stage's wall time.

    python -m tak_tpu_torch.cli.warmup [--size 6] [--workers 32] \\
        [--rollouts 10000] [--wave 16] [--pit-games 128] \\
        [--pit-rollouts 800] [--chunk-size 500] [--cpu]

On the card its first stage builds the CUDA kernels into
`build/tak_tpu_torch/`, which every later process of the checkout loads:
run it once per machine and checkout before a training run.  cuDNN's
autotuning, the CUDA context and the allocator's pools are per process
and do not carry over (`utils/warmup.py`).  `--cpu` runs the same stages
on the CPU with the kernels' plain versions.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tak-warmup", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--size", type=int, default=6)
    p.add_argument("--komi", type=int, default=2)
    p.add_argument("--workers", type=int, default=32)
    p.add_argument("--rollouts", type=int, default=10_000)
    p.add_argument("--wave", type=int, default=16)
    p.add_argument("--k", "--max-children", type=int, default=32, dest="k")
    p.add_argument("--recycle", dest="recycle", action="store_true",
                   default=None, help="default: auto, matching cli/train.py")
    p.add_argument("--no-recycle", dest="recycle", action="store_false")
    p.add_argument("--pit-games", type=int, default=128)
    p.add_argument("--pit-rollouts", type=int, default=800)
    p.add_argument("--no-pit", action="store_true")
    p.add_argument("--chunk-size", type=int, default=500)
    p.add_argument("--filters", type=int, default=128)
    p.add_argument("--blocks", type=int, default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA device")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..engine.core import get_engine
    from ..mcts.search import SearchConfig
    from ..model.network import Network
    from ..model.resnet import NetConfig
    from ..pit import PitConfig
    from ..selfplay import RECYCLE_POOL, SelfPlayConfig
    from ..utils.device import resolve_device, setup_performance_defaults
    from ..utils.warmup import warmup_generation

    device = resolve_device("cpu" if args.cpu else None)
    setup_performance_defaults(device)
    engine = get_engine(args.size)
    blocks = args.blocks if args.blocks is not None else (
        16 if args.size >= 6 else 8
    )
    network = Network(engine, NetConfig(n=args.size, filters=args.filters,
                                        blocks=blocks), device=device)
    recycle = args.recycle
    if recycle is None:  # same auto rule as cli/train.py
        recycle = args.rollouts * 2 + 2 > RECYCLE_POOL
    sp = SelfPlayConfig(
        workers=args.workers, komi=args.komi,
        search=SearchConfig(num_sims=args.rollouts, wave_size=args.wave,
                            max_children=args.k, recycle=recycle),
    )
    pit = None if args.no_pit else PitConfig(
        games=args.pit_games, komi=args.komi,
        search=SearchConfig(num_sims=args.pit_rollouts, wave_size=16,
                            max_children=128),
    )
    warmup_generation(engine, network, sp, pit, chunk_size=args.chunk_size)


if __name__ == "__main__":
    main()
