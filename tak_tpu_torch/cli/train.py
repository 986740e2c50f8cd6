"""Trainer CLI (counterpart of `tak_tpu/cli/train.py`, the reference `train`
binary).

    python -m tak_tpu_torch.cli.train [model_path] [examples ...] \\
        [--folder DIR] [--size 6] [--cpu] ...

`model_path` of "random" (or omitted) starts from fresh weights
(train/src/cli.rs:4-16, main.rs:45-53); otherwise it is a weights file
written by either package.  Scale knobs (--games, --rollouts, --workers,
--generations) default to the reference's compile-time constants.  The
run uses the CUDA device unless `--cpu` is given.

Data parallel (`--sharded` on one host, `--distributed` across hosts; one
process per card, launched by torchrun, which sets the rank environment):

    torchrun --nproc_per_node=G -m tak_tpu_torch.cli.train ... --sharded

Self-play game slots and learner rows are split over the ranks
(`--workers` and the chunk size must divide by the world size); NCCL on
the cards, gloo with `--cpu`.
"""

from __future__ import annotations

import argparse
import functools
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tak-train", description=__doc__)
    p.add_argument("model_path", nargs="?", default=None,
                   help='path to model, or "random"/omitted for fresh weights')
    p.add_argument("examples", nargs="*", default=[],
                   help="paths to example .data files to preload")
    p.add_argument("-f", "--folder", default=None,
                   help="folder of example files to preload")
    p.add_argument("--size", type=int, default=6, help="board size (default 6)")
    p.add_argument("--komi", type=int, default=2)
    p.add_argument("--games", type=int, default=1000, help="self-play games/gen")
    p.add_argument("--workers", type=int, default=32, help="lockstep games")
    p.add_argument("--rollouts", type=int, default=10_000, help="sims per move")
    p.add_argument("--wave", type=int, default=32,
                   help="descents per NN batch")
    p.add_argument("--k", "--max-children", type=int, default=32, dest="k",
                   help="stored children per non-root node")
    p.add_argument("--recycle", dest="recycle", action="store_true",
                   default=None,
                   help="bounded node pool with cold-leaf eviction (default: "
                        "auto — on when rollouts exceed the pool size)")
    p.add_argument("--no-recycle", dest="recycle", action="store_false")
    p.add_argument("--pit-games", type=int, default=128)
    p.add_argument("--pit-rollouts", type=int, default=800)
    p.add_argument("--win-rate-threshold", type=float, default=0.55,
                   help="gate acceptance win rate (main.rs:28)")
    p.add_argument("--generations", type=int, default=None,
                   help="stop after N generations (default: run forever)")
    p.add_argument("--quad-rollout-plies", type=int, default=0,
                   help="sequential self-play (--workers 1): 4x rollouts "
                        "while ply < N (self_play.rs:19)")
    p.add_argument("--train-passes", type=int, default=1,
                   help="training passes over the buffer per generation "
                        "(1 = reference parity)")
    p.add_argument("--chunk-size", type=int, default=None,
                   help="training chunk size (default 500, network.rs:19)")
    p.add_argument("--chunks-in-step", type=int, default=None,
                   help="chunks per optimizer step (default 20)")
    p.add_argument("--workdir", default=".")
    p.add_argument("--resume", action="store_true",
                   help="resume from <workdir>/_checkpoint (weights + replay "
                        "buffer + generation counter)")
    p.add_argument("--filters", type=int, default=128)
    p.add_argument("--blocks", type=int, default=None,
                   help="res blocks (default: 16 for 6x6+, else 8)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA device")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sharded", action="store_true",
                   help="data parallel over the ranks of a torchrun launch "
                        "on this host: self-play slots and learner rows "
                        "split over them (workers and chunk rows must "
                        "divide the world size)")
    p.add_argument("--distributed", action="store_true",
                   help="the same over the hosts of a multi-node torchrun "
                        "launch (implies --sharded)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..engine.core import get_engine
    from ..examples import ReplayBuffer
    from ..mcts.search import SearchConfig
    from ..model.network import Network
    from ..model.resnet import NetConfig
    from ..pit import PitConfig
    from ..selfplay import RECYCLE_POOL, SelfPlayConfig
    from ..train_loop import TrainLoopConfig, load_training_run, training_loop
    from ..utils.device import resolve_device, setup_performance_defaults

    mesh = None
    if args.sharded or args.distributed:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(device="cpu" if args.cpu else None)
        device = mesh.device
        if mesh.rank == 0:
            print(f"mesh: {mesh.world} dp ranks ({mesh.backend})")
    else:
        device = resolve_device("cpu" if args.cpu else None)
    setup_performance_defaults(device)
    engine = get_engine(args.size)
    blocks = args.blocks or (16 if args.size >= 6 else 8)
    network = Network(engine, NetConfig(n=args.size, filters=args.filters,
                                        blocks=blocks), device=device)

    start_generation = 0
    if args.resume:
        variables, buffer, start_generation = load_training_run(
            engine, network, args.workdir
        )
        print(f"resumed from {args.workdir}/_checkpoint at generation "
              f"{start_generation} ({len(buffer)} buffered examples)")
    elif args.model_path and args.model_path != "random":
        variables = network.load(args.model_path)
        print(f"loaded model {args.model_path}")
    else:
        variables = network.init_variables(args.seed)
        print("starting from random weights")

    buffer = buffer if args.resume else ReplayBuffer()
    paths = list(args.examples)
    if args.folder:
        paths += sorted(
            os.path.join(args.folder, f) for f in os.listdir(args.folder)
            if os.path.isfile(os.path.join(args.folder, f))
        )
    for path in paths:
        print(f"loading {path}")
        buffer.load(engine, path)
    print(f"replay buffer: {len(buffer)} examples")

    # recycle auto-default: deep sim budgets run through the bounded
    # recycled pool; shallow searches fit outright
    recycle = args.recycle
    if recycle is None:
        recycle = args.rollouts * 2 + 2 > RECYCLE_POOL
    if recycle:
        print(f"search: recycled {RECYCLE_POOL}-node pool "
              f"(wave {args.wave}, K {args.k})")

    cfg = TrainLoopConfig(
        selfplay=SelfPlayConfig(
            games=args.games, workers=args.workers, komi=args.komi,
            search=SearchConfig(num_sims=args.rollouts, wave_size=args.wave,
                                max_children=args.k, recycle=recycle),
            quad_rollout_plies=args.quad_rollout_plies,
        ),
        pit=PitConfig(
            games=args.pit_games, komi=args.komi,
            search=SearchConfig(num_sims=args.pit_rollouts, wave_size=16),
        ),
        generations=args.generations,
        win_rate_threshold=args.win_rate_threshold,
        train_passes=args.train_passes,
        workdir=args.workdir,
    )
    if args.chunk_size or args.chunks_in_step:
        network.train = functools.partial(
            network.train, chunk_size=args.chunk_size,
            chunks_in_step=args.chunks_in_step,
        )
    training_loop(engine, network, variables, buffer, cfg, seed=args.seed,
                  start_generation=start_generation, mesh=mesh)


if __name__ == "__main__":
    main()
