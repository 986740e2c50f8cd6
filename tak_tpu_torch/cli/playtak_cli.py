"""playtak.com bot CLI (counterpart of `tak_tpu/cli/playtak_cli.py`, the
reference `playtak` binary).

    python -m tak_tpu_torch.cli.playtak_cli MODEL [USERNAME PASSWORD] \\
        [--host HOST] [--port PORT] [--cpu] ...

Connects to playtak.com (or --host/--port), seeks 6x6 komi-2 games with
alternating colors, and plays with the network of the weights file MODEL
(either package's; "random" for fresh weights).  The bot runs on the CUDA
device unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import time


def build_parser():
    p = argparse.ArgumentParser(prog="tak-playtak", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("model_path")
    p.add_argument("username", nargs="?", default=None)
    p.add_argument("password", nargs="?", default=None)
    p.add_argument("--size", type=int, default=6)
    p.add_argument("--komi", type=int, default=2)
    p.add_argument("-b", "--start-as-black", action="store_true")
    p.add_argument("--initial-time", type=int, default=600)
    p.add_argument("--increment", type=int, default=10)
    p.add_argument("-t", "--time-to-think", type=float, default=10)
    p.add_argument("--host", default="playtak.com")
    p.add_argument("--port", type=int, default=10000)
    p.add_argument("--max-games", type=int, default=None)
    p.add_argument("--workdir", default=".",
                   help="where _playtak_games/ and _examples/ are written")
    p.add_argument("--log-file", default="playtak.log",
                   help="append bot activity here (playtak/src/main.rs:39)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA device")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..engine.core import get_engine
    from ..model.network import Network
    from ..playtak.bot import BotConfig, PlaytakBot
    from ..playtak.protocol import TcpTransport
    from ..utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    engine = get_engine(args.size)
    network = Network(engine, device=device)
    if args.model_path == "random":
        variables = network.init_variables(0)
    else:
        variables = network.load(args.model_path)

    bot = PlaytakBot(engine, network.policy_eval_states, variables, BotConfig(
        size=args.size, komi=args.komi,
        time_to_think=args.time_to_think,
        initial_time=args.initial_time, increment=args.increment,
        start_as_black=args.start_as_black, workdir=args.workdir,
    ), device=device)

    logf = open(args.log_file, "a") if args.log_file else None

    def log(msg):
        line = f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] {msg}"
        print(line, flush=True)
        if logf:
            logf.write(line + "\n")
            logf.flush()

    transport = TcpTransport(args.host, args.port, timeout=0.2)
    try:
        bot.run(transport, args.username, args.password, log=log,
                max_games=args.max_games)
    finally:
        transport.close()
        if logf:
            logf.close()


if __name__ == "__main__":
    main()
