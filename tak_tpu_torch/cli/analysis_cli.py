"""Analysis CLI — capability mirror of the reference `analysis` binary
(counterpart of `tak_tpu/cli/analysis_cli.py`).

    python -m tak_tpu_torch.cli.analysis_cli SIZE MODEL [options]

Three modes (analysis/src/main.rs:50-58):
  * --ptn-file FILE : replay a PTN file, thinking --think-seconds per
    move, printing the top lines, writing `analysis.ptn`
  * --example-game  : self-play with a fixed opening
  * (default)       : interactive REPL — think while waiting for input;
    commands: help / finish / undo / tps / nps / [move] / [empty = eval]

MODEL of "random" uses fresh weights; a path names a weights file written
by the JAX package's `Network.save`.  The search runs on the CUDA device
unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import sys
import time

HELP_MESSAGE = """\
help    - shows this message
finish  - ends the game and creates an analysis file
undo    - return to the previous position (resets nodes and analysis)
tps     - shows the current board as TPS
nps     - shows the nodes per second (since last move)
[empty] - shows the network evaluation
[move]  - plays the move
"""


def build_parser():
    p = argparse.ArgumentParser(prog="tak-analysis", description=__doc__)
    p.add_argument("board_size", type=int)
    p.add_argument("model_path")
    p.add_argument("-b", "--batch-size", type=int, default=64,
                   help="virtual rollouts per wave")
    p.add_argument("-p", "--ptn-file", default=None)
    p.add_argument("-f", "--from-position", default=None,
                   help='"TPS;ws;wc;bs;bc;half_komi"')
    p.add_argument("-e", "--example-game", action="store_true")
    p.add_argument("-t", "--think-seconds", type=int, default=15)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA device")
    p.add_argument("-o", "--out", default="analysis.ptn")
    return p


def _setup(args):
    from ..engine.core import get_engine
    from ..model.network import Network
    from ..utils.device import resolve_device, setup_performance_defaults

    device = resolve_device("cpu" if args.cpu else None)
    setup_performance_defaults(device)
    engine = get_engine(args.board_size)
    network = Network(engine, device=device)
    if args.model_path == "random":
        variables = network.init_variables(0)
    else:
        variables = network.load(args.model_path)
    eval_fn = lambda p, s: network.policy_eval_states(p, s)
    return engine, eval_fn, variables, device


def _think_for(player, seconds):
    start = time.time()
    player.rollout()  # at least one wave
    while time.time() - start < seconds:
        player.rollout()


def _make_player(engine, eval_fn, variables, game, args):
    from ..player import Player

    return Player(engine, eval_fn, variables, game,
                  wave_size=args.batch_size, create_analysis=True)


def _save(player, args):
    analysis = player.get_analysis()
    if args.from_position:
        analysis.add_setting("TPS", args.from_position.split(";")[0])
    with open(args.out, "w") as f:
        f.write(str(analysis))
    print(f"created a file `{args.out}` with the analysis of this game")


def analyze_file(engine, eval_fn, variables, device, args):
    from ..engine.ptn import parse_ptn
    from ..game import Game
    from ..types import BLACK

    with open(args.ptn_file) as f:
        state, moves = parse_ptn(engine, f.read(), device)
    game = Game(engine.n, state=state)
    player = _make_player(engine, eval_fn, variables, game, args)
    for mv in moves:
        _think_for(player, args.think_seconds)
        print(player.debug(10).maybe_flip(player.game.to_move == BLACK).format(10))
        print(f"playing {mv}")
        player.play_move(str(mv), with_info=True)
    _save(player, args)


def example_game(engine, eval_fn, variables, device, args):
    from ..game import Game
    from ..types import BLACK, ONGOING

    n = engine.n
    game = Game.with_komi(n, 2, device)
    player = _make_player(engine, eval_fn, variables, game, args)
    for mv in ("a1", f"{chr(ord('a') + n - 1)}1"):
        player.play_move(mv, with_info=False)
    while player.game.result == ONGOING:
        _think_for(player, args.think_seconds)
        mv = player.pick_move(True)
        print(player.debug(10).maybe_flip(player.game.to_move == BLACK).format(10))
        player.play_move(mv, with_info=True)
    _save(player, args)


def interactive(engine, eval_fn, variables, device, args):
    import queue
    import threading

    from ..engine.ptn import parse_position
    from ..game import Game, IllegalMove
    from ..types import BLACK, ONGOING

    if args.from_position:
        state = parse_position(engine, args.from_position, device)
        game = Game(engine.n, state=state)
    else:
        game = Game.with_komi(engine.n, 2, device)
    player = _make_player(engine, eval_fn, variables, game, args)
    history = [game.state]

    inputs: queue.Queue[str] = queue.Queue()

    def reader():
        for line in sys.stdin:
            inputs.put(line)
        inputs.put("finish")

    threading.Thread(target=reader, daemon=True).start()
    print(HELP_MESSAGE)

    start, nodes = time.time(), 0
    while player.game.result == ONGOING:
        try:
            line = inputs.get(timeout=0.05)
        except queue.Empty:
            nodes += player.rollout()  # ponder while waiting
            continue
        trim = line.strip()
        if trim == "help":
            print(HELP_MESSAGE)
        elif trim == "finish":
            break
        elif trim == "undo":
            if len(history) > 1:
                history.pop()
                game = Game(engine.n, state=history[-1])
                player = _make_player(engine, eval_fn, variables, game, args)
                start, nodes = time.time(), 0
                print("undo complete")
            else:
                print("nothing to undo")
        elif trim == "tps":
            print(player.game)
        elif trim == "nps":
            delta = time.time() - start
            print(f"{nodes / max(delta, 1e-9):.1f} nodes per second")
        elif trim == "":
            print(player.debug(10)
                  .maybe_flip(player.game.to_move == BLACK).format(10))
        else:
            try:
                probe = player.game.clone()
                probe.play(trim)  # raises on illegal/malformed input
                player.play_move(trim, with_info=True)
                history.append(player.game.state)
                start, nodes = time.time(), 0
            except (IllegalMove, ValueError) as err:
                print(err)
    _save(player, args)


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup = _setup(args)
    if args.ptn_file:
        analyze_file(*setup, args)
    elif args.example_game:
        example_game(*setup, args)
    else:
        interactive(*setup, args)


if __name__ == "__main__":
    main()
