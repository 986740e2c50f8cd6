"""TEI (Tak Engine Interface) server — UCI-style protocol over stdio.

Counterpart of `tak_tpu/cli/tei.py`
(`python -m tak_tpu_torch.cli.tei [MODEL] [--size N] [--cpu]`; the search
runs on the CUDA device unless `--cpu` is given).  Working replacement
for the reference's bit-rotted `tei` crate
(tei/src/main.rs; the upstream binary no longer compiles — SURVEY.md
§2.6).  Protocol (https://github.com/MortenLohne/racetrack#tei):

    tei                      -> id name/author, options, teiok
    teinewgame <size>        -> reset to a fresh game of that size
    setoption name X value Y
    position startpos [moves m1 m2 ...] | tps <tps>
    go infinite | go wtime W btime B winc WI binc BI
    isready                  -> readyok
    quit

Time budget per move = remaining/10 + increment/2 with exponentially
growing rollout bursts, emitting `info ... nps ... pv ...` lines and a
final `bestmove` (tei/src/main.rs:164-198).
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(prog="tak-tei", description=__doc__)
    p.add_argument("model_path", nargs="?", default="random")
    p.add_argument("--size", type=int, default=6)
    p.add_argument("--half-komi", type=int, default=4)
    p.add_argument("-b", "--batch-size", type=int, default=64)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA device")
    return p


class TeiServer:
    def __init__(self, args):
        import torch

        from ..utils.device import resolve_device

        self.device = resolve_device("cpu" if args.cpu else None)
        if self.device.type == "cuda":
            torch.backends.cudnn.benchmark = True
        self.args = args
        self.size = args.size
        self.half_komi = args.half_komi
        self._load(args.size)
        self._new_game()

    def _load(self, size):
        from ..engine.core import get_engine
        from ..model.network import Network

        self.engine = get_engine(size)
        self.network = Network(self.engine, device=self.device)
        if self.args.model_path == "random":
            self.variables = self.network.init_variables(0)
        else:
            self.variables = self.network.load(self.args.model_path)
        self.eval_fn = lambda p, s: self.network.policy_eval_states(p, s)

    def _new_game(self):
        from ..game import Game

        self.game = Game(self.size, half_komi=self.half_komi,
                         device=self.device)
        self.player = None

    def _make_player(self):
        from ..player import Player

        self.player = Player(self.engine, self.eval_fn, self.variables,
                             self.game, wave_size=self.args.batch_size)

    # -- commands ------------------------------------------------------------

    def cmd_position(self, words):
        from ..game import Game

        if words[:1] == ["startpos"]:
            self._new_game()
            if words[1:2] == ["moves"]:
                for mv in words[2:]:
                    self.game.play(mv)
        elif words[:1] == ["tps"]:
            from ..engine.tps import tps_to_state

            tps = " ".join(words[1:4]) if len(words) >= 4 else words[1]
            state = tps_to_state(self.engine, tps, half_komi=self.half_komi,
                                 device=self.device)
            self.game = Game(self.size, state=state)
        self.player = None

    def cmd_go(self, words):
        budget = None  # None = infinite
        if words[:1] == ["infinite"]:
            budget = float("inf")
        else:
            opts = dict(zip(words[::2], words[1::2]))
            side = "w" if self.game.to_move == 0 else "b"
            t_ms = float(opts.get(f"{side}time", 10_000))
            inc_ms = float(opts.get(f"{side}inc", 0))
            budget = t_ms / 10_000 + inc_ms / 2_000  # /10 and /2, in seconds

        if self.player is None:
            self._make_player()
        start = time.time()
        total_nodes = 0
        i = 0
        while True:
            burst = max(1, int(10 * (1.42 ** i) / self.args.batch_size))
            total_nodes += self.player.rollout(burst)
            elapsed = time.time() - start
            nps = total_nodes / max(elapsed, 1e-9)
            info = (f"info score cp 0 depth {i} nodes {total_nodes} "
                    f"time {int(elapsed * 1000)} nps {nps:.0f}")
            if elapsed > budget:
                action = self.player.pick_move(True)
                pv = self.engine.tables.action_to_ptn(action)
                print(f"{info} pv {pv}", flush=True)
                print(f"bestmove {pv}", flush=True)
                break
            print(info, flush=True)
            i += 1

    def serve(self, stdin=sys.stdin):
        first = stdin.readline()
        if first.strip() != "tei":
            print(f"Unexpected input {first!r}", file=sys.stderr)
            return 1
        print("id name tak-tpu")
        print("id author tak-tpu contributors")
        print(f"option name HalfKomi type spin default {self.half_komi} "
              f"min 0 max 10")
        print("teiok", flush=True)

        for line in stdin:
            words = line.split()
            if not words:
                continue
            cmd = words[0]
            if cmd == "teinewgame":
                size = int(words[1]) if len(words) > 1 else self.size
                if size != self.size:
                    self.size = size
                    self._load(size)
                self._new_game()
            elif cmd == "setoption":
                # setoption name HalfKomi value N
                if words[1:3] == ["name", "HalfKomi"] and words[3] == "value":
                    self.half_komi = int(words[4])
                    self._new_game()
            elif cmd == "position":
                self.cmd_position(words[1:])
            elif cmd == "go":
                self.cmd_go(words[1:])
            elif cmd == "isready":
                print("readyok", flush=True)
            elif cmd == "quit":
                return 0
        return 0


def main(argv=None):
    args = build_parser().parse_args(argv)
    return TeiServer(args).serve()


if __name__ == "__main__":
    sys.exit(main())
