"""playtak.com bot loop (counterpart of `tak_tpu/playtak/bot.py`; the
reference's playtak/src/bot.rs + playtak.rs).

Seeks games in a loop (alternating colors, playtak.rs:31-56) and plays
them with the single-game `Player`: instant-win scan before searching
(bot.rs:60-69), opposite-corner opening book on ply 1 (main.rs:27-30),
timed search per move, pondering while waiting for the opponent capped at
50,000 rollouts (main.rs:32, bot.rs:123-128).  On game end, writes the
annotated analysis PTN to `_playtak_games/` and appends training examples
completed with the server's result (bot.rs:138-162).

The bot plays on the CUDA device unless given `device="cpu"`: its
`Player` searches there (kernels #1, #8 and #9 at the defaults) and the
win scan steps every probe row through the fused step.
"""

from __future__ import annotations

import os
import socket
import time
from dataclasses import dataclass

import numpy as np

from ..actions import Move
from ..engine.core import Engine
from ..examples import example_to_line
from ..game import Game
from ..player import Player
from ..train_loop import sys_time
from ..utils.device import resolve_device
from .protocol import PlaytakProtocol, move_to_wire

PONDER_ROLLOUT_LIMIT = 50_000
ANALYSIS_DIR = "_playtak_games"
EXAMPLE_DIR = "_examples"


@dataclass
class BotConfig:
    size: int = 6
    komi: int = 2
    time_to_think: float = 10.0
    initial_time: int = 600
    increment: int = 10
    start_as_black: bool = False
    wave_size: int = 64
    workdir: str = "."


def _result_to_white_score(result: str) -> float | None:
    """Server result string -> white-perspective score (bot.rs:166-176)."""
    if result.startswith(("R-0", "F-0", "1-0")):
        return 1.0
    if result.endswith(("0-R", "0-F", "0-1")):
        return -1.0
    if "1/2" in result:
        return 0.0
    return None


class PlaytakBot:
    def __init__(self, engine: Engine, eval_fn, params, config: BotConfig,
                 device=None):
        self.engine = engine
        self.eval_fn = eval_fn
        self.params = params
        self.config = config
        self.device = resolve_device(device)
        n = engine.n
        corner = lambda r, c: engine.tables.move_to_action(Move(row=r, col=c))  # noqa: E731
        # opposite-corner book (playtak/src/main.rs:27-28), generalized
        self.opening_book = {
            corner(0, 0): corner(n - 1, n - 1),
            corner(0, n - 1): corner(n - 1, 0),
            corner(n - 1, 0): corner(0, n - 1),
            corner(n - 1, n - 1): corner(0, 0),
        }
        for d in (ANALYSIS_DIR, EXAMPLE_DIR):
            os.makedirs(os.path.join(config.workdir, d), exist_ok=True)

    # -- per-game handling ---------------------------------------------------

    def _new_game(self) -> Player:
        game = Game.with_komi(self.config.size, self.config.komi, self.device)
        return Player(
            self.engine, self.eval_fn, self.params, game,
            wave_size=self.config.wave_size,
            save_examples=True, create_analysis=True,
        )

    def _choose_move(self, player: Player, last_move: int | None):
        """Instant win > book > timed search (bot.rs:71-105)."""
        game = player.game
        if game.ply == 0:
            return self.engine.tables.ptn_to_action("a1"), False
        wins = self.engine.wins_in_one(game.state)[0].cpu().numpy()
        if wins.any():
            return int(np.nonzero(wins)[0][0]), False
        if game.ply == 1 and last_move in self.opening_book:
            return self.opening_book[last_move], False
        start = time.time()
        while time.time() - start < self.config.time_to_think:
            player.rollout()
        return player.pick_move(True), True

    def _finish_game(self, player: Player, info, result: str, log):
        analysis = player.get_analysis()
        name = ""
        if info is not None:
            analysis.add_setting("Player1", info.white)
            analysis.add_setting("Player2", info.black)
            name = f"_{info.white}_vs_{info.black}"
        path = os.path.join(self.config.workdir, ANALYSIS_DIR,
                            f"{sys_time()}{name}.ptn")
        with open(path, "w") as f:
            f.write(str(analysis))
        log(f"wrote {path}")
        score = _result_to_white_score(result)
        if score is not None:
            expath = os.path.join(self.config.workdir, EXAMPLE_DIR,
                                  f"playtak_{sys_time()}.data")
            with open(expath, "a") as f:
                for ex in player.get_examples(score):
                    f.write(example_to_line(self.engine, ex) + "\n")

    # -- main loop ------------------------------------------------------------

    def run(self, transport, username=None, password=None, log=print,
            max_games: int | None = None) -> None:
        proto = PlaytakProtocol(username, password)
        for line in proto.login_lines():
            transport.send(line)

        seek_white = not self.config.start_as_black
        player = None
        info = None
        last_move = None
        ponder_rollouts = 0
        games_done = 0
        seek_sent = False

        while max_games is None or games_done < max_games:
            if player is None and not seek_sent:
                transport.send(proto.seek_line(
                    self.config.size, self.config.initial_time,
                    self.config.increment,
                    "W" if seek_white else "B", 2 * self.config.komi,
                ))
                log(f"seek created (white: {seek_white})")
                seek_sent = True

            try:
                line = transport.readline()
            except (socket.timeout, TimeoutError):
                # ponder while waiting (bot.rs:123-128)
                if player is not None and player.game.ply > 0 \
                        and ponder_rollouts < PONDER_ROLLOUT_LIMIT:
                    ponder_rollouts += player.rollout()
                continue
            if line == "":
                log("connection closed")
                return
            event = proto.feed(line)
            if event is None:
                if line.strip() == "NOK":
                    log("server rejected a command")
                continue

            kind = event[0]
            if kind == "login_ok":
                log(f"logged in as {event[1]}")
            elif kind == "game_start":
                info = event[1]
                player = self._new_game()
                last_move = None
                ponder_rollouts = 0
                log(f"game {info.number}: {info.white} vs {info.black}")
                if info.my_color == 0:
                    self._take_turn(transport, player, info, last_move, log)
            elif kind == "move":
                _, no, move = event
                action = self.engine.tables.move_to_action(move)
                player.play_move(action, with_info=player.game.ply > 1)
                last_move = action
                log(f"opponent played {move}")
                self._take_turn(transport, player, info, last_move, log)
            elif kind == "game_over":
                _, no, result = event
                log(f"game over: {result}")
                self._finish_game(player, info, result, log)
                player, info = None, None
                seek_sent = False
                seek_white = not seek_white
                games_done += 1

    def _take_turn(self, transport, player, info, last_move, log):
        print_info = player.game.ply > 1
        action, with_info = self._choose_move(player, last_move)
        move = self.engine.tables.action_to_move(action)
        player.play_move(action, with_info=print_info and with_info)
        transport.send(move_to_wire(info.number, move))
        log(f"played {move}")
