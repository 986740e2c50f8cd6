"""The port's playtak surfaces against the JAX package's, on the CPU.

The wire codec equals `tak_tpu.playtak.protocol`'s for every action id at
sizes 3-6; protocol events; the bot over a scripted fake transport (where
the script fixes the search: `time_to_think=0` and a uniform network, it
sends the JAX bot's lines exactly) and over a scripted TCP server on
127.0.0.1, with its analysis PTN and examples read back through the
port's codec.  Nothing connects anywhere but the loopback address.
"""

import socket
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tak_tpu.engine.core import get_engine as jax_engine
from tak_tpu.playtak import protocol as jax_protocol
from tak_tpu.playtak.bot import BotConfig as JaxBotConfig
from tak_tpu.playtak.bot import PlaytakBot as JaxPlaytakBot
from tak_tpu_torch.engine.core import get_engine
from tak_tpu_torch.examples import ReplayBuffer
from tak_tpu_torch.playtak.bot import BotConfig, PlaytakBot
from tak_tpu_torch.playtak.protocol import (
    PlaytakProtocol,
    TcpTransport,
    move_to_wire,
    wire_to_move,
)

from tests.test_playtak import FakeTransport


def torch_uniform(num_actions):
    def eval_fn(params, states):
        b = states.ply.shape[0]
        return (torch.ones((b, num_actions)), torch.zeros(b))

    return eval_fn


def jax_uniform(num_actions):
    def eval_fn(params, states):
        b = states.ply.shape[0]
        return jnp.ones((b, num_actions), jnp.float32), jnp.zeros(b, jnp.float32)

    return eval_fn


@pytest.mark.parametrize("n", [3, 4, 5, 6])
def test_wire_codec_equals_jax(n):
    """Every action id: the same wire line in both packages; a move that
    stays on the board parses back to itself."""
    t, jt = get_engine(n).tables, jax_engine(n).tables
    for a in range(t.num_actions):
        m = t.action_to_move(a)
        line = move_to_wire(7, m)
        assert line == jax_protocol.move_to_wire(7, jt.action_to_move(a)), a
        words = line.split()[1:]
        dest = [int(w[1:]) - 1 for w in words[1:3]] if m.is_spread else [0]
        if all(0 <= d < n for d in dest) and all(
                0 <= ord(w[0]) - ord("A") < n for w in words[1:3]):
            assert str(wire_to_move(words)) == str(m), line
            assert str(jax_protocol.wire_to_move(words)) == str(m), line


def test_protocol_events():
    p = PlaytakProtocol()
    assert p.login_lines() == ["Login Guest"]
    assert PlaytakProtocol("u", "pw").login_lines() == ["Login u pw"]
    assert p.seek_line(6, 600, 10, "W", 4) == "Seek 6 600 10 W 4"
    assert p.feed("Welcome takbot!") == ("login_ok", "takbot")
    ev = p.feed("Game Start 42 6 alice vs bob white 600")
    info = ev[1]
    assert ev[0] == "game_start" and (
        info.number, info.size, info.white, info.black, info.my_color) == (
        42, 6, "alice", "bob", 0)
    assert p.feed("Game Start 43 5 alice vs bob B 600")[1].my_color == 1
    ev = p.feed("Game#42 M C3 C5 1 2")
    assert ev[0] == "move" and str(ev[2]) == "3c3+12"
    assert p.feed("Game#42 Over R-0") == ("game_over", 42, "R-0")
    assert p.feed("Game#42 Time 400 300") == ("time", 42, 400, 300)
    assert p.feed("Shout hello") is None and p.feed("  ") is None
    for line in ("Game#42 P A1", "Game#42 Over 0-R", "Game#42 Time 1 2",
                 "Game Start 9 3 x vs y black 600", "NOK"):
        assert repr(p.feed(line)) == repr(jax_protocol.PlaytakProtocol()
                                           .feed(line)), line


SCRIPT = [
    "Welcome tester!",
    "Game Start 9 3 tester vs foe white 600",
    "Game#9 P C3",
    None,               # one ponder tick
    "Game#9 Over 0-R",
]


def test_bot_sends_the_jax_bots_lines(tmp_path):
    """The same script through both bots (3x3, uniform network, no think
    time, a ponder tick): identical lines sent; the port writes its
    analysis PTN and an examples file that its codec reads back."""
    n = 3
    jt = FakeTransport(SCRIPT)
    JaxPlaytakBot(jax_engine(n), jax_uniform(jax_engine(n).num_actions), None,
                  JaxBotConfig(size=n, komi=0, time_to_think=0.0, wave_size=4,
                               workdir=str(tmp_path / "jax"))
                  ).run(jt, max_games=1, log=lambda m: None)
    engine = get_engine(n)
    tt = FakeTransport(SCRIPT)
    PlaytakBot(engine, torch_uniform(engine.num_actions), None,
               BotConfig(size=n, komi=0, time_to_think=0.0, wave_size=4,
                         workdir=str(tmp_path / "port")), device="cpu"
               ).run(tt, max_games=1, log=lambda m: None)
    assert tt.sent == jt.sent
    assert tt.sent[:3] == ["Login Guest", "Seek 3 600 10 W 0", "Game#9 P A1"]
    games = list((tmp_path / "port" / "_playtak_games").iterdir())
    assert len(games) == 1 and "tester_vs_foe" in games[0].name
    text = games[0].read_text()
    assert '[Player1 "tester"]' in text and "a1" in text
    data = list((tmp_path / "port" / "_examples").iterdir())
    assert len(data) == 1
    buf = ReplayBuffer()
    buf.load(engine, str(data[0]))
    assert all(ex.result == (-1.0 if int(ex.state["to_move"]) == 0 else 1.0)
               for ex in buf.examples)


def test_bot_instant_win_and_book(tmp_path):
    """The bot takes a winning move before searching, and answers a
    corner opening from its book."""
    from tak_tpu_torch.game import Game

    engine = get_engine(3)
    bot = PlaytakBot(engine, torch_uniform(engine.num_actions), None,
                     BotConfig(size=3, komi=0, time_to_think=0.0, wave_size=4,
                               workdir=str(tmp_path)), device="cpu")
    player = bot._new_game()
    for mv in ("a3", "c3", "c2", "a2"):
        player.play_move(mv, with_info=False)
    action, searched = bot._choose_move(player, None)
    g = Game.from_ptn_moves(3, ["a3", "c3", "c2", "a2"], device="cpu")
    g.play_action(action)
    assert g.result == 1 and not searched
    player = bot._new_game()
    a1 = engine.tables.ptn_to_action("a1")
    player.play_move(a1, with_info=False)
    action, searched = bot._choose_move(player, a1)
    assert engine.tables.action_to_ptn(action) == "c3" and not searched


class ScriptedTakServer(threading.Thread):
    """A playtak.com stand-in on 127.0.0.1 for one scripted guest game
    (`tests/test_transports.py`), pausing before the opponent's reply so
    that the bot's readline times out and it ponders."""

    def __init__(self):
        super().__init__(daemon=True)
        self.listener = socket.create_server(("127.0.0.1", 0))
        self.port = self.listener.getsockname()[1]
        self.received = []
        self.error = None

    def _expect(self, rfile, prefix):
        line = rfile.readline().strip()
        self.received.append(line)
        if not line.startswith(prefix):
            raise AssertionError(f"expected {prefix!r}, got {line!r}")

    def run(self):
        import time

        try:
            conn, _ = self.listener.accept()
            conn.settimeout(60)
            rfile = conn.makefile("r", encoding="utf-8", newline="\n")

            def send(s):
                conn.sendall((s + "\n").encode())

            self._expect(rfile, "Login Guest")
            send("Welcome tester!")
            self._expect(rfile, "Seek 3 600 10 W")
            send("Game Start 9 3 tester vs foe white 600")
            self._expect(rfile, "Game#9 P A1")
            time.sleep(0.6)                 # the bot ponders meanwhile
            send("Game#9 P C3")
            self._expect(rfile, "Game#9 ")
            send("Game#9 Over 0-R")
            conn.close()
        except Exception as e:  # surfaced by the test's assert
            self.error = e
        finally:
            self.listener.close()


def test_bot_over_local_tcp(tmp_path):
    """The port's bot through `TcpTransport` against the scripted server:
    the lines it sends, at least one ponder rollout, and the game's
    files."""
    engine = get_engine(3)
    server = ScriptedTakServer()
    server.start()
    bot = PlaytakBot(engine, torch_uniform(engine.num_actions), None,
                     BotConfig(size=3, komi=0, time_to_think=0.0, wave_size=4,
                               workdir=str(tmp_path)), device="cpu")
    rollouts = []
    orig = bot._new_game

    def new_game():
        player = orig()
        run = player.rollout
        player.rollout = lambda *a: rollouts.append(run(*a)) or rollouts[-1]
        return player

    bot._new_game = new_game
    transport = TcpTransport(host="127.0.0.1", port=server.port, timeout=0.2)
    try:
        bot.run(transport, max_games=1, log=lambda m: None)
    finally:
        transport.close()
    server.join(timeout=30)
    assert not server.is_alive() and server.error is None, server.error
    assert server.received[:3] == ["Login Guest", "Seek 3 600 10 W 0",
                                   "Game#9 P A1"]
    assert len(server.received) == 4 and rollouts and set(rollouts) == {4}
    games = list((tmp_path / "_playtak_games").iterdir())
    assert len(games) == 1 and "tester_vs_foe" in games[0].name
    assert len(list((tmp_path / "_examples").iterdir())) == 1


def test_playtak_cli_help(capsys):
    from tak_tpu_torch.cli import playtak_cli

    with pytest.raises(SystemExit) as e:
        playtak_cli.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--cpu" in out and "--host" in out and "model_path" in out
