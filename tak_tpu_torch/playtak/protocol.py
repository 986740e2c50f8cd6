"""playtak.com client protocol (classic TCP text protocol).

The port's copy of `tak_tpu/playtak/protocol.py` (framework-free; the
port imports nothing of `tak_tpu`).  It replaces the reference's
`tokio-takconnect` dependency (playtak/src/playtak.rs): a small sans-io
protocol core (`PlaytakProtocol`) that turns server lines into events and
bot commands into client lines, plus a thin blocking TCP transport
(which, unlike the reference's, survives a read timeout: see
`TcpTransport`).  The sans-io split makes the protocol fully testable
without network access.

Wire format (PlayTak server protocol, playtak.com:10000):
    -> Login <user> <pass> | Login Guest
    -> Seek <size> <time> <inc> [W|B|A] [<half-komi> ...]
    -> Game#<no> P <SQ> [C|W]          place (C = cap, W = wall)
    -> Game#<no> M <SQ1> <SQ2> <n...>  spread with drop counts
    <- Game Start <no> <size> <white> vs <black> <color> <time>
    <- Game#<no> P/M ...               opponent move
    <- Game#<no> Over <result>
    <- Game#<no> Time <white> <black>
    -> PING (keepalive)                <- OK
"""

from __future__ import annotations

import socket
from dataclasses import dataclass, field

from ..actions import Move, CAP, FLAT, WALL, DIR_VECS


def square_to_wire(row: int, col: int) -> str:
    return f"{chr(ord('A') + col)}{row + 1}"


def wire_to_square(s: str) -> tuple[int, int]:
    return int(s[1:]) - 1, ord(s[0].upper()) - ord("A")


def move_to_wire(game_no: int, m: Move) -> str:
    """PTN move -> Game#N P/M command."""
    if not m.is_spread:
        suffix = {FLAT: "", WALL: " W", CAP: " C"}[m.piece]
        return f"Game#{game_no} P {square_to_wire(m.row, m.col)}{suffix}"
    dr, dc = DIR_VECS[m.direction]
    s = len(m.drops)
    dest = (m.row + dr * s, m.col + dc * s)
    drops = " ".join(str(d) for d in m.drops)
    return (f"Game#{game_no} M {square_to_wire(m.row, m.col)} "
            f"{square_to_wire(*dest)} {drops}")


def wire_to_move(words: list[str]) -> Move:
    """P/M command payload (after Game#N) -> Move."""
    if words[0] == "P":
        row, col = wire_to_square(words[1])
        piece = FLAT
        if len(words) > 2:
            piece = {"C": CAP, "W": WALL}[words[2]]
        return Move(row=row, col=col, piece=piece)
    if words[0] == "M":
        r1, c1 = wire_to_square(words[1])
        r2, c2 = wire_to_square(words[2])
        drops = tuple(int(x) for x in words[3:])
        dr = (r2 - r1) and ((r2 - r1) // abs(r2 - r1))
        dc = (c2 - c1) and ((c2 - c1) // abs(c2 - c1))
        direction = DIR_VECS.index((dr, dc))
        return Move(row=r1, col=c1, direction=direction, drops=drops)
    raise ValueError(f"unknown move wire format {words!r}")


@dataclass
class GameInfo:
    number: int
    size: int
    white: str
    black: str
    my_color: int  # 0 white / 1 black


@dataclass
class PlaytakProtocol:
    """Sans-io protocol state machine.  Feed lines, read events.

    Events: ("login_ok", name) ("game_start", GameInfo)
            ("move", game_no, Move) ("game_over", game_no, result_str)
            ("time", game_no, white_s, black_s)
    """

    username: str | None = None
    password: str | None = None
    out: list = field(default_factory=list)  # lines to send

    def login_lines(self) -> list[str]:
        if self.username:
            return [f"Login {self.username} {self.password}"]
        return ["Login Guest"]

    def seek_line(self, size: int, time_s: int, inc_s: int,
                  color: str = "A", half_komi: int = 4) -> str:
        return f"Seek {size} {time_s} {inc_s} {color} {half_komi}"

    def feed(self, line: str):
        """Parse one server line into zero or one event tuple."""
        line = line.strip()
        if not line:
            return None
        words = line.split()
        if line.startswith("Welcome ") and line.endswith("!"):
            return ("login_ok", line[len("Welcome "):-1])
        if line.startswith("Game Start"):
            # Game Start <no> <size> <white> vs <black> <W|B|white|black> ...
            no, size = int(words[2]), int(words[3])
            white, black = words[4], words[6]
            mine = words[7].upper()
            my_color = 0 if mine in ("W", "WHITE") else 1
            return ("game_start", GameInfo(no, size, white, black, my_color))
        if line.startswith("Game#"):
            head, rest = words[0], words[1:]
            no = int(head.split("#")[1])
            if rest[0] in ("P", "M"):
                return ("move", no, wire_to_move(rest))
            if rest[0] == "Over":
                return ("game_over", no, " ".join(rest[1:]))
            if rest[0] == "Time":
                return ("time", no, int(rest[1]), int(rest[2]))
        return None


class TcpTransport:
    """Blocking line-based TCP transport (playtak.com:10000).

    `readline` raises `socket.timeout` when no full line arrives within
    `timeout` (the bot ponders then) and can be called again afterwards.
    The reference's copy reads through `socket.makefile`, whose reader is
    dead after its first timeout ("cannot read from timed out object"), so
    there pondering over a real socket ends the connection; this one keeps
    its own buffer over `recv`."""

    def __init__(self, host: str = "playtak.com", port: int = 10000,
                 timeout: float | None = None):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self._buf = b""

    def send(self, line: str) -> None:
        self.sock.sendall((line + "\n").encode())

    def readline(self) -> str:
        """The next line with its newline; "" once the server closed."""
        while b"\n" not in self._buf:
            chunk = self.sock.recv(4096)
            if not chunk:
                line, self._buf = self._buf, b""
                return line.decode()
            self._buf += chunk
        line, _, self._buf = self._buf.partition(b"\n")
        return line.decode() + "\n"

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
