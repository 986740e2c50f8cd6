"""Host-side single-game facade over the batched engine.

Counterpart of `tak_tpu/game.py`: one position for interactive / I/O-bound
call sites (analysis REPL, protocol servers, tests), `play()` with PTN
strings or `Move`s, canonical `possible_moves()` enumeration (move_gen.rs
ordering), TPS export.

The position is a `GameState` with a leading batch axis of one, living on
the game's device, so `Player` hands `Game.state` to the batch-first
engine and search without reshaping.
"""

from __future__ import annotations

import numpy as np
import torch

from .actions import Move, parse_move
from .engine.core import Engine, get_engine
from .types import ONGOING, GameState


class IllegalMove(ValueError):
    pass


class Game:
    def __init__(self, n: int, half_komi: int = 0,
                 state: GameState | None = None, device=None):
        self.n = n
        self.engine: Engine = get_engine(n)
        self.state = (state if state is not None
                      else self.engine.initial(half_komi, device))

    @classmethod
    def with_komi(cls, n: int, komi: int, device=None) -> "Game":
        return cls(n, half_komi=2 * komi, device=device)

    @classmethod
    def from_ptn_moves(cls, n: int, moves, half_komi: int = 0,
                       device=None) -> "Game":
        game = cls(n, half_komi, device=device)
        for m in moves:
            game.play(m)
        return game

    # -- queries -------------------------------------------------------------

    @property
    def ply(self) -> int:
        return int(self.state.ply[0])

    @property
    def to_move(self) -> int:
        return int(self.state.to_move[0])

    @property
    def result(self) -> int:
        return int(self.state.result[0])

    def compute_result(self) -> int:
        """Re-derive the result from the current state (pure, like game.rs:220)."""
        return int(self.engine.compute_result(self.state)[0])

    def legal_mask(self) -> np.ndarray:
        return self.engine.legal_mask(self.state)[0].cpu().numpy()

    def legal_actions(self) -> np.ndarray:
        """Legal action ids in the reference's possible_moves order."""
        mask = self.legal_mask()
        ids = np.nonzero(mask)[0]
        key = np.asarray(self.engine.tables.canon_key)[ids]
        return ids[np.argsort(key)]

    def possible_moves(self) -> list[Move]:
        return [self.engine.tables.action_to_move(a) for a in self.legal_actions()]

    # -- play ----------------------------------------------------------------

    def play_action(self, action: int, check: bool = True) -> None:
        if check:
            if self.result != ONGOING:
                raise IllegalMove("game is over")
            if not self.legal_mask()[action]:
                from .errors import diagnose

                move = self.engine.tables.action_to_move(action)
                why = diagnose(self, move)
                reason = f": {why.value}" if why else ""
                raise IllegalMove(f"illegal move {move}{reason}")
        self.state = self.engine.step(
            self.state, torch.tensor([action], dtype=torch.int32))

    def play(self, move, check: bool = True) -> None:
        if isinstance(move, str):
            move = parse_move(move)
        if isinstance(move, Move):
            if not (0 <= move.row < self.n and 0 <= move.col < self.n):
                from .errors import PlayError

                raise IllegalMove(
                    f"illegal move {move}: {PlayError.OUT_OF_BOUNDS.value}"
                )
            move = self.engine.tables.move_to_action(move)
        self.play_action(int(move), check)

    def clone(self) -> "Game":
        # every engine function returns new tensors, so the state is shared
        return Game(self.n, state=self.state)

    def __str__(self) -> str:
        from .engine.tps import state_to_tps

        return state_to_tps(self.engine, self.state)
