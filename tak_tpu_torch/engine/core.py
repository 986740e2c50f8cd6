"""Batched PyTorch Tak rules engine (counterpart of `tak_tpu/engine/core.py`).

Every function takes a batched `GameState` (leading axis B).  `step` is
the fused step (`engine/fused_env.py`), `step_legal` the fused step that
also emits the packed legal bits (`engine/legal_bits.py`), and
`env_rollout_fn` the whole random-playout loop in one kernel
(`engine/env_rollout.py`): the CUDA kernels on the card, their plain
PyTorch versions on the CPU.  `legal_mask`, `compute_result` and `roads`
are plain tensor code, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import numpy as np
import torch

from ..actions import Tables
from ..sizes import (
    default_starting_stones,
    num_patterns,
    stack_words,
    validate,
)
from ..types import CAP, FLAT, ONGOING, WALL, GameState, result_winner
from ..utils.device import resolve_device
from . import env_rollout, fused_env, legal_bits


class Engine:
    """Rules engine for one board size.  Construct once; methods are pure."""

    def __init__(self, n: int):
        validate(n)
        self.n = n
        self.tables = t = Tables(n)
        self.num_actions = t.num_actions
        self.num_squares = n * n
        self.num_pat = P = num_patterns(n)
        self.words = stack_words(n)
        self.start_stones, self.start_caps = default_starting_stones(n)

        dist = np.zeros((n * n, 4, n * n), np.int64)
        for o in range(n * n):
            for d in range(4):
                for j in range(n - 1):
                    qq = t.spread_path[o, d, j]
                    if qq < n * n:
                        dist[o, d, qq] = j + 1
        cum = np.concatenate(
            [np.zeros((P, 1), np.int64), np.cumsum(t.pat_drops, 1)[:, :-1]],
            axis=1)
        wp, kmask, smask, smashm = legal_bits.pattern_class_tables(n)
        self.pattern_words = wp          # u32 words per (square, direction)
        self._np_tables = {
            # pattern class tables of the packed legal bits: u32 values in
            # int64 for the plain version, and all three as one int32 array
            # of bit patterns for the kernels
            "kmask": kmask.astype(np.int64),                     # [n+1, wp]
            "smask": smask.astype(np.int64),                     # [n, wp]
            "smashm": smashm.astype(np.int64),                   # [n, wp]
            "legal_tables": np.ascontiguousarray(np.concatenate(
                [kmask, smask, smashm]).astype(np.uint32)).view(np.int32),
            # pattern p of a spread word group: bit p % 32 of word p // 32
            "pattern_word": np.arange(P, dtype=np.int64) // 32,  # [P]
            "pattern_bit": (np.uint32(1) << (np.arange(P) % 32).astype(
                np.uint32)).view(np.int32),                      # [P]
            "place_bit": np.array([1, 2, 4], np.int32),
            "path_dist": dist,                                   # [n2, 4, n2]
            "pat_drops": t.pat_drops.astype(np.int64),           # [P, n-1]
            "pat_cum": cum,                                      # [P, n-1]
            "pat_k": t.pat_k.astype(np.int64),                   # [P]
            "pat_s": t.pat_s.astype(np.int64),                   # [P]
            "last1": t.pat_last == 1,                            # [P]
            "spread_path": t.spread_path.astype(np.int64),       # [n2, 4, n-1]
            "spread_fits": t.spread_fits,                        # [n2, 4, P]
        }
        self._tensors: dict[str, dict] = {}

    def tensors(self, device) -> dict:
        """The static tables as tensors on `device` (cached)."""
        key = str(torch.device(device))
        if key not in self._tensors:
            self._tensors[key] = {k: torch.as_tensor(v, device=device)
                                  for k, v in self._np_tables.items()}
        return self._tensors[key]

    # -- construction -------------------------------------------------------

    def initial_batch(self, batch: int, half_komi: int = 0,
                      device=None) -> GameState:
        """`batch` fresh games (tak/src/game.rs:37-53)."""
        dev = resolve_device(device)
        n2, W = self.num_squares, self.words
        i32 = dict(dtype=torch.int32, device=dev)
        return GameState(
            stacks=torch.zeros((batch, n2, W), dtype=torch.int64, device=dev),
            heights=torch.zeros((batch, n2), **i32),
            tops=torch.zeros((batch, n2), **i32),
            to_move=torch.zeros(batch, **i32),
            ply=torch.zeros(batch, **i32),
            stones=torch.full((batch, 2), self.start_stones, **i32),
            caps=torch.full((batch, 2), self.start_caps, **i32),
            half_komi=torch.full((batch,), half_komi, **i32),
            reversible=torch.zeros(batch, **i32),
            result=torch.full((batch,), ONGOING, **i32),
        )

    def initial(self, half_komi: int = 0, device=None) -> GameState:
        """One fresh game, as a batch of one."""
        return self.initial_batch(1, half_komi, device)

    # -- queries --------------------------------------------------------------

    def roads(self, state: GameState):
        return fused_env.roads(self, state)

    def compute_result(self, state: GameState):
        return fused_env.compute_result(self, state)

    def legal_mask(self, state: GameState) -> torch.Tensor:
        """Bool [B, A] over the flat action space (move_gen.rs parity).

        Does not account for a finished game; callers gate on
        `state.result == ONGOING`."""
        n, n2, P = self.n, self.num_squares, self.num_pat
        t = self.tensors(state.device)
        B = state.ply.shape[0]
        to_move = state.to_move.long()
        opening = state.ply < 2
        color_eff = torch.where(opening, 1 - to_move, to_move)
        empty = state.heights == 0
        have_stones = state.stones.gather(1, color_eff[:, None])[:, 0] > 0
        have_caps = state.caps.gather(1, to_move[:, None])[:, 0] > 0
        place_flat = empty & have_stones[:, None]
        place_wall = place_flat & ~opening[:, None]
        place_cap = empty & (have_caps & ~opening)[:, None]

        owner = fused_env.top_colors(state)
        own = ((state.heights > 0) & (owner == state.to_move[:, None])
               & ~opening[:, None])

        cap_col = torch.full((B, 1), CAP, dtype=state.tops.dtype,
                             device=state.device)
        tops_pad = torch.cat([state.tops, cap_col], 1)
        path_tops = tops_pad[:, t["spread_path"].reshape(-1)].reshape(
            B, n2, 4, n - 1)
        passable = path_tops <= FLAT
        # before[..., j]: every square strictly closer than distance j+1 is
        # passable (a running AND; a cumprod scan is far slower on the card)
        before = [torch.ones_like(passable[..., 0])]
        for j in range(n - 2):
            before.append(before[-1] & passable[..., j])
        before = torch.stack(before, -1)
        cap_origin = (state.tops == CAP)[:, :, None, None]
        plain_ok = before & passable
        smash_ok = before & (path_tops == WALL) & cap_origin
        s_idx = t["pat_s"] - 1
        g_plain = plain_ok[..., s_idx]                       # [B, n2, 4, P]
        g_smash = smash_ok[..., s_idx]
        hk = state.heights[:, :, None] >= torch.arange(
            1, n + 1, device=state.device)
        g_height = hk[..., t["pat_k"] - 1]                   # [B, n2, P]
        spread = (own[:, :, None, None] & g_height[:, :, None, :]
                  & t["spread_fits"][None]
                  & (g_plain | (g_smash & t["last1"])))      # [B, n2, 4, P]
        return torch.cat(
            [place_flat, place_wall, place_cap,
             spread.permute(0, 2, 3, 1).reshape(B, -1)], 1)

    # -- step -----------------------------------------------------------------

    def step(self, state: GameState, action, enabled=None) -> GameState:
        """Apply one (assumed legal) action per game; finished games and
        games with `enabled` False come back unchanged."""
        return fused_env.fused_step(self, state,
                                    *_step_args(state, action, enabled))

    def step_legal(self, state: GameState, action, enabled=None):
        """`step`, plus the packed legal bits of the state it returns:
        (states, place [B, n2] int32, spread [B, 4, wp, n2] int32), the
        words of `engine/legal_bits.py`, not a dense [B, A] mask.  One
        kernel; counterpart of the JAX package's `fused_step_legal_fn`."""
        return legal_bits.step_legal(self, state,
                                     *_step_args(state, action, enabled))

    def env_rollout_fn(self, num_steps: int, *, external_bits: bool = False):
        """One-kernel (states, seed) -> states after `num_steps` uniform
        random legal steps, finished games restarting from the initial
        position with their komi (the whole env loop in one launch).  The
        seed is an int, or a `torch.Generator` from which one is drawn.
        With `external_bits` the second argument is an int64
        [num_steps, B] tensor of u32 sampling words instead."""
        def run(states: GameState, seed_or_bits):
            if external_bits:
                return env_rollout.env_rollout(self, states, num_steps,
                                               bits=seed_or_bits)
            return env_rollout.env_rollout(self, states, num_steps,
                                           seed=seed_or_bits)

        return run

    def wins_in_one(self, state: GameState) -> torch.Tensor:
        """Bool [B, A]: legal actions that win on the spot for the mover.

        Steps all B*A (game, action) probe rows through the fused step;
        illegal pairs ride its freeze path (`tak_tpu` core.py:596-695)."""
        A = self.num_actions
        B = state.ply.shape[0]
        legal = self.legal_mask(state)
        rep = state.map(lambda x: x.repeat_interleave(A, 0))
        acts = torch.arange(A, dtype=torch.int32,
                            device=state.device).repeat(B)
        stepped = self.step(rep, acts, legal.reshape(-1))
        winner = result_winner(stepped.result).reshape(B, A)
        return (winner == state.to_move[:, None]) & legal


def _step_args(state: GameState, action, enabled):
    """(action int32, enabled bool | None), contiguous on the state's
    device, as the step kernels take them."""
    action = action.to(device=state.device, dtype=torch.int32).contiguous()
    if enabled is not None:
        enabled = enabled.to(device=state.device,
                             dtype=torch.bool).contiguous()
    return action, enabled


_ENGINES: dict[int, Engine] = {}


def get_engine(n: int) -> Engine:
    if n not in _ENGINES:
        _ENGINES[n] = Engine(n)
    return _ENGINES[n]
