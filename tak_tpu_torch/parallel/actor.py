"""Sharded self-play: game slots split over the ranks (counterpart of
`tak_tpu/parallel/actor.py`).

In the JAX package sharding self-play is pure layout: XLA places the
game axis over the mesh and the results are those of one device.  Here
each rank holds its block of the game slots on its own device, so every
kernel (the fused step, the tree waves) and the network run on that
rank's rows only, while the host loop of `SelfPlayActor.run` stays
replicated: it reads back every rank's rows (`gather`), takes the same
decisions on every rank and hands each rank its rows of them (`local`).
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from .mesh import gather_rows, row_range


class ShardedEnv:
    """The batched environment on this rank's rows of a `batch`-game batch
    (all of them without a mesh)."""

    def __init__(self, engine, mesh, batch: int, device):
        self.engine = engine
        self.mesh = mesh
        self.device = device
        self.rows = row_range(mesh, batch)

    def initial_batch(self, half_komi: int = 0):
        """This rank's rows of a fresh batch."""
        return self.engine.initial_batch(self.rows.stop - self.rows.start,
                                         half_komi, self.device)

    def local(self, host) -> torch.Tensor:
        """This rank's rows of a host array over the whole batch, on the
        device (a copy that waits for the card's queue)."""
        with span("env.upload", sync=True):
            return torch.as_tensor(host[self.rows], device=self.device)

    def step(self, states, actions, enabled=None):
        """Step this rank's rows by its rows of the host arrays `actions`
        and `enabled` over the whole batch."""
        return self.engine.step(
            states, self.local(actions),
            None if enabled is None else self.local(enabled))

    def legal_mask(self, states) -> torch.Tensor:
        """Bool [rows, A]: the legal actions of this rank's rows
        (`Engine.legal_mask`; a finished game's row is not cleared)."""
        return self.engine.legal_mask(states)

    def gather(self, x):
        """Every rank's rows of a tensor or `GameState`, in slot order."""
        return gather_rows(self.mesh, x)
