"""Training examples (counterpart of the `Example` record of `tak_tpu/examples.py`).

A game snapshot (numpy GameState fields in the JAX package's layout), the
root visit counts as the unnormalized policy target, and the final game
outcome from the side-to-move's perspective (alpha-tak/src/example.rs).
`state_to_host` snapshots one position for an example.  The TPS text
codec and the replay buffer are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .engine.tps import host_fields
from .types import GameState


@dataclass
class Example:
    state: dict                      # numpy GameState fields of one game
    actions: np.ndarray              # int32 [k] visited action ids
    visits: np.ndarray               # int32 [k] visit counts
    result: float = 0.0              # +-1 / 0 from side-to-move perspective


def state_to_host(state: GameState) -> dict:
    """Numpy fields of one position (a batch of one), batch axis dropped."""
    return host_fields(state)
