"""Training examples, text codec and the replay buffer (counterpart of
`tak_tpu/examples.py`).

A game snapshot (numpy GameState fields in the JAX package's layout), the
root visit counts as the unnormalized policy target, and the final game
outcome from the side-to-move's perspective (alpha-tak/src/example.rs).
The line-oriented text codec writes the same bytes as the JAX package's
and the reference's `.data` files (example.rs:81-133):

    TPS;white_stones;white_caps;black_stones;black_caps;half_komi;result;move:visits,...

States stay on the host as numpy; the network's input planes are rebuilt
on the device at training time (network.rs:59).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .engine.tps import host_fields, host_to_tps, tps_to_host
from .types import GameState


@dataclass
class Example:
    state: dict                      # numpy GameState fields of one game
    actions: np.ndarray              # int32 [k] visited action ids
    visits: np.ndarray               # int32 [k] visit counts
    result: float = 0.0              # +-1 / 0 from side-to-move perspective

    def policy_dense(self, num_actions: int) -> np.ndarray:
        pi = np.zeros(num_actions, np.float32)
        total = max(int(self.visits.sum()), 1)
        pi[self.actions] = self.visits.astype(np.float32) / total
        return pi


def state_to_host(state: GameState) -> dict:
    """Numpy fields of one position (a batch of one), batch axis dropped."""
    return host_fields(state)


def _host_to_state(d: dict, device="cpu") -> GameState:
    """One example's fields as a batch of one on `device`."""
    return GameState.from_numpy({k: np.asarray(v)[None] for k, v in d.items()},
                                device)


def stack_states(examples: list[Example], device) -> GameState:
    """Stack per-example host states into one batched GameState on
    `device`."""
    keys = examples[0].state.keys()
    return GameState.from_numpy(
        {k: np.stack([e.state[k] for e in examples]) for k in keys}, device)


def example_to_line(engine, ex: Example) -> str:
    s = ex.state
    pairs = ",".join(
        f"{engine.tables.action_to_ptn(int(a))}:{int(v)}"
        for a, v in zip(ex.actions, ex.visits)
    )
    result = f"{ex.result:g}" if ex.result != int(ex.result) else str(int(ex.result))
    return (
        f"{host_to_tps(engine, s)};{int(s['stones'][0])};{int(s['caps'][0])};"
        f"{int(s['stones'][1])};{int(s['caps'][1])};{int(s['half_komi'])};"
        f"{result};{pairs}"
    )


def line_to_example(engine, line: str) -> Example:
    tps, ws, wc, bs, bc, hk, result, policy = line.strip().split(";")
    host = tps_to_host(engine, tps, half_komi=int(hk))
    host["stones"] = np.array([int(ws), int(bs)], np.int32)
    host["caps"] = np.array([int(wc), int(bc)], np.int32)
    actions, visits = [], []
    for pair in policy.split(","):
        mv, v = pair.rsplit(":", 1)
        actions.append(engine.tables.ptn_to_action(mv))
        visits.append(int(v))
    return Example(
        state=host,
        actions=np.asarray(actions, np.int32),
        visits=np.asarray(visits, np.int32),
        result=float(result),
    )


class ReplayBuffer:
    """Newest-N example window (train/src/main.rs:26,111-115)."""

    def __init__(self, max_examples: int = 400_000):
        self.max_examples = max_examples
        self.examples: list[Example] = []

    def extend(self, new):
        self.examples.extend(new)

    def truncate(self):
        if len(self.examples) > self.max_examples:
            self.examples = self.examples[-self.max_examples:]

    def __len__(self):
        return len(self.examples)

    def save(self, engine, path: str) -> None:
        with open(path, "w") as f:
            for ex in self.examples:
                f.write(example_to_line(engine, ex) + "\n")

    def load(self, engine, path: str) -> None:
        with open(path) as f:
            for line in f:
                if line.strip():
                    self.examples.append(line_to_example(engine, line))
