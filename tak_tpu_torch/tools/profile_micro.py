"""Micro-timings for wave sub-components on the card (counterpart of
`tools/profile_micro.py`).

    python -m tak_tpu_torch.tools.profile_micro [--cpu]

At 4,096 rows of the harnesses' roots (6x6, no knobs, as the JAX
script): `Engine.legal_mask`, the exact top-K of `masked_topk` over a
uniform policy (numpy seed 0; the JAX script draws it unseeded), the step
with its result (`Engine.step`: the fused step #1), `compute_result`,
`roads` and `observe`.  The JAX script's "topk approx" line times
`jax.lax.approx_max_k`, an operation of the TPU with no PyTorch
counterpart: it is left out.  Runs on the CUDA device unless `--cpu` is
given.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..bench import mcts_roots
from ..engine.core import Engine
from ..engine.observe import observe
from ..mcts.search import masked_topk
from .timing import open_device, parser, timeit

N = 6
BV = 4096
K = 64


def main(argv=None, env=None):
    """Returns {label: seconds}.  `env` is unused: the JAX script has no
    knobs."""
    device = open_device(parser("profile_micro", __doc__).parse_args(argv).cpu)
    engine = Engine(N)
    states = mcts_roots(engine, BV, device)
    t = {}

    def part(name, fn, *args):
        out, t[name] = timeit(name, fn, device, *args, reps=30)
        return out

    legal = part("legal_mask", engine.legal_mask, states)
    policy = torch.as_tensor(np.random.default_rng(0).random(
        (BV, engine.num_actions), np.float32), device=device)
    part("topk exact", masked_topk, policy, legal, K, "exact")
    actions = torch.argmax(torch.where(legal, policy, -1.0), -1).to(
        torch.int32)
    stepped = part("step (incl result)", engine.step, states, actions)
    part("compute_result (roads)", engine.compute_result, stepped)
    part("roads alone", engine.roads, stepped)
    part("observe", observe, engine, states)
    return t


if __name__ == "__main__":
    main()
