"""Self-play cells of the SE-ResNet (`configs/lc0se-*.json`): the loop,
window, spans and captures of `drivers/selfplay.py`, run on the port's
network built with the configuration's `se_channels`, on random weights
from the seed (`reference/se_net.py` `random_se_flax`; the configuration
names no weights file), and held against the SE reference.

A private copy of `drivers/selfplay.py` is loaded and given three
stand-ins for its modules: `program` with this file's `flax_weights` and
`network`, `net` the SE reference, and a private copy of `checks.py`
whose network comparison runs the SE reference.  Nothing else differs,
so both self-play drivers measure and compare the same things.
"""

from __future__ import annotations

import types
from pathlib import Path

import torch

from benchmark import checks, harness, program
from benchmark.reference import se_net

HERE = Path(__file__).resolve().parent


def flax_weights(ctx) -> dict:
    c = ctx.config
    return se_net.random_se_flax(c["board_size"], c["filters"], c["blocks"],
                                 c["se_channels"], ctx.seed, ctx.device)


def network(ctx, tree: dict):
    """(engine, Network, variables): the port's SE network of the
    configuration, its variables read from the same tree."""
    from tak_tpu_torch.engine.core import get_engine
    from tak_tpu_torch.model.network import Network, variables_from_numpy
    from tak_tpu_torch.model.resnet import NetConfig

    c = ctx.config
    cfg = NetConfig(n=c["board_size"], filters=c["filters"],
                    blocks=c["blocks"], policy_head=c["policy_head"],
                    dtype=getattr(torch, c["compute_dtype"]),
                    se_channels=c["se_channels"])
    engine = get_engine(c["board_size"])
    nw = Network(engine, cfg, device=ctx.device)
    variables = variables_from_numpy(tree["params"], tree["batch_stats"], cfg)
    return engine, nw, {k: v.to(ctx.device) for k, v in variables.items()}


def run(ctx) -> harness.Outcome:
    base = harness.load_module(HERE / "selfplay.py",
                               "benchmark_driver_selfplay_se_base")
    se_checks = harness.load_module(Path(checks.__file__),
                                    "benchmark_checks_se")
    se_checks.net = se_net
    base.program = types.SimpleNamespace(
        **{**vars(program), "flax_weights": flax_weights,
           "network": network})
    base.net = se_net
    base.checks = se_checks
    return base.run(ctx)
