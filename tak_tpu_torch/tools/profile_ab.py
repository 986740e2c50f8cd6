"""Single-process A/B of full run_sims searches across search configs
(counterpart of `tools/profile_ab.py`).

Measures whole searches (init + prepare_root excluded; run_sims only, on
a fresh copy of the prepared trees each time), interleaved A/B/A/B to
cancel drift, reporting sims/s per variant.

    BENCH_AB=topk python -m tak_tpu_torch.tools.profile_ab [--cpu]

Knobs (environment variables, the JAX script's names and defaults):
BENCH_SIZE (6), BENCH_MCTS_BATCH (256), BENCH_MCTS_WAVE (16),
BENCH_MCTS_K (64), BENCH_MCTS_SIMS (512), BENCH_AB_ROUNDS (3), BENCH_AB
(the pair: `topk` (default), `topkq` or `fused-legal`; the last runs the
fused step with legal bits, which on a card the exact top-K takes with
the option on or off).  `kind=` prints `MCTS.tier`.  Runs on the
CUDA device unless `--cpu` is given.
"""

from __future__ import annotations

import dataclasses
import os

from ..bench import mcts_roots
from ..engine.core import Engine
from ..mcts.search import MCTS, SearchConfig
from ..model.network import Network
from .timing import clock, knob, open_device, parser

# BENCH_AB picks the variant pair: each entry is name -> config overrides
PAIRS = {
    "fused-legal": {
        "fused-legal": dict(fused_leaf_legal=True),
        "xla-legal": dict(fused_leaf_legal=False),
    },
    "topk": {
        "topk-packed": dict(topk_impl="packed"),
        "topk-exact": dict(topk_impl="exact"),
    },
    "topkq": {
        "topk-packedq": dict(topk_impl="packedq"),
        "topk-exact": dict(topk_impl="exact"),
    },
}


def main(argv=None, env=None):
    """Returns {variant: (ms per search, sims/s)}."""
    env = os.environ if env is None else env
    args = parser("profile_ab", __doc__).parse_args(argv)
    pair = env.get("BENCH_AB", "topk")
    if pair not in PAIRS:
        raise SystemExit(
            f"unknown BENCH_AB={pair!r}; valid pairs: {', '.join(sorted(PAIRS))}"
        )
    device = open_device(args.cpu)
    N = knob(env, "BENCH_SIZE", 6)
    B = knob(env, "BENCH_MCTS_BATCH", 256)
    V = knob(env, "BENCH_MCTS_WAVE", 16)
    K = knob(env, "BENCH_MCTS_K", 64)
    SIMS = knob(env, "BENCH_MCTS_SIMS", 512)
    ROUNDS = knob(env, "BENCH_AB_ROUNDS", 3)

    engine = Engine(N)
    net = Network(engine, device=device)
    variables = net.init_variables(0)
    base = SearchConfig(num_sims=SIMS, wave_size=V, max_children=K)
    variants = {name: dataclasses.replace(base, **kw)
                for name, kw in PAIRS[pair].items()}
    states = mcts_roots(engine, B, device)

    searchers = {}
    for name, cfg in variants.items():
        m = MCTS(engine, net.policy_eval_states, cfg)
        tree = m.prepare_root(variables, m.init_batch(states))
        searchers[name] = (m, tree)
        clock(m.run_sims, device, lambda: (variables, tree.clone()))
        print(f"{name}: compiled (kind={m.tier})", flush=True)

    times = {name: 0.0 for name in variants}
    for _ in range(ROUNDS):
        for name, (m, tree) in searchers.items():
            times[name] += clock(m.run_sims, device,
                                 lambda: (variables, tree.clone()))[1]

    sims = B * base.num_waves * V * ROUNDS
    out = {}
    for name, t in times.items():
        out[name] = (t / ROUNDS * 1e3, sims / t)
        print(f"{name:14s} {t / ROUNDS * 1e3:9.1f} ms/search   "
              f"{sims / t:,.0f} sims/s", flush=True)
    return out


if __name__ == "__main__":
    main()
