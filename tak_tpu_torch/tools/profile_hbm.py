"""Time the large-tree tier against the "xla" path at self-play tree size
(counterpart of `tools/profile_hbm.py`).

    python -m tak_tpu_torch.tools.profile_hbm [--cpu]

Whole searches (`run_sims`, each on a fresh copy of the prepared trees):
"pallas_hbm" runs #8 `descend_wave_hbm` and #9 `expand_backup_wave_hbm`
every wave, "xla" the staggered descent in plain PyTorch (its iterations
replayed as CUDA graphs on the card).

Knobs (environment variables, the JAX script's names and defaults):
HBM_SIZE (6), HBM_BATCH (32, self_play.rs:94 WORKERS), HBM_WAVE (8),
HBM_K (96), HBM_SIMS (64: a short search, the budget is real),
HBM_BUDGET (20002: 10k rollouts + reuse), HBM_BACKENDS
("pallas_hbm,xla").  `kind=` prints `MCTS.tier`.  Runs on the CUDA device
unless `--cpu` is given.
"""

from __future__ import annotations

import os

from ..bench import mcts_roots
from ..engine.core import Engine
from ..mcts.search import MCTS, SearchConfig
from ..model.network import Network
from ..model.resnet import NetConfig
from .timing import clock, knob, open_device, parser

REPS = 3


def main(argv=None, env=None):
    """Returns {backend: (ms per search, sims/s, ms per wave)}."""
    env = os.environ if env is None else env
    device = open_device(parser("profile_hbm", __doc__).parse_args(argv).cpu)
    N = knob(env, "HBM_SIZE", 6)
    B = knob(env, "HBM_BATCH", 32)
    V = knob(env, "HBM_WAVE", 8)
    K = knob(env, "HBM_K", 96)
    SIMS = knob(env, "HBM_SIMS", 64)
    BUDGET = knob(env, "HBM_BUDGET", 20002)
    BACKENDS = env.get("HBM_BACKENDS", "pallas_hbm,xla").split(",")

    engine = Engine(N)
    net = Network(engine, NetConfig.for_size(N), device=device)
    variables = net.init_variables(0)
    start = mcts_roots(engine, B, device)

    out = {}
    for backend in BACKENDS:
        cfg = SearchConfig(num_sims=SIMS, wave_size=V, max_children=K,
                           node_budget=BUDGET, backend=backend)
        mcts = MCTS(engine, net.policy_eval_states, cfg)
        print(f"[{backend}] kind={mcts.tier} waves={cfg.num_waves} "
              f"nodes={cfg.max_nodes}", flush=True)
        tree = mcts.prepare_root(variables, mcts.init_batch(start))
        _, t_first = clock(mcts.run_sims, device,
                           lambda: (variables, tree.clone()))
        print(f"[{backend}] compile+first: {t_first:.1f}s", flush=True)
        dt = sum(clock(mcts.run_sims, device,
                       lambda: (variables, tree.clone()))[1]
                 for _ in range(REPS)) / REPS
        sims = B * cfg.num_waves * V
        out[backend] = (dt * 1e3, sims / dt, dt / cfg.num_waves * 1e3)
        print(f"[{backend}] {dt * 1e3:8.1f} ms/search  {sims / dt:,.0f} "
              f"sims/s ({dt / cfg.num_waves * 1e3:.2f} ms/wave)", flush=True)
    return out


if __name__ == "__main__":
    main()
