"""Grid of run_sims throughput vs (node_budget, wave_size, scan_chunk)
(counterpart of `tools/profile_recycle_grid.py`).

Finds where the recycled pool tier's per-wave cost goes at the reference
self-play config (B=32 workers, 10k rollouts, K=32): pool size (tree
bytes), wave size (launch amortization), and chunk host-loop overhead.
Each search runs on a fresh copy of the prepared trees.

    GRID="[(1280,16,512)]" python -m tak_tpu_torch.tools.profile_recycle_grid [--cpu]

Knobs (environment variables, the JAX script's names and defaults):
BENCH_SIZE (6), SP_WORKERS (32), SP_SIMS (10000), GRID (a Python list of
(budget, wave, chunk[, recycle]) tuples, default
"[(1280,16,512),(768,16,512)]"; chunk 0 = no chunking, recycle defaults
to 1).  Runs on the CUDA device unless `--cpu` is given.
"""

from __future__ import annotations

import ast
import os

from ..bench import mcts_roots
from ..engine.core import get_engine
from ..mcts.search import MCTS, SearchConfig
from ..model.network import Network
from .timing import clock, knob, open_device, parser

REPS = 2


def main(argv=None, env=None):
    """Returns [(budget, wave, chunk, recycle, ms per search, sims/s)]."""
    env = os.environ if env is None else env
    device = open_device(parser("profile_recycle_grid", __doc__)
                         .parse_args(argv).cpu)
    N = knob(env, "BENCH_SIZE", 6)
    B = knob(env, "SP_WORKERS", 32)
    SIMS = knob(env, "SP_SIMS", 10000)
    configs = ast.literal_eval(env.get("GRID",
                                       "[(1280,16,512),(768,16,512)]"))

    engine = get_engine(N)
    net = Network(engine, device=device)
    variables = net.init_variables(0)
    start = mcts_roots(engine, B, device)

    out = []
    for tup in configs:
        budget, wave, chunk = tup[:3]
        rec = bool(tup[3]) if len(tup) > 3 else True
        cfg = SearchConfig(num_sims=SIMS, wave_size=wave, max_children=32,
                           recycle=rec, node_budget=budget,
                           scan_chunk=chunk or None)
        mcts = MCTS(engine, net.policy_eval_states, cfg)
        tree = mcts.prepare_root(variables, mcts.init_batch(start))
        _, t_first = clock(mcts.run_sims, device,
                           lambda: (variables, tree.clone()))
        dt = sum(clock(mcts.run_sims, device,
                       lambda: (variables, tree.clone()))[1]
                 for _ in range(REPS)) / REPS
        rate = B * SIMS / dt
        out.append((budget, wave, chunk, rec, dt * 1e3, rate))
        print(f"budget={budget:5d} wave={wave:3d} chunk={chunk:5d} "
              f"rec={int(rec)} {dt*1e3:9.1f} ms/search  "
              f"{rate/1e3:7.1f}k sims/s (first call {t_first:.1f}s)",
              flush=True)
    return out


if __name__ == "__main__":
    main()
