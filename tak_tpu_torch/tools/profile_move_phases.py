"""Per-phase timing of one self-play move at small worker counts
(counterpart of `tools/profile_move_phases.py`).

Times init_batch / prepare_root / add_noise / run_sims / select_moves and
the move tail separately (a synchronization after each) to locate where
B=32 self-play moves spend their time.  The move tail is
`SelfPlayActor._move_tail`: the root targets (`_root_targets`), the step,
the reroot, the next any-win flag and their one readback, the JAX
package's `_move_bundle` and its `device_get`; its line keeps the label
`move_bundle`.

    python -m tak_tpu_torch.tools.profile_move_phases [--cpu]

Knobs (environment variables, the JAX script's names and defaults):
BENCH_SIZE (6), SP_WORKERS (32), SP_SIMS (512), SP_WAVE (16), SP_K (32),
SP_RECYCLE (1), SP_BUDGET, REPS (3, after one untimed warm-up).
`backend=` prints `MCTS.tier`.  Runs on the CUDA device unless `--cpu` is
given.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..engine.core import get_engine
from ..mcts.search import SearchConfig
from ..model.network import Network
from ..selfplay import SelfPlayActor, SelfPlayConfig
from ..utils.device import synchronize
from .timing import flag, knob, open_device, parser


def main(argv=None, env=None):
    """Returns {phase: mean ms}, "TOTAL" and "sims_per_s" included."""
    env = os.environ if env is None else env
    device = open_device(parser("profile_move_phases", __doc__)
                         .parse_args(argv).cpu)
    N = knob(env, "BENCH_SIZE", 6)
    B = knob(env, "SP_WORKERS", 32)
    SIMS = knob(env, "SP_SIMS", 512)
    WAVE = knob(env, "SP_WAVE", 16)
    K = knob(env, "SP_K", 32)
    RECYCLE = flag(env, "SP_RECYCLE", "1")
    BUDGET = knob(env, "SP_BUDGET", 0) or None
    REPS = knob(env, "REPS", 3)

    engine = get_engine(N)
    net = Network(engine, device=device)
    variables = net.init_variables(0)
    cfg = SelfPlayConfig(
        games=10**9, workers=B,
        search=SearchConfig(num_sims=SIMS, wave_size=WAVE, max_children=K,
                            recycle=RECYCLE, node_budget=BUDGET),
    )
    actor = SelfPlayActor(engine, net.policy_eval_states, cfg, device=device)
    mcts = actor.mcts
    print(f"B={B} sims={SIMS} wave={WAVE} k={K} recycle={RECYCLE} "
          f"backend={mcts.tier} nodes={actor.search_config.max_nodes}",
          flush=True)

    ones = torch.ones(B, dtype=torch.bool, device=device)
    states = engine.initial_batch(B, 4, device)
    states = engine.step(states, torch.zeros(B, dtype=torch.int32,
                                             device=device), ones)
    states = engine.step(states, torch.full((B,), engine.num_squares - 1,
                                            dtype=torch.int32, device=device),
                         ones)
    gen = torch.Generator(device=device).manual_seed(0)
    active = np.ones(B, bool)
    phases: dict[str, list[float]] = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        synchronize(device)
        phases.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    for rep in range(REPS + 1):
        if rep == 1:
            phases.clear()  # rep 0 = warm-up (cuDNN autotuning)
        tree = timed("init_batch", mcts.init_batch, states)
        tree = timed("prepare_root", mcts.prepare_root, variables, tree)
        tree = timed("add_noise", mcts.add_noise, gen, tree, 0.2, 0.3, ones)
        tree = timed("run_sims", mcts.run_sims, variables, tree)
        actions = timed("select_moves", mcts.select_moves, gen, tree, ones)
        # the move tail: visit targets + snapshot + step + reroot +
        # next-move any-win, ONE readback for everything (selfplay.py)
        timed("move_bundle", actor._move_tail, tree, states, actions, active)

    out = {}
    total = 0.0
    for name, ts in phases.items():
        avg = sum(ts) / len(ts)
        total += avg
        out[name] = avg * 1e3
        print(f"  {name:18s} {avg * 1e3:8.1f} ms")
    print(f"  {'TOTAL':18s} {total * 1e3:8.1f} ms/move "
          f"({B * SIMS / total:,.0f} sims/s)", flush=True)
    return {**out, "TOTAL": total * 1e3, "sims_per_s": B * SIMS / total}


if __name__ == "__main__":
    main()
