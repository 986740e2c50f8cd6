"""End-to-end self-play throughput at (scaled) reference config
(counterpart of `tools/profile_selfplay.py`).

Measures whole SelfPlayActor moves - search + move selection + example
capture + tree re-rooting - on the card, reporting sims/s and moves/s.

    python -m tak_tpu_torch.tools.profile_selfplay [--cpu]

Knobs (environment variables, the JAX script's names and defaults):
BENCH_SIZE (6), SP_WORKERS (32, reference self_play.rs:94), SP_SIMS
(10000, self_play.rs:12), SP_MOVES (6), SP_WAVE (16), SP_K (128),
SP_RECYCLE=1 (node-recycled pool tier), SP_BUDGET (pool override), SP_KEEP
(reroot carry cap), SP_WARM_MOVES (2: moves before the clock starts),
TAK_PROFILE_MOVES (set: print the actor's log).  At the defaults the tree
(20,002 nodes, no recycling) takes the large-tree tier; `backend=` prints
`MCTS.tier`.  Runs on the CUDA device unless `--cpu` is given.
"""

from __future__ import annotations

import os
import time

from ..engine.core import get_engine
from ..mcts.search import SearchConfig
from ..model.network import Network
from ..selfplay import SelfPlayActor, SelfPlayConfig
from ..utils.device import synchronize
from .timing import flag, knob, open_device, parser


class StopAfter(Exception):
    """Ends the self-play run once the timed moves are done."""


def main(argv=None, env=None):
    """Returns {"ms_per_move", "sims_per_s", "tier"}."""
    env = os.environ if env is None else env
    device = open_device(parser("profile_selfplay", __doc__)
                         .parse_args(argv).cpu)
    N = knob(env, "BENCH_SIZE", 6)
    WORKERS = knob(env, "SP_WORKERS", 32)
    SIMS = knob(env, "SP_SIMS", 10000)
    MOVES = knob(env, "SP_MOVES", 6)
    WAVE = knob(env, "SP_WAVE", 16)
    K = knob(env, "SP_K", 128)
    RECYCLE = flag(env, "SP_RECYCLE")
    BUDGET = knob(env, "SP_BUDGET", 0) or None
    KEEP = knob(env, "SP_KEEP", 0) or None
    # the first searches pay cuDNN's autotuning at new row counts
    WARM_MOVES = knob(env, "SP_WARM_MOVES", 2)

    engine = get_engine(N)
    net = Network(engine, device=device)
    variables = net.init_variables(0)
    cfg = SelfPlayConfig(
        games=10_000_000,  # never finishes; we stop by move count
        workers=WORKERS,
        search=SearchConfig(num_sims=SIMS, wave_size=WAVE, max_children=K,
                            recycle=RECYCLE, node_budget=BUDGET,
                            reroot_keep=KEEP),
    )
    actor = SelfPlayActor(engine, net.policy_eval_states, cfg, device=device)
    print(f"workers={WORKERS} sims={SIMS} wave={WAVE} k={K} "
          f"backend={actor.mcts.tier} nodes={actor.search_config.max_nodes}",
          flush=True)

    clock = {"moves": 0}
    orig_run_sims = actor.mcts.run_sims

    def counting_run_sims(params, tree):
        out = orig_run_sims(params, tree)
        synchronize(device)
        clock["moves"] += 1
        if clock["moves"] == WARM_MOVES:
            clock["t"] = time.perf_counter()
            print(f"warmup done ({WARM_MOVES} moves: compile+search)",
                  flush=True)
        if clock["moves"] >= MOVES + WARM_MOVES:
            raise StopAfter
        return out

    actor.mcts.run_sims = counting_run_sims
    t0 = time.perf_counter()
    clock.setdefault("t", t0)
    try:
        actor.run(variables, seed=0,
                  log=print if env.get("TAK_PROFILE_MOVES")
                  else lambda *a, **k: None)
    except StopAfter:
        pass
    else:
        raise RuntimeError(f"self-play ended after {clock['moves']} moves")
    dt = time.perf_counter() - clock["t"]
    per_move = dt / MOVES
    sims_s = WORKERS * SIMS / per_move
    print(f"moves timed: {MOVES}  {per_move * 1e3:,.0f} ms/move  "
          f"{sims_s:,.0f} sims/s  "
          f"({WORKERS * 60 / per_move:,.1f} worker-moves/min)", flush=True)
    return {"ms_per_move": per_move * 1e3, "sims_per_s": sims_s,
            "tier": actor.mcts.tier}


if __name__ == "__main__":
    main()
