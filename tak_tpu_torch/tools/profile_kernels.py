"""Time the MCTS tree kernels in isolation (descend / expand_backup /
merged backup_descend) on the card (counterpart of
`tools/profile_kernels.py`).

    python -m tak_tpu_torch.tools.profile_kernels [--cpu]

#4 `descend_wave` on the prepared roots' trees, then #3
`expand_backup_wave` and #2 `backup_descend_wave` on the pending payload
of that wave (`MCTS._eval_and_topk`), each timed alone on fresh copies of
its tree.

Knobs (environment variables, the JAX script's names and defaults):
BENCH_SIZE (6), BENCH_MCTS_BATCH (256), BENCH_MCTS_WAVE (16),
BENCH_MCTS_K (64), BENCH_MCTS_SIMS (512).  `kind:` prints `MCTS.tier`.
Runs on the CUDA device unless `--cpu` is given.
"""

from __future__ import annotations

import os

from ..bench import mcts_roots
from ..engine.core import Engine
from ..mcts.search import MCTS, SearchConfig
from ..mcts.tree_kernels import (
    backup_descend_wave,
    descend_wave,
    expand_backup_wave,
)
from ..model.network import Network
from .timing import knob, open_device, parser, timeit


def kernel_calls(mcts: MCTS, params, tree):
    """[(label, call(tree), the tree it starts from)]: descend on `tree`,
    expand+backup and the merged backup+descend on the tree after that
    descent and `_eval_and_topk` (a real pending payload).  Each call
    writes the tree it is given; `tree` itself is left alone."""
    V = mcts.config.wave_size
    kargs = mcts._kernel_args()
    tree_e = tree.clone()
    leaves, created = descend_wave(tree_e, V, **kargs)
    pending = mcts._eval_and_topk(params, tree_e, leaves, created)
    return [
        ("descend", lambda t: descend_wave(t, V, **kargs), tree),
        ("expand_backup",
         lambda t: expand_backup_wave(t, pending, recycle=kargs["recycle"]),
         tree_e),
        ("merged backup+descend",
         lambda t: backup_descend_wave(t, pending, **kargs), tree_e),
    ]


def main(argv=None, env=None):
    """Returns {label: seconds}."""
    env = os.environ if env is None else env
    device = open_device(parser("profile_kernels", __doc__)
                         .parse_args(argv).cpu)
    N = knob(env, "BENCH_SIZE", 6)
    B = knob(env, "BENCH_MCTS_BATCH", 256)
    V = knob(env, "BENCH_MCTS_WAVE", 16)
    K = knob(env, "BENCH_MCTS_K", 64)
    SIMS = knob(env, "BENCH_MCTS_SIMS", 512)

    engine = Engine(N)
    net = Network(engine, device=device)
    variables = net.init_variables(0)
    cfg = SearchConfig(num_sims=SIMS, wave_size=V, max_children=K)
    mcts = MCTS(engine, net.policy_eval_states, cfg)
    if mcts.tier != "pool":
        raise SystemExit(f"tier {mcts.tier!r}: these are the pool tier's "
                         "kernels")
    start = mcts_roots(engine, B, device)
    tree = mcts.prepare_root(variables, mcts.init_batch(start))
    print("kind:", mcts.tier, "max_nodes:", cfg.max_nodes, flush=True)
    out = {}
    for label, call, src in kernel_calls(mcts, variables, tree):
        _, out[label] = timeit(label, call, device,
                               setup=lambda: (src.clone(),), width=34)
    return out


if __name__ == "__main__":
    main()
