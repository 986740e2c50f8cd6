"""Time each component of one MCTS wave on the card (counterpart of
`tools/profile_wave.py`).

    python -m tak_tpu_torch.tools.profile_wave [--cpu]
    BENCH_RECYCLE=1 python -m tak_tpu_torch.tools.profile_wave [--cpu]

The components, each timed alone on fresh copies of the tree where it
writes the tree (the JAX call in brackets):
  * descend: the tier's descent kernel (`mcts._descend`): #4
    `descend_wave` on the pool tier, #8 `descend_wave_hbm` on the
    large-tree tier;
  * leaf env step: `MCTS._leaf_states_of`: the fused step #1, or on a
    card with the exact top-K the step with legal bits #5;
  * observe (`Network.observe_batch`), nn forward (`Network.policy_eval`);
  * legal+topk: `Engine.legal_mask` + `masked_topk(..., "exact")`
    (`jax.lax.top_k`), then the production split: the legal mask alone and
    `masked_topk(..., "packedq")` alone (the search itself, on a card with
    the exact top-K, runs the legal top-K kernel #12 on #5's words);
  * write+expand_backup: `MCTS._write_nodes` + the tier's expand+backup
    kernel (#3, or #9);
  * FULL WAVE: the same chain in one call (`mcts._wave`), then the sum of
    the parts and sims/s from the full wave.

Knobs (environment variables, the JAX script's names and defaults):
BENCH_SIZE (6), BENCH_MCTS_BATCH (256), BENCH_MCTS_WAVE (16),
BENCH_MCTS_K (64), BENCH_MCTS_SIMS (512), BENCH_RECYCLE (0; 1 = the
recycled pool of self-play), BENCH_BUDGET (1280, with BENCH_RECYCLE),
BENCH_SCAN_CHUNK, BENCH_SUSTAIN (default BENCH_RECYCLE: run one search
first, so that the components are timed on a deep tree, and print the
pool's fill).  As in the JAX script, that one search creates at most
BENCH_MCTS_SIMS nodes: at the defaults 513 of the 1,280 are in use and
no create evicts.  The sustained regime, every create evicting, needs
BENCH_MCTS_SIMS of at least the budget (e.g. 2048).  The line
`use_pallas:` prints `MCTS.tier`, and the descent's label names it.
Runs on the CUDA device unless `--cpu` is given.
"""

from __future__ import annotations

import os

import torch

from ..bench import mcts_roots
from ..engine.core import Engine
from ..mcts.search import MCTS, SearchConfig, masked_topk
from ..mcts.tree_kernels import Pending, descend_wave, expand_backup_wave
from ..mcts.tree_kernels_hbm import descend_wave_hbm, expand_backup_wave_hbm
from ..model.network import Network
from ..model.resnet import NetConfig
from .timing import flag, knob, open_device, parser, timeit


class Wave:
    """One wave of `mcts`'s kernel tier as separately callable parts, each
    writing the tree in place.  `forward(observe(states))` must equal
    `mcts.eval_fn(params, states)`: then `chain` and `full` leave equal
    trees."""

    def __init__(self, mcts: MCTS, observe, forward):
        self.mcts = mcts
        self.observe = observe
        self.forward = forward
        cfg = mcts.config
        if mcts.tier == "pool":
            kargs = mcts._kernel_args()
            self.descend = lambda t: descend_wave(t, cfg.wave_size, **kargs)
            self.expand_backup = lambda t, p: expand_backup_wave(
                t, p, recycle=kargs["recycle"])
        elif mcts.tier == "hbm":
            kargs = dict(base=float(cfg.exploration_base),
                         init=float(cfg.exploration_init))
            self.descend = lambda t: descend_wave_hbm(t, cfg.wave_size,
                                                      **kargs)
            self.expand_backup = expand_backup_wave_hbm
        else:
            raise ValueError(f"tier {mcts.tier!r}: the components are the "
                             "kernel tiers' (pool, hbm)")

    def descend_part(self, tree):
        """(tree, leaves, created) after the wave's descents."""
        leaves, created = self.descend(tree)
        return tree, leaves, created

    def leaf_step(self, tree, leaves):
        """The leaves' states, flat [B*V]."""
        return self.mcts._leaf_states_of(tree, leaves)[0]

    def legal_topk(self, flat, policy):
        legal = self.mcts.engine.legal_mask(flat)
        return masked_topk(policy, legal, self.mcts.config.max_children,
                           "exact")

    def write_expand_backup(self, tree, leaves, created, flat, vals, aidx,
                            value):
        B, V = leaves.shape
        K = self.mcts.config.max_children
        results = flat.result.reshape(B, V)
        self.mcts._write_nodes(tree, leaves, created, flat, results)
        self.expand_backup(tree, Pending(
            leaves=leaves.to(torch.int32).contiguous(),
            topk_vals=vals.reshape(B, V, K).contiguous(),
            topk_aidx=aidx.reshape(B, V, K).contiguous(),
            results=results.contiguous(),
            values=value.float().reshape(B, V).contiguous(),
            to_move=flat.to_move.reshape(B, V).contiguous()))
        return tree

    def chain(self, tree):
        """Every component in turn on `tree`."""
        tree, leaves, created = self.descend_part(tree)
        flat = self.leaf_step(tree, leaves)
        policy, value = self.forward(self.observe(flat))
        vals, aidx = self.legal_topk(flat, policy)
        return self.write_expand_backup(tree, leaves, created, flat, vals,
                                        aidx, value)

    def full(self, params, tree):
        """The whole wave in one call: descend, `MCTS._eval_and_topk`,
        expand+backup."""
        leaves, created = self.descend(tree)
        self.expand_backup(tree, self.mcts._eval_and_topk(params, tree,
                                                          leaves, created))
        return tree


def main(argv=None, env=None):
    """Returns {component label: seconds}, "sims_per_s" included."""
    env = os.environ if env is None else env
    device = open_device(parser("profile_wave", __doc__).parse_args(argv).cpu)
    N = knob(env, "BENCH_SIZE", 6)
    B = knob(env, "BENCH_MCTS_BATCH", 256)
    V = knob(env, "BENCH_MCTS_WAVE", 16)
    K = knob(env, "BENCH_MCTS_K", 64)
    SIMS = knob(env, "BENCH_MCTS_SIMS", 512)
    RECYCLE = flag(env, "BENCH_RECYCLE")
    BUDGET = knob(env, "BENCH_BUDGET", 1280)
    SCAN_CHUNK = knob(env, "BENCH_SCAN_CHUNK", 0) or None
    SUSTAIN = flag(env, "BENCH_SUSTAIN", "1" if RECYCLE else "0")

    engine = Engine(N)
    net = Network(engine, NetConfig.for_size(N), device=device)
    variables = net.init_variables(0)
    cfg = SearchConfig(num_sims=SIMS, wave_size=V, max_children=K,
                       recycle=RECYCLE, node_budget=BUDGET if RECYCLE else None,
                       scan_chunk=SCAN_CHUNK)
    mcts = MCTS(engine, net.policy_eval_states, cfg)
    start = mcts_roots(engine, B, device)
    tree = mcts.prepare_root(variables, mcts.init_batch(start))
    if SUSTAIN:
        # one search first: the pool is full (every create evicts) when
        # the search's sims reach the budget
        mcts.run_sims(variables, tree)
        print("pool fill:", int(tree.next_free.min()), "/", cfg.max_nodes)
    print("use_pallas:", mcts.tier, "max_nodes:", cfg.max_nodes,
          "recycle:", RECYCLE, "sustained:", SUSTAIN, flush=True)

    wave = Wave(mcts, net.observe_batch,
                lambda planes: net.policy_eval(variables, planes))
    t = {}

    def part(name, fn, *args, setup=None):
        out, t[name] = timeit(name, fn, device, *args, setup=setup)
        return out

    (tree_d, leaves, created) = part(f"descend ({mcts.tier})",
                                     wave.descend_part,
                                     setup=lambda: (tree.clone(),))
    flat = part("leaf env step", wave.leaf_step, tree_d, leaves)
    planes = part("observe", net.observe_batch, flat)
    policy, value = part("nn forward", wave.forward, planes)
    vals, aidx = part("legal+topk", wave.legal_topk, flat, policy)
    # the production split: legal alone vs packedq top-k alone
    legal = part("  legal_mask alone", engine.legal_mask, flat)
    part("  masked_topk packedq", masked_topk, policy, legal, K, "packedq")
    part("write+expand_backup", wave.write_expand_backup,
         setup=lambda: (tree_d.clone(), leaves, created, flat, vals, aidx,
                        value))
    part("FULL WAVE", wave.full, setup=lambda: (variables, tree.clone()))

    parts = sum(t[k] for k in (f"descend ({mcts.tier})", "leaf env step",
                               "observe", "nn forward", "legal+topk",
                               "write+expand_backup"))
    print(f"{'sum of parts':30s} {parts * 1e3:8.2f} ms")
    print(f"sims/s from full wave: {B * V / t['FULL WAVE']:,.0f}", flush=True)
    return {**t, "sum of parts": parts, "sims_per_s": B * V / t["FULL WAVE"]}


if __name__ == "__main__":
    main()
