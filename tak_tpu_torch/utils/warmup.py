"""Warm up a configuration's whole generation once (counterpart of
`tak_tpu/utils/warmup.py`).

Runs every stage a self-play + train + pit generation runs, with the
shapes the real run will use, and logs each stage's wall time under the
JAX package's stage names; `cli/warmup.py` is its command line.

What lasts, and for whom: the kernel build (`kernels.build.build()`, the
first stage on CUDA: five `nvcc` runs into `build/tak_tpu_torch/`) is on
disk, so it serves every later process of the checkout.  The rest only
helps the process that runs it: the CUDA context, cuDNN's autotuned
algorithm for each convolution shape (`torch.backends.cudnn.benchmark`)
and the caching allocator's pools live and die with the process.  A
training run therefore gains from this module as a separate command only
through the build; called in-process before the run, it moves the
first-use costs out of the first generation's timings.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..mcts.reuse import blank_trees
from ..mcts.search import MCTS
from ..selfplay import SelfPlayActor, SelfPlayConfig
from .device import synchronize


def _timed(log, device, name, fn):
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    log(f"[warmup] {name}: {time.perf_counter() - t0:.3f}s")
    return out


def warmup_selfplay(engine, network, cfg: SelfPlayConfig, variables=None,
                    log=print):
    """One pass over every stage of a self-play move (one actor)."""
    variables = variables or network.init_variables(0)
    dev = network.device
    actor = SelfPlayActor(engine, network.policy_eval_states, cfg, device=dev)
    B = cfg.workers
    gen = torch.Generator(device=dev).manual_seed(0)
    active = np.ones(B, bool)
    mask = torch.ones(B, dtype=torch.bool, device=dev)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)

    def timed(name, fn):
        return _timed(log, dev, name, fn)

    states = engine.initial_batch(B, 2 * cfg.komi, dev)
    states = timed("masked_step", lambda: engine.step(states, zeros, mask))
    corner = torch.full((B,), engine.num_squares - 1, dtype=torch.int32,
                        device=dev)
    states = engine.step(states, corner, mask)
    timed("wins_in_one", lambda: engine.wins_in_one(states))
    timed("legal_mask", lambda: engine.legal_mask(states))

    mcts = actor.mcts
    tree = timed("init_batch", lambda: mcts.init_batch(states))
    tree = timed("prepare_root", lambda: mcts.prepare_root(variables, tree))
    tree = timed("add_noise", lambda: mcts.add_noise(
        gen, tree, cfg.noise_alpha, cfg.noise_ratio, mask))
    tree = timed("run_sims (the big one)",
                 lambda: mcts.run_sims(variables, tree))
    acts = timed("select_moves", lambda: mcts.select_moves(gen, tree, mask))
    # the move tail (visit targets + snapshot + step + reroot + any-win,
    # read back together): the JAX package's fused `move_bundle`
    tree, stepped, _ = timed("move_bundle", lambda: actor._move_tail(
        tree, states, acts, active))
    if cfg.tree_reuse:
        timed("tree_reset", lambda: blank_trees(tree, stepped, mask))
    timed("env_reset", lambda: actor._reset(stepped, active))
    return actor


def warmup_train(engine, network, variables=None, chunk_size: int = 500,
                 log=print):
    """One training chunk and one optimizer step at the real chunk size."""
    variables = variables or network.init_variables(0)
    dev = network.device
    model = network._train_model(variables)
    opt = network.make_optimizer(model.parameters())
    states = engine.initial_batch(chunk_size, 0, dev)
    acts = torch.zeros((chunk_size, 1), dtype=torch.int64, device=dev)
    vis = torch.ones((chunk_size, 1), dtype=torch.float32, device=dev)
    z = torch.zeros(chunk_size, dtype=torch.float32, device=dev)
    _timed(log, dev, f"train chunk ({chunk_size})",
           lambda: network._accum_chunk(model, states, acts, vis, z))
    _timed(log, dev, "optimizer step", opt.step)


def warmup_pit(engine, network, pit_cfg, variables=None, log=print):
    """One gating half-batch search (`pit.py` search_half) and the full
    batch's env step."""
    variables = variables or network.init_variables(0)
    dev = network.device
    mcts = MCTS(engine, network.policy_eval_states, pit_cfg.search)
    H = pit_cfg.games // 2
    gen = torch.Generator(device=dev).manual_seed(0)

    def timed(name, fn):
        return _timed(log, dev, name, fn)

    states = engine.initial_batch(H, 2 * pit_cfg.komi, dev)
    for square in (0, engine.num_squares - 1):
        states = engine.step(states, torch.full((H,), square,
                                                dtype=torch.int32, device=dev))
    tree = timed(f"pit init (H={H})", lambda: mcts.init_batch(states))
    tree = timed("pit prepare_root",
                 lambda: mcts.prepare_root(variables, tree))
    tree = timed("pit run_sims", lambda: mcts.run_sims(variables, tree))
    timed("pit select_moves", lambda: mcts.select_moves(
        gen, tree, torch.ones(H, dtype=torch.bool, device=dev)))
    full = engine.initial_batch(2 * H, 2 * pit_cfg.komi, dev)
    timed("pit step", lambda: engine.step(
        full, torch.zeros(2 * H, dtype=torch.int32, device=dev)))


def warmup_generation(engine, network, selfplay_cfg: SelfPlayConfig,
                      pit_cfg=None, chunk_size: int = 500, log=print):
    """Every stage of one training generation, on the network's device;
    on CUDA the kernel build comes first, as a stage of its own."""
    t0 = time.perf_counter()
    if network.device.type == "cuda":
        from ..kernels import build as kb

        _timed(log, network.device, "build kernels", kb.build)
    variables = network.init_variables(0)
    warmup_selfplay(engine, network, selfplay_cfg, variables, log=log)
    warmup_train(engine, network, variables, chunk_size, log=log)
    if pit_cfg is not None:
        warmup_pit(engine, network, pit_cfg, variables, log=log)
    log(f"[warmup] total {time.perf_counter() - t0:.3f}s")
