#!/usr/bin/env python3
"""Compare the tree kernels of two checkouts on one NVIDIA card.

    git archive <commit> | tar -x -C build/parent      # build/ is git-ignored
    python3 chip_ab.py build/parent            # the large-tree tier
    python3 chip_ab.py build/parent --pool     # the pool tier

Builds the other checkout's `tak_tpu_torch/csrc/tree_wave_hbm.cu` (or, with
`--pool`, `tree_wave.cu`) beside this checkout's (same C entry points), then
drives both in one process, in turns (other, this, this, other, other,
this), with Net6 16x128 and seeded random weights.

The large-tree tier, on the `Player` at its defaults:
  * move 1's search (800 waves, 51,200 rollouts) from a fresh tree;
  * 200 more waves from move 1's searched tree (deep leaves);
and both libraries' descend and expand+backup kernels on that tree.

The pool tier, at the reference self-play config (`chip_smoke`'s 32 games,
10,240 rollouts, wave 256, K=32, a recycled 1,280-node pool):
  * one searched move's search from the same 32 roots, with
    `fused_leaf_legal` off and on: self-play sims/s;
and both libraries' three kernels on `chip_smoke`'s mid-search tree with
the pool full.

Kernel times are CUDA-event means (`chip_smoke.cuda_ms`).  The searched
trees must come out the same with both libraries.  Two versions are
compared only inside one call: two calls may land on machines whose hosts
differ in speed.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke as cs

WAVES = cs.P_WAVES
DEEP_WAVES = 200
ORDER = ("other", "this", "this", "other", "other", "this")


def libraries(other_dir: str, name: str, also=()):
    """{"this", "other"}: the library of `csrc/<name>.cu` built from this
    checkout and from `other_dir` (in parallel, with this checkout's
    libraries `also`)."""
    from tak_tpu_torch.kernels import build as kb

    source = Path(other_dir) / "tak_tpu_torch" / "csrc" / f"{name}.cu"
    kb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    other_so = kb.BUILD_DIR / f"lib{name}-other.so"
    proc = subprocess.Popen(
        [kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(other_so), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    kb.build((name, *also))
    out, _ = proc.communicate()
    if proc.returncode != 0:
        cs.fail(f"the other checkout's kernels did not build:\n{out}")
    other = ctypes.CDLL(str(other_so))
    for entry, (owner, argtypes) in kb.SIGNATURES.items():
        if owner == name and hasattr(other, entry):
            fn = getattr(other, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return {"this": kb.library(name), "other": other}


def network(dev):
    from tak_tpu_torch.engine.core import get_engine
    from tak_tpu_torch.model.network import Network
    from tak_tpu_torch.model.resnet import NetConfig

    engine = get_engine(cs.N)
    net = Network(engine, NetConfig.for_size(cs.N), device=dev)

    def eval_fn(p, s):
        return net.policy_eval_states(p, s)

    return engine, eval_fn, net.init_variables(cs.SEED)


def main(other_dir: str, pool: bool):
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs a card")
    card = cs.card_line()
    cs.log(f"card: {card}")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.benchmark = True
    (pool_ab if pool else player_ab)(other_dir, dev, card)


def player_ab(other_dir: str, dev, card):
    import torch

    from tak_tpu_torch.game import Game
    from tak_tpu_torch.kernels import build as kb
    from tak_tpu_torch.mcts import tree_kernels_hbm as tk
    from tak_tpu_torch.player import Player

    libs = libraries(other_dir, "tree_wave_hbm", ("fused_step",))
    engine, eval_fn, params = network(dev)

    def fresh_player():
        game = Game.with_komi(cs.N, 2, dev)
        for mv in ("a1", "f6"):
            game.play(mv)
        player = Player(
            engine, eval_fn, params, game,
            generator=torch.Generator(device=dev).manual_seed(cs.SEED))
        player.add_noise(0.2, 0.3)
        return player

    def timed_rollout(player, waves):
        cs.sync()
        t0 = time.perf_counter()
        player.rollout(waves)
        cs.sync()
        return 1e3 * (time.perf_counter() - t0) / waves

    def same(a, b, what):
        cs.compare_trees(a, b, what)

    for name in libs:                 # cuDNN autotuning, lazy module loads
        kb._LIBS["tree_wave_hbm"] = libs[name]
        timed_rollout(fresh_player(), 50)
    searched = None
    for name in ORDER:
        kb._LIBS["tree_wave_hbm"] = libs[name]
        player = fresh_player()
        ms = timed_rollout(player, WAVES)
        if searched is None:
            searched = player.tree.clone()
        same(player.tree, searched, f"move 1's tree with the {name} kernels")
        cs.log(f"{name}: move 1, {ms:.3f} ms per wave, "
               f"{64e3 / ms:,.0f} rollouts/s on {card}")
    deep = None
    for name in ORDER:
        kb._LIBS["tree_wave_hbm"] = libs[name]
        player.tree = searched.clone()
        ms = timed_rollout(player, DEEP_WAVES)
        if deep is None:
            deep = player.tree.clone()
        same(player.tree, deep, f"the deep tree with the {name} kernels")
        cs.log(f"{name}: {DEEP_WAVES} waves from move 1's searched tree, "
               f"{ms:.3f} ms per wave, {64e3 / ms:,.0f} rollouts/s on {card}")

    cfg = player.mcts.config
    V = cfg.wave_size
    kargs = dict(base=float(cfg.exploration_base),
                 init=float(cfg.exploration_init))
    after = searched.clone()
    kb._LIBS["tree_wave_hbm"] = libs["this"]
    leaves, created = tk.descend_wave_hbm(after, V, **kargs)
    pending = player.mcts._eval_and_topk(params, after, leaves, created)
    for name in ("other", "this", "this", "other"):
        kb._LIBS["tree_wave_hbm"] = libs[name]
        d = cs.cuda_ms(lambda t: tk.descend_wave_hbm(t, V, **kargs), 10,
                       searched.clone)
        b = cs.cuda_ms(lambda t: tk.expand_backup_wave_hbm(t, pending), 10,
                       after.clone)
        cs.log(f"{name}: on move 1's searched tree descend_wave_hbm "
               f"{d:.4f} ms, expand_backup_wave_hbm {b:.4f} ms on {card}")


def pool_ab(other_dir: str, dev, card):
    import dataclasses

    import numpy as np

    from tak_tpu_torch.kernels import build as kb
    from tak_tpu_torch.mcts import tree_kernels as tk
    from tak_tpu_torch.mcts.search import MCTS

    libs = libraries(other_dir, "tree_wave", ("fused_step",
                                              "fused_step_legal"))
    engine, eval_fn, params = network(dev)
    _, roots = cs.selfplay_rows(engine, np.random.default_rng(cs.SEED), dev)
    mcts, tree, pending = cs.midsearch_tree(engine, eval_fn, params, roots)
    sims = cs.GAMES * mcts.config.num_waves * mcts.config.wave_size

    def timed_search(m):
        searched = m.prepare_root(params, m.init_batch(roots))
        cs.sync()
        t0 = time.perf_counter()
        m.run_sims(params, searched)
        cs.sync()
        return time.perf_counter() - t0, searched

    for option in (False, True):
        m = MCTS(engine, eval_fn,
                 dataclasses.replace(mcts.config, fused_leaf_legal=option))
        for name in libs:             # cuDNN autotuning, lazy module loads
            kb._LIBS["tree_wave"] = libs[name]
            timed_search(m)
        first = None
        for name in ORDER:
            kb._LIBS["tree_wave"] = libs[name]
            sec, searched = timed_search(m)
            if first is None:
                first = searched
            cs.compare_trees(searched, first,
                             f"the searched trees with the {name} kernels")
            cs.log(f"{name}: one self-play move's search, fused_leaf_legal="
                   f"{option}, {sec * 1e3:.1f} ms, {sims / sec:,.0f} sims/s "
                   f"on {card}")

    kargs = dict(base=float(mcts.config.exploration_base),
                 init=float(mcts.config.exploration_init), recycle=True)
    zero = tk.Pending.zeros(cs.GAMES, cs.WAVE, cs.K, dev)
    for name in ("other", "this", "this", "other"):
        kb._LIBS["tree_wave"] = libs[name]
        ms = [cs.cuda_ms(run, 10, tree.clone) for run in (
            lambda t: tk.backup_descend_wave(t, pending, **kargs),
            lambda t: tk.backup_descend_wave(t, zero, **kargs),
            lambda t: tk.expand_backup_wave(t, pending, recycle=True))]
        cs.log(f"{name}: on the mid-search tree backup_descend_wave "
               f"{ms[0]:.4f} ms, descend_wave {ms[1]:.4f} ms, "
               f"expand_backup_wave {ms[2]:.4f} ms on {card}")


if __name__ == "__main__":
    args = sys.argv[1:]
    if len(args) not in (1, 2) or args[1:] not in ([], ["--pool"]):
        sys.exit(__doc__)
    main(args[0], pool=args[1:] == ["--pool"])
