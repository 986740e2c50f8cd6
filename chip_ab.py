#!/usr/bin/env python3
"""Compare the large-tree kernels of two checkouts on one NVIDIA card.

    git archive <commit> | tar -x -C build/parent      # build/ is git-ignored
    python3 chip_ab.py build/parent

Builds `tak_tpu_torch/csrc/tree_wave_hbm.cu` of the other checkout beside
this checkout's (same C entry points), then drives, in one process and in
turns (other, this, this, other, other, this), on the `Player` at its
defaults with Net6 16x128 and seeded random weights:
  * move 1's search (800 waves, 51,200 rollouts) from a fresh tree;
  * 200 more waves from move 1's searched tree (deep leaves);
and times both libraries' descend and expand+backup kernels on that tree
(CUDA events, `chip_smoke.cuda_ms`).  The searched trees must come out the
same with both libraries.  Two versions are compared only inside one call:
two calls may land on machines whose hosts differ in speed.
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


def main(other_dir: str):
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs a card")
    from tak_tpu_torch.engine.core import get_engine
    from tak_tpu_torch.game import Game
    from tak_tpu_torch.kernels import build as kb
    from tak_tpu_torch.mcts import tree_kernels_hbm as tk
    from tak_tpu_torch.model.network import Network
    from tak_tpu_torch.model.resnet import NetConfig
    from tak_tpu_torch.player import Player

    card = cs.card_line()
    cs.log(f"card: {card}")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.benchmark = True
    source = Path(other_dir) / "tak_tpu_torch" / "csrc" / "tree_wave_hbm.cu"
    kb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    other_so = kb.BUILD_DIR / "libtree_wave_hbm-other.so"
    proc = subprocess.Popen(
        [kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(other_so), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    kb.build(("fused_step", "tree_wave_hbm"))
    out, _ = proc.communicate()
    if proc.returncode != 0:
        cs.fail(f"the other checkout's kernels did not build:\n{out}")
    other = ctypes.CDLL(str(other_so))
    for entry, (owner, argtypes) in kb.SIGNATURES.items():
        if owner == "tree_wave_hbm" and hasattr(other, entry):
            fn = getattr(other, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    libs = {"this": kb.library("tree_wave_hbm"), "other": other}

    engine = get_engine(cs.N)
    net = Network(engine, NetConfig.for_size(cs.N), device=dev)
    params = net.init_variables(cs.SEED)

    def eval_fn(p, s):
        return net.policy_eval_states(p, s)

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


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    main(sys.argv[1])
