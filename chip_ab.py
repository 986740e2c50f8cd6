#!/usr/bin/env python3
"""Compare the kernels of two checkouts on one NVIDIA card.

    git archive <commit> | tar -x -C build/parent      # build/ is git-ignored
    python3 chip_ab.py build/parent            # the large-tree tier
    python3 chip_ab.py build/parent --pool     # the pool tier
    python3 chip_ab.py build/parent --env      # the env kernels #1, #5-#7

Builds the other checkout's `tak_tpu_torch/csrc/tree_wave_hbm.cu` (with
`--pool`, `tree_wave.cu`; with `--env`, `fused_step.cu`,
`fused_step_legal.cu` and `env_rollout.cu`) beside this checkout's (same
C entry points), then drives both in one process, in turns (other, this,
this, other, other, this), with Net6 16x128 and seeded random weights.
The default mode needs another checkout whose large-tree backup takes
the scratch buffer of wide waves (`tak_backup_scratch_bytes`).

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

The env kernels, at 6x6 (each library's outputs held bitwise against the
plain versions first):
  * the fused step (#1) at its four shapes: one self-play wave's 8,192
    leaf rows, the instant-win scan's 289,152 probe rows of 32 roots, 64
    rows (a Player wave's leaves) and one row (`Game.play`), beside the
    launch floor (`chip_smoke.launch_floor_ms`);
  * the fused step with legal bits (#5) at 8,192 and 64 rows, and the
    legal sampler (#6) at 8,192 rows, seeded and with given words;
  * the env rollout (#7) at 8,192 rows x 64 steps, seeded;
  * env steps/s: `Engine.env_rollout_fn(64)` on 8,192 fresh games, 8
    launches after a warm-up (`chip_smoke.env_rollout_phase`);
  * the paths that launch #1 and #5: the Player's move 1 (as in the
    large-tree mode) and one self-play move's search with
    `fused_leaf_legal` off and on.

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


def libraries(other_dir: str, names, also=(), verbose=False):
    """{"this", "other"} -> {name: library of `csrc/<name>.cu`}, built from
    this checkout and from `other_dir` (all in parallel, with this
    checkout's libraries `also`); `verbose` logs this checkout's
    `-Xptxas -v` lines."""
    from tak_tpu_torch.kernels import build as kb

    kb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        source = Path(other_dir) / "tak_tpu_torch" / "csrc" / f"{name}.cu"
        other_so = kb.BUILD_DIR / f"lib{name}-other.so"
        procs[name] = other_so, subprocess.Popen(
            [kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(other_so), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    kb.build((*names, *also), verbose=verbose)
    for name, text in kb.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                cs.log(f"  ptxas {name}: {line.strip()}")
    libs = {"this": {}, "other": {}}
    for name, (other_so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            cs.fail(f"the other checkout's kernels did not build:\n{out}")
        other = ctypes.CDLL(str(other_so))
        for entry, (owner, argtypes) in kb.SIGNATURES.items():
            if owner == name and hasattr(other, entry):
                fn = getattr(other, entry)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs["this"][name] = kb.library(name)
        libs["other"][name] = other
    return libs


def use(libs, side):
    """Route the wrappers to one side's libraries."""
    from tak_tpu_torch.kernels import build as kb

    kb._LIBS.update(libs[side])


def network(dev):
    from tak_tpu_torch.engine.core import get_engine
    from tak_tpu_torch.model.network import Network
    from tak_tpu_torch.model.resnet import NetConfig

    engine = get_engine(cs.N)
    net = Network(engine, NetConfig.for_size(cs.N), device=dev)

    def eval_fn(p, s):
        return net.policy_eval_states(p, s)

    return engine, eval_fn, net.init_variables(cs.SEED)


def main(other_dir: str, mode: str):
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs a card")
    card = cs.card_line()
    cs.log(f"card: {card}")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.benchmark = True
    {"": player_ab, "--pool": pool_ab, "--env": env_ab}[mode](
        other_dir, dev, card)


def timed_rollout(player, waves):
    """Milliseconds per wave of `waves` rollout waves of the Player."""
    cs.sync()
    t0 = time.perf_counter()
    player.rollout(waves)
    cs.sync()
    return 1e3 * (time.perf_counter() - t0) / waves


def player_moves(libs, engine, eval_fn, params, dev, card):
    """The Player's move 1 (WAVES waves from a fresh tree, root noise from
    one seed) with each side's libraries, in turns; the searched trees must
    be the same.  Returns (the last Player, move 1's searched tree)."""
    import torch

    from tak_tpu_torch.game import Game
    from tak_tpu_torch.player import Player

    def fresh_player():
        game = Game.with_komi(cs.N, 2, dev)
        for mv in ("a1", "f6"):
            game.play(mv)
        player = Player(
            engine, eval_fn, params, game,
            generator=torch.Generator(device=dev).manual_seed(cs.SEED))
        player.add_noise(0.2, 0.3)
        return player

    for name in libs:                 # cuDNN autotuning, lazy module loads
        use(libs, name)
        timed_rollout(fresh_player(), 50)
    searched = None
    for name in ORDER:
        use(libs, name)
        player = fresh_player()
        ms = timed_rollout(player, WAVES)
        if searched is None:
            searched = player.tree.clone()
        cs.compare_trees(player.tree, searched,
                         f"move 1's tree with the {name} kernels")
        cs.log(f"{name}: move 1, {ms:.3f} ms per wave, "
               f"{64e3 / ms:,.0f} rollouts/s on {card}")
    return player, searched


def selfplay_searches(libs, engine, eval_fn, params, roots, config, card,
                      options=(False, True)):
    """One self-play move's search from `roots` at `config`, with
    `fused_leaf_legal` off and on, with each side's libraries in turns; the
    searched trees must be the same."""
    import dataclasses

    from tak_tpu_torch.mcts.search import MCTS

    sims = cs.GAMES * config.num_waves * config.wave_size

    def timed_search(m):
        searched = m.prepare_root(params, m.init_batch(roots))
        cs.sync()
        t0 = time.perf_counter()
        m.run_sims(params, searched)
        cs.sync()
        return time.perf_counter() - t0, searched

    for option in options:
        m = MCTS(engine, eval_fn,
                 dataclasses.replace(config, fused_leaf_legal=option))
        for name in libs:             # cuDNN autotuning, lazy module loads
            use(libs, name)
            timed_search(m)
        first = None
        for name in ORDER:
            use(libs, name)
            sec, searched = timed_search(m)
            if first is None:
                first = searched
            cs.compare_trees(searched, first,
                             f"the searched trees with the {name} kernels")
            cs.log(f"{name}: one self-play move's search, fused_leaf_legal="
                   f"{option}, {sec * 1e3:.1f} ms, {sims / sec:,.0f} sims/s "
                   f"on {card}")


def player_ab(other_dir: str, dev, card):
    from tak_tpu_torch.mcts import tree_kernels_hbm as tk

    libs = libraries(other_dir, ("tree_wave_hbm",), ("fused_step",))
    engine, eval_fn, params = network(dev)
    player, searched = player_moves(libs, engine, eval_fn, params, dev, card)
    deep = None
    for name in ORDER:
        use(libs, name)
        player.tree = searched.clone()
        ms = timed_rollout(player, DEEP_WAVES)
        if deep is None:
            deep = player.tree.clone()
        cs.compare_trees(player.tree, deep,
                         f"the deep tree with the {name} kernels")
        cs.log(f"{name}: {DEEP_WAVES} waves from move 1's searched tree, "
               f"{ms:.3f} ms per wave, {64e3 / ms:,.0f} rollouts/s on {card}")

    cfg = player.mcts.config
    V = cfg.wave_size
    kargs = dict(base=float(cfg.exploration_base),
                 init=float(cfg.exploration_init))
    after = searched.clone()
    use(libs, "this")
    leaves, created = tk.descend_wave_hbm(after, V, **kargs)
    pending = player.mcts._eval_and_topk(params, after, leaves, created)
    for name in ("other", "this", "this", "other"):
        use(libs, name)
        d = cs.cuda_ms(lambda t: tk.descend_wave_hbm(t, V, **kargs), 10,
                       searched.clone)
        b = cs.cuda_ms(lambda t: tk.expand_backup_wave_hbm(t, pending), 10,
                       after.clone)
        cs.log(f"{name}: on move 1's searched tree descend_wave_hbm "
               f"{d:.4f} ms, expand_backup_wave_hbm {b:.4f} ms on {card}")


def pool_ab(other_dir: str, dev, card):
    import numpy as np

    from tak_tpu_torch.mcts import tree_kernels as tk

    libs = libraries(other_dir, ("tree_wave",), ("fused_step",
                                                 "fused_step_legal"))
    engine, eval_fn, params = network(dev)
    _, roots = cs.selfplay_rows(engine, np.random.default_rng(cs.SEED), dev)
    mcts, tree, pending = cs.midsearch_tree(engine, eval_fn, params, roots)
    selfplay_searches(libs, engine, eval_fn, params, roots, mcts.config, card)

    kargs = dict(base=float(mcts.config.exploration_base),
                 init=float(mcts.config.exploration_init), recycle=True)
    zero = tk.Pending.zeros(cs.GAMES, cs.WAVE, cs.K, dev)
    for name in ("other", "this", "this", "other"):
        use(libs, name)
        ms = [cs.cuda_ms(run, 10, tree.clone) for run in (
            lambda t: tk.backup_descend_wave(t, pending, **kargs),
            lambda t: tk.backup_descend_wave(t, zero, **kargs),
            lambda t: tk.expand_backup_wave(t, pending, recycle=True))]
        cs.log(f"{name}: on the mid-search tree backup_descend_wave "
               f"{ms[0]:.4f} ms, descend_wave {ms[1]:.4f} ms, "
               f"expand_backup_wave {ms[2]:.4f} ms on {card}")


def env_ab(other_dir: str, dev, card):
    import numpy as np
    import torch

    from tak_tpu_torch.engine.core import get_engine
    from tak_tpu_torch.engine.env_rollout import (
        env_rollout,
        env_rollout_plain,
        legal_sampler,
        legal_sampler_plain,
    )
    from tak_tpu_torch.engine.fused_env import fused_step, step_plain
    from tak_tpu_torch.engine.legal_bits import step_legal, step_legal_plain

    libs = libraries(other_dir, ("fused_step", "fused_step_legal",
                                 "env_rollout"), verbose=True)
    engine = get_engine(cs.N)
    rng = np.random.default_rng(cs.SEED)
    states, roots = cs.selfplay_rows(engine, rng, dev)
    acts = cs.random_legal(engine, states, rng)
    enabled = torch.as_tensor(rng.random(cs.ROWS) < 0.9, device=dev)

    def head(rows):
        return (states[:rows].map(lambda x: x.contiguous()), acts[:rows],
                enabled[:rows])

    shapes = {f"{cs.ROWS:,} rows": (states, acts, enabled)}
    wst, wacts, wen = cs.win_scan_rows(engine, roots)
    shapes[f"win scan, {wacts.shape[0]:,} rows"] = (wst, wacts, wen)
    shapes["64 rows"] = head(cs.P_WAVE)
    shapes["one row"] = head(1)
    want = {k: step_plain(engine, *v) for k, v in shapes.items()}
    # the step with legal bits (#5) on a self-play wave's rows and a Player
    # wave's; the sampler (#6) seeded and with given words
    legal_shapes = {k: shapes[k] for k in (f"{cs.ROWS:,} rows", "64 rows")}
    want_legal = {k: step_legal_plain(engine, *v)
                  for k, v in legal_shapes.items()}
    draws = {"seeded": dict(seed=cs.SEED + 7),
             "given words": dict(bits=cs.u32_words(rng, cs.ROWS, dev))}
    want_draw = {k: legal_sampler_plain(engine, states, **kw)
                 for k, kw in draws.items()}
    start = states[:cs.R_ENVS].map(lambda x: x.contiguous())
    seeded = dict(seed=(cs.SEED + 1) << 33 | 5)
    want_roll = env_rollout_plain(engine, start, cs.R_STEPS, **seeded)
    floor = cs.launch_floor_ms(dev)
    cs.log(f"launch floor (zero_() on 64 int32): {floor:.4f} ms on {card}")
    for name in ORDER:
        use(libs, name)
        for k, v in shapes.items():
            cs.compare_states(fused_step(engine, *v), want[k],
                              f"fused_step ({k}) with the {name} kernels")
        for k, v in legal_shapes.items():
            got = step_legal(engine, *v)
            cs.compare_states(got[0], want_legal[k][0],
                              f"fused_step_legal ({k}) with the {name} "
                              "kernels")
            cs.same_tensors(got[1:], want_legal[k][1:],
                            f"fused_step_legal words ({k}) with the {name} "
                            "kernels")
        for k, kw in draws.items():
            cs.same_tensors(legal_sampler(engine, states, **kw), want_draw[k],
                            f"legal_sampler ({k}) with the {name} kernels")
        cs.compare_states(env_rollout(engine, start, cs.R_STEPS, **seeded),
                          want_roll, f"env_rollout with the {name} kernels")
        legal_ms = {k: cs.launch_ms(lambda: step_legal(engine, *v))
                    for k, v in legal_shapes.items()}
        draw_ms = {k: cs.launch_ms(lambda: legal_sampler(engine, states, **kw))
                   for k, kw in draws.items()}
        step_ms = {}
        for k, v in shapes.items():
            if k.startswith("win scan"):    # one launch fills the card
                step_ms[k] = cs.cuda_ms(lambda _: fused_step(engine, *v), 5)
            else:
                step_ms[k] = cs.launch_ms(lambda: fused_step(engine, *v))
        roll = cs.cuda_ms(
            lambda _: env_rollout(engine, start, cs.R_STEPS, **seeded), 5)
        _, rate = cs.env_rollout_phase(engine, dev, card)
        cs.log(f"{name}: fused_step " + ", ".join(
            f"{k} {t:.4f} ms" for k, t in step_ms.items())
            + "; fused_step_legal " + ", ".join(
                f"{k} {t:.4f} ms" for k, t in legal_ms.items())
            + "; legal_sampler " + ", ".join(
                f"{k} {t:.4f} ms" for k, t in draw_ms.items())
            + f"; env_rollout {cs.R_ENVS:,} x {cs.R_STEPS} {roll:.4f} ms; "
            f"{rate:,.0f} env steps/s on {card}")

    # the paths that launch #1 and #5, end to end with each side's kernels:
    # the Player's move 1 and one self-play move's search with
    # fused_leaf_legal off (#1 steps the leaves) and on (#5 does)
    engine, eval_fn, params = network(dev)
    player_moves(libs, engine, eval_fn, params, dev, card)
    config = cs.make_actor(engine, eval_fn, dev, cs.MOVES).search_config
    selfplay_searches(libs, engine, eval_fn, params, roots, config, card)


if __name__ == "__main__":
    args = sys.argv[1:]
    if len(args) not in (1, 2) or args[1:] not in ([], ["--pool"],
                                                   ["--env"]):
        sys.exit(__doc__)
    main(args[0], "".join(args[1:]))
