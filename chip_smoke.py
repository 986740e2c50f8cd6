#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`tak_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from `tak_tpu_torch/csrc/` (nvcc, in parallel);
  3. hold each kernel against its plain PyTorch version on the card, at the
     main path's shapes, bitwise:
       * fused step on 8,192 rows of varied 6x6 positions (seeded random
         playouts), with disabled rows and finished games; at every size
         3-8 the fused step and the env rollout (4 steps, given words and
         seeded) on the hand-built cases of `tak_tpu_torch.engine.env_cases`
         (stacks across a word boundary, full carries to the edge, a
         capstone smash, a spread that completes both roads, a snake road,
         the last piece of a reserve, a full board, the reversible draw,
         plies 0-1, disabled and finished rows) and on 1,024 playout rows
         (the rollout 8 steps with given words), and on both row sets the
         fused step with legal bits (states and packed words) and the legal
         sampler (given words and seeded, on the rows and on the rows their
         step leaves); the fused step with legal bits on the 8,192 rows, on
         1,024 playout rows at 5x5 and 8x8, and (phase 5) on a Player
         wave's 64 leaf rows: states and packed words, and the words
         unpacked against `Engine.legal_mask`;
       * the legal sampler on those 8,192 rows and the env rollout at
         8,192 rows x 64 steps, each with given random words and with a
         seed (Philox written out in the kernel and in the plain version);
       * one backup+descend wave (valid=1), one descend wave (valid=0) and
         one expand+backup flush on 32 trees mid-search, with the 1280-node
         pool full so every create recycles a node; then the three in turn
         on the recycling cases of `tak_tpu_torch.mcts.tree_cases` (the
         create's own parent as the coldest candidate, a full pool without
         a victim, tied and clamped keys, a leaf unpinned and evicted in
         one merged wave) and on its shared-prefix, repeated-leaf and
         deep-chain trees with recycling, at K=32, A=9,036, M=1,280;
       * the large-tree descend and expand+backup waves at the Player's
         shape (one game, V=64, K=128, a 131,072-node pool, 9,036 actions)
         on a tree of several thousand nodes grown by the plain versions,
         again on 8 deep trees, and on a small pool that runs out inside
         the wave; the pool-tier kernels run on the same trees with
         recycling off, for comparison; then on the hand-built trees of
         `tak_tpu_torch.mcts.tree_cases` (a 40-edge prefix shared by all
         leaves, every leaf twice, one leaf 64 times, a chain deeper than
         the backup kernel's path buffer, a wave of root creates, a pool
         that fills up, a path through an unexpanded node) at K=128 and K=32;
  4. the self-play slice: SelfPlayActor at 6x6, 32 lockstep games, 10,240
     sims per move, wave 256, K=32, recycling in the default 1280-node
     pool, tree reuse (reroot_keep unset, as bench.py leaves it),
     instant-win scan on, Net6 (16 blocks x 128 filters, random weights
     from a seeded torch.Generator) in bf16, for 3 searched moves.  Checks:
     every chosen action is legal, every root gains exactly the searched
     sims, every pool-tier kernel launched during the slice;
  5. the Player slice: one `Player` with its default configuration (wave
     64, K=128, a 131,072-node pool, no recycling: the large-tree tier),
     root noise, 800 rollout waves (51,200 rollouts) per move, three moves
     with tree reuse, analysis and examples.  Checks: the root counts
     1 + rollouts on a fresh tree, the moves are legal, the carried
     subtree's visits survive the reroot, the large-tree kernels launched
     and the pool-tier tree kernels did not.  Then the three kernels of
     this path again at the shapes it gave them, bitwise against their
     plain versions and timed: both large-tree waves on move 1's searched
     tree, the fused step on that wave's 64 leaf rows and on one row (as
     `Game.play` steps).  Then a Player at wave 512 (`-b 512`), wider
     than the backup kernel's shared memory holds, for 8 waves, and both
     large-tree waves at V=512 on its tree, bitwise and timed;
  6. the entry points as subprocesses: a TEI dialogue over pipes and the
     analysis command line on a short PTN file;
  6a. the self-play slice again with `fused_leaf_legal=True` for 2 searched
     moves (same seed, weights and openings): the fused step with legal
     bits launched, root counts and legal moves as in phase 4, and move
     1's searched tree bitwise equal to phase 4's; then one searched move
     with `topk_impl="packedq"`;
  6b. the env rollout as a user drives it: `Engine.env_rollout_fn(64)` on
     8,192 fresh 6x6 games, one warm-up launch and 8 timed launches (seeds
     1..8) with one synchronization: env steps per second.  Checks: nothing
     but the rollout kernel launched, every row ongoing, pieces conserved;
     then the sampler kernel draws one action per final row, all legal;
  6c. the learner on real data: the trained Net5 (`runs/train5_r3`) and its
     committed buffer of 28,215 5x5 self-play examples, one `Network.train`
     pass (56 chunks of 500: 2 Adam steps and the trailing flush) after a
     one-chunk warm-up: examples/s, ms per chunk, each step's loss parts.
     Checks: losses and weights finite, every parameter changed;
  6d. card against CPU: one chunk of Net5 in float64 (125 examples) and in
     float32 (500), TF32 off, on the card and through the port on the CPU:
     the loss parts, the summed gradients and the new batch statistics
     within the tolerances of `card_vs_cpu_phase`;
  6e. the learner at the reference step: the trained Net6
     (`runs/train6_r4/_models/1787285471.model`), 20,000 seeded 6x6
     examples, 2 steps of 20 x 500 x 8 = 80,000 rows after a one-chunk
     warm-up: examples/s, ms per step, the share of the bf16 peak;
  6f. the pit at its defaults (128 games, 800 sims, wave 16, K=128, a
     1,602-node pool, tree reuse) cut to max_plies 16, its only cut: the
     trained Net6 against 6e's candidate; plies/s and ms per half-batch
     search.  Checks: the launches of #1-#4 equal those the config
     implies, every game counted, visits carried by reuse.  Then #2, #4
     and #3 bitwise against their plain versions on the tree that each
     first half-batch search started from (carried by reuse), grown by 1,
     4, 10 or 25 of its waves, and timed with their bound and chain floor
     on ply 8's tree grown by 10 waves;
  6g. the generation loop through `python -m tak_tpu_torch.cli.train` as
     subprocesses in a temporary workdir: 2 generations from the trained
     Net6, then `--resume` to a third (full width; cut: 4 self-play games
     of 256 rollouts, 4 pit games of 64 rollouts, chunks of 50, 4 a step).
     Checks: the artifacts, that the resumed run starts at generation 3,
     that the port's `load_run` reads the checkpoint;
  7. time each kernel (CUDA events; a kernel launched twenty times back to
     back behind a spin long enough for the host to queue them all) and
     its plain version at the main paths' shapes, with the least time the
     card could take (bound), and the launch floor (`zero_()` on 64 int32
     timed the same way) beside the fused step's small shapes; for the
     five tree waves also the chain
     floor: a one-thread pointer chase along the wave's own paths (down
     through `edge_child` for the descents, up through `parent` for the
     backups), since descents that see each other's marks cannot approach
     a throughput bound;
  8. print one `{"kernels": [...]}` line, then the `{"ok": true, ...}` line.
     A kernel's `ms`, `plain_ms` and `bound_ms` are those of its main-path
     shape (the large-tree waves: the Player's own tree); `other_shapes`
     holds its times elsewhere (#2-#4 at the pit's shape too),
     `launches_by_path` the count of each path (the pit's included).

`--profile` adds, before the last two lines, where one self-play move's
search (with `fused_leaf_legal` off and on), one Player wave, one Net6
optimizer step (stages, one BatchNorm alone, device time by kernel family)
and one pit half-batch search spend their time (per-stage host timers,
then torch.profiler device time).

Exits non-zero, printing no result, without a CUDA device or without the
`tak_tpu_torch` package beside this file.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

N = 6
GAMES = 32
SIMS = 10_240
WAVE = 256
ROWS = GAMES * WAVE            # fused-step rows per wave
K = 32
POOL = 1280
MOVES = 3
SEED = 0

# the Player slice (the defaults of `tak_tpu_torch.player.Player`)
P_WAVE = 64
P_K = 128
P_POOL = 131_072
P_WAVES = 800                  # 51,200 rollouts per move, the ponder cap
P_MOVES = 3
P_WIDE = 512                   # a Player wave wider than shared memory holds
P_WIDE_WAVES = 8

# the env rollout path (the JAX package's bench.py:28-29,70-81)
R_ENVS = 8192
R_STEPS = 64
R_LAUNCHES = 8
FUSED_MOVES = 2                # searched moves with fused_leaf_legal=True
CASE_STEPS = 4                 # rollout steps from the hand-built env cases
SIZE_ROWS = 1024               # playout rows per size for #1 and #7
SIZE_STEPS = 8

# the training slice
NET5_WEIGHTS = "runs/train5_r3/_checkpoint/variables.msgpack"
NET5_BUFFER = "runs/train5_r3/_checkpoint/buffer.data"
NET5_EXAMPLES = 28_215         # real 5x5 self-play examples
NET6_WEIGHTS = "runs/train6_r4/_models/1787285471.model"
L6_EXAMPLES = 20_000           # 2 optimizer steps of 20 chunks of 500
PIT_PLIES = 16                 # the pit's max_plies: its only cut
PIT_CHECK_PLY = 8              # the pit tree that the kernel checks start from
PIT_CHECK_WAVES = 10           # pipelined waves grown on it before the checks

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_OPS_PER_S = 989e12        # H100 SXM tensor cores, dense
F32_OPS_PER_S = 67e12          # H100 SXM, outside the tensor cores

REPLACES = {
    "fused_step": "tak_tpu/engine/pallas_env.py:704",
    "fused_step_legal": "tak_tpu/engine/pallas_env.py:836",
    "legal_sampler": "tak_tpu/engine/pallas_env.py:927",
    "env_rollout": "tak_tpu/engine/pallas_env.py:990",
    "backup_descend_wave": "tak_tpu/mcts/pallas_ops.py:1118",
    "descend_wave": "tak_tpu/mcts/pallas_ops.py:1284",
    "expand_backup_wave": "tak_tpu/mcts/pallas_ops.py:637",
    "descend_wave_hbm": "tak_tpu/mcts/pallas_hbm.py:324",
    "expand_backup_wave_hbm": "tak_tpu/mcts/pallas_hbm.py:648",
}
POOL_TIER = ("backup_descend_wave", "descend_wave", "expand_backup_wave")
HBM_TIER = ("descend_wave_hbm", "expand_backup_wave_hbm")
PATHS = ("selfplay", "player", "fused_leaf_legal", "env_rollout", "pit")
SOURCES = {
    "fused_step": "tak_tpu_torch/csrc/fused_step.cu",
    "fused_step_legal": "tak_tpu_torch/csrc/fused_step_legal.cu",
    "legal_sampler": "tak_tpu_torch/csrc/env_rollout.cu",
    "env_rollout": "tak_tpu_torch/csrc/env_rollout.cu",
    "backup_descend_wave": "tak_tpu_torch/csrc/tree_wave.cu",
    "descend_wave": "tak_tpu_torch/csrc/tree_wave.cu",
    "expand_backup_wave": "tak_tpu_torch/csrc/tree_wave.cu",
    "descend_wave_hbm": "tak_tpu_torch/csrc/tree_wave_hbm.cu",
    "expand_backup_wave_hbm": "tak_tpu_torch/csrc/tree_wave_hbm.cu",
}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, setup=None, spin: int = 1_000_000) -> float:
    """Mean device milliseconds of fn(setup()) over `reps` runs (CUDA
    events around each launch; `setup` runs outside the timed span).  The
    card spins for `spin` cycles (about half a millisecond) ahead of the
    first event, so that the host has queued the launch before the card
    reaches it: the span holds the kernel and not the host's way to the
    launch."""
    import torch

    total = 0.0
    for _ in range(reps):
        arg = setup() if setup is not None else None
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        fn(arg)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def launch_ms(fn, reps: int = 20) -> float:
    """Device milliseconds of one of `reps` back-to-back launches of fn().
    The card spins for about 20 ms ahead of the first event, long enough
    for the host to queue all of them, so that the span holds the kernels
    and not the rate at which the host issues them."""
    return cuda_ms(lambda _: [fn() for _ in range(reps)], 1,
                   spin=40_000_000) / reps


def launch_floor_ms(dev) -> float:
    """What any launch costs on this card: `launch_ms` of `zero_()` on a
    64-element int32 tensor.  The fused step's small shapes (the Player's
    64 leaf rows, one row) are judged against it."""
    import torch

    z = torch.zeros(64, dtype=torch.int32, device=dev)
    return launch_ms(lambda: z.zero_())


def u32_words(rng, shape, dev):
    """Random words (u32 values in an int64 tensor) for the rollout's and
    the sampler's given-words mode."""
    import numpy as np
    import torch

    return torch.as_tensor(
        rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.int64),
        device=dev)


def random_legal(engine, states, rng):
    """One uniformly random legal action per row (numpy draws)."""
    import torch

    legal = engine.legal_mask(states)
    count = legal.sum(1)
    r = torch.as_tensor(rng.random(legal.shape[0]), device=legal.device)
    kth = torch.clamp((r * count).long(), max=legal.shape[1] - 1)
    pick = (torch.cumsum(legal.int(), 1) > kth[:, None]).int().argmax(1)
    return pick.to(torch.int32)


def playout_states(engine, rows, plies, rng, device):
    """`rows` games after seeded random playouts of varied lengths, stepped
    by the plain version (not by the kernel under test)."""
    import torch

    from tak_tpu_torch.engine.fused_env import step_plain

    states = engine.initial_batch(rows, 4, device)
    for ply in range(plies):
        acts = random_legal(engine, states, rng)
        live = torch.as_tensor(rng.random(rows) < 1.0 - 0.5 * ply / plies,
                               device=device)
        states = step_plain(engine, states, acts, live)
    return states


def win_scan_rows(engine, roots):
    """The instant-win scan's probe rows for `roots`, built as
    `Engine.wins_in_one` builds them: every (game, action) pair, with the
    legal mask as `enabled`."""
    import torch

    A = engine.num_actions
    legal = engine.legal_mask(roots)
    rep = roots.map(lambda x: x.repeat_interleave(A, 0).contiguous())
    acts = torch.arange(A, dtype=torch.int32,
                        device=legal.device).repeat(roots.ply.shape[0])
    return rep, acts, legal.reshape(-1).contiguous()


def compare_states(a, b, what):
    from tak_tpu_torch.types import FIELDS

    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if not bool((x == y).all()):
            bad = int((x != y).sum())
            fail(f"{what}: field {f} differs in {bad} entries")


def compare_trees(a, b, what):
    """Bitwise equality of every tree field and of the node states."""
    import torch

    from tak_tpu_torch.mcts.tree import TENSOR_FIELDS

    for f in TENSOR_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype.is_floating_point:
            same = x.view(torch.int32) == y.view(torch.int32)
        else:
            same = x == y
        if not bool(same.all()):
            fail(f"{what}: tree field {f} differs in {int((~same).sum())} "
                 "entries")
    compare_states(a.state, b.state, what + " (node states)")


def tree_bytes(before, after, V, descend: bool, backup: bool):
    """Least bytes a wave must move, from this run's data: the root tier
    read once per launch when descending, the root entries the wave
    changed, the node tier, the edge rows the wave changed (read and
    written), the pending inputs and the outputs."""
    import torch

    B, M, Kk = before.edge_n.shape
    A = before.root_n.shape[1]
    total = 0
    if descend:
        total += B * A * (4 + 1 + 4 + 4 + 4 + 4)   # prior legal n virt w child
        total += B * V * (4 + 1)                   # leaves, created
        total += 2 * B * M * (4 * 6 + 1)           # node tier read + written
    changed_root = torch.zeros_like(before.root_n, dtype=torch.bool)
    for f in ("root_n", "root_virt", "root_w", "root_child"):
        changed_root |= getattr(before, f) != getattr(after, f)
    total += int(changed_root.sum()) * 4 * 4 * 2
    rows = torch.zeros_like(before.edge_n[..., 0], dtype=torch.bool)
    for f in ("edge_action", "edge_prior", "edge_child", "edge_n",
              "edge_virt", "edge_w"):
        rows |= (getattr(before, f) != getattr(after, f)).any(-1)
    total += int(rows.sum()) * Kk * 4 * 6 * 2
    if backup:
        total += B * V * (4 * 5 + Kk * 8)          # pending rows
    return total


def tree_ops(B, V, A, M, descend: bool, recycle: bool = True):
    """Float/int operations of a wave's descents: the root PUCT score
    (about 10 operations per action) and, when recycling, the victim scans
    (about 5 per node, twice) per descent; the walk and backups are
    negligible."""
    if not descend:
        return B * V * 64
    return B * V * (10 * A + (10 * M if recycle else 0))


def bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hbm_wave_work(before, after, V, descend: bool):
    """(bytes, operations) a large-tier wave must move and do, from this
    run's data.  Descend: 17 B per root action (prior, legal, n, virt, w)
    read once and the chosen action's child entry per descent; the five
    K-wide rows the pick reads (action, prior, n, virt, w) of every node the
    walks passed, and per level the chosen slot's child entry and its mark;
    the root marks and the links of created nodes written; the outputs.
    About 10 operations per root action and per edge slot scored.
    Expand+backup: the pending inputs, the installed rows, and three
    read-modify-writes plus the node links per level walked."""
    B, M, Kk = before.edge_n.shape
    A = before.root_n.shape[1]

    def diff(*fields):
        out = None
        for f in fields:
            d = getattr(before, f) != getattr(after, f)
            out = d if out is None else out | d
        return out

    if descend:
        levels = int((after.edge_virt - before.edge_virt).sum())
        rows = int(diff("edge_virt", "edge_child").any(-1).sum())
        created = int(diff("parent", "parent_slot", "parent_action").sum())
        root_marks = int(diff("root_virt", "root_child").sum())
        nbytes = (B * A * (4 + 1 + 4 + 4 + 4) + B * V * 4 + root_marks * 8
                  + rows * (Kk * 4 * 5 + 1) + levels * (4 + 4)
                  + created * (4 + 12) + B * V * (4 + 1))
        return nbytes, B * V * 10 * A + levels * 10 * Kk
    installed = int(diff("expanded").sum())
    levels = int((after.edge_n - before.edge_n).sum()
                 + (after.root_n - before.root_n).sum())
    nbytes = (B * V * 4 * 5 + installed * Kk * (8 + 4 * 6)
              + levels * (12 * 2 + 12))
    return nbytes, B * V * 16 + levels * 8 + installed * Kk * 2


def peaked_eval(num_actions):
    """A fake network with state-dependent priors spanning 2^-22..1 (a few
    actions dominate, so searches go deep) and dyadic values; seeded by
    nothing, exact on any device."""
    import torch

    def eval_fn(params, states):
        feat = (states.ply + 2 * states.heights.sum(-1)
                + states.to_move).long()
        k = (feat[:, None] * 7
             + torch.arange(num_actions, device=feat.device)[None, :] * 13) % 23
        policy = torch.exp2(-k.float())
        value = ((feat * 5) % 17 - 8).float() / 16.0
        return policy, value

    return eval_fn


def grow_plain(mcts, params, roots, waves):
    """A tree grown from `roots` by `waves` large-tier waves that run the
    plain versions of both kernels."""
    from tak_tpu_torch.mcts.tree_kernels_hbm import (
        descend_wave_hbm_plain,
        expand_backup_wave_hbm_plain,
    )

    cfg = mcts.config
    kargs = dict(base=float(cfg.exploration_base),
                 init=float(cfg.exploration_init))
    tree = mcts.prepare_root(params, mcts.init_batch(roots))
    for _ in range(waves):
        leaves, created = descend_wave_hbm_plain(tree, cfg.wave_size, **kargs)
        expand_backup_wave_hbm_plain(
            tree, mcts._eval_and_topk(params, tree, leaves, created))
    return tree


def check_hbm_kernels(mcts, params, roots, waves, what, card, reps=3,
                      pool_runs_out=False):
    """Grow a tree from `roots` with the plain versions of the large-tier
    kernels, then hold the kernels against them on it (`check_hbm_on_tree`)."""
    t0 = time.perf_counter()
    tree = grow_plain(mcts, params, roots, waves)
    sync()
    log(f"tree for the large-tier check ({what}): {waves} plain waves in "
        f"{time.perf_counter() - t0:.1f} s")
    return check_hbm_on_tree(mcts, params, tree, what, card, reps,
                             pool_runs_out)


def check_hbm_on_tree(mcts, params, tree, what, card, reps=3,
                      pool_runs_out=False):
    """Hold the large-tier kernels against their plain versions, bitwise,
    on whole trees: one descend wave and one expand+backup wave both ways on
    clones of `tree`, and between them the fused step of that wave's leaves
    (the rows `MCTS._leaf_states_of` gives it) against its plain version.
    The pool-tier kernels (recycling off) run on the same tree for
    comparison.  Returns {kernel: (ms, plain_ms, bound_ms, bound_by)}, the
    pool-tier times under "descend_wave"/"expand_backup_wave" and the fused
    steps' under "fused_step" and "fused_step_legal" (the latter held on the
    same leaf rows, states and packed words), and under "chain_floor_ms"
    the chain floors of the two large-tier kernels (`chain_floor`)."""
    from tak_tpu_torch.engine.fused_env import fused_step, step_plain
    from tak_tpu_torch.engine.legal_bits import step_legal, step_legal_plain
    from tak_tpu_torch.mcts.tree_kernels import descend_wave, expand_backup_wave
    from tak_tpu_torch.mcts.tree_kernels_hbm import (
        descend_wave_hbm,
        descend_wave_hbm_plain,
        expand_backup_wave_hbm,
        expand_backup_wave_hbm_plain,
    )

    cfg = mcts.config
    V = cfg.wave_size
    kargs = dict(base=float(cfg.exploration_base),
                 init=float(cfg.exploration_init))
    t0 = time.perf_counter()
    B, M, Kk = tree.edge_n.shape
    nodes = tree.next_free.tolist()

    # descend
    tk, tp, tq = tree.clone(), tree.clone(), tree.clone()
    lk, ck = descend_wave_hbm(tk, V, **kargs)
    lp, cp = descend_wave_hbm_plain(tp, V, **kargs)
    lq, cq = descend_wave(tq, V, recycle=False, **kargs)
    sync()
    compare_trees(tk, tp, f"descend_wave_hbm ({what})")
    if not (bool((lk == lp).all()) and bool((ck == cp).all())):
        fail(f"descend_wave_hbm ({what}): leaves/created differ")
    compare_trees(tq, tp, f"pool-tier descend_wave on the same tree ({what})")
    if not (bool((lq == lp).all()) and bool((cq == cp).all())):
        fail(f"pool-tier descend_wave ({what}): leaves/created differ")
    for f in ("node_n", "node_virt", "child_count"):
        if not bool((getattr(tk, f) == getattr(tree, f)).all()):
            fail(f"descend_wave_hbm ({what}) touched {f}")
    if pool_runs_out and not (bool((tree.next_free < M).all())
                              and bool((tk.next_free == M).all())
                              and int(ck.sum()) < B * V):
        fail(f"descend_wave_hbm ({what}): the pool did not run out inside "
             f"the wave: {nodes} -> {tk.next_free.tolist()} of {M}")
    depth = int((tk.edge_virt - tree.edge_virt).sum()) / (B * V)
    after_descend = tk
    del tp, tq

    # the fused step of that wave's leaves: B*V rows, root leaves disabled
    parents, acts, live = mcts._leaf_step_inputs(after_descend, lk)
    parents = parents.map(lambda x: x.contiguous())
    acts, live = acts.contiguous(), live.contiguous()
    got = fused_step(mcts.engine, parents, acts, live)
    want = step_plain(mcts.engine, parents, acts, live)
    sync()
    compare_states(got, want, f"fused_step on the wave's {B * V} leaves "
                   f"({what})")
    stepped = int((got.ply != parents.ply).sum())
    if stepped == 0:
        fail(f"fused_step ({what}): no leaf row was stepped")
    del got, want
    check_step_legal(mcts.engine, parents, acts, live,
                     f"the wave's {B * V} leaf rows, {what}")

    # expand + backup of that wave's leaves
    pending = mcts._eval_and_topk(params, after_descend, lk, ck)
    tk, tp, tq = (after_descend.clone(), after_descend.clone(),
                  after_descend.clone())
    expand_backup_wave_hbm(tk, pending)
    expand_backup_wave_hbm_plain(tp, pending)
    expand_backup_wave(tq, pending, recycle=False)
    sync()
    compare_trees(tk, tp, f"expand_backup_wave_hbm ({what})")
    compare_trees(tq, tp, f"pool-tier expand_backup_wave ({what})")
    if bool((tk.virt0 != 0).any()) or bool((tk.root_virt != 0).any()):
        fail(f"expand_backup_wave_hbm ({what}): virtual visits left over")
    after_backup = tk
    del tp, tq
    log(f"check large tier ({what}): B={B} V={V} K={Kk} M={M}, "
        f"{nodes} nodes, {int(ck.sum())} created, mean depth {depth:.2f}: "
        f"descend and expand+backup bitwise equal to the plain versions "
        f"(and to the pool-tier kernels with recycling off), fused_step "
        f"bitwise equal on the wave's {B * V} leaf rows ({stepped} stepped) "
        f"in {time.perf_counter() - t0:.1f} s")

    out = {}
    runs = {
        "descend_wave_hbm": (tree, lambda t: descend_wave_hbm(t, V, **kargs),
                             lambda t: descend_wave_hbm_plain(t, V, **kargs),
                             hbm_wave_work(tree, after_descend, V, True)),
        "expand_backup_wave_hbm": (
            after_descend, lambda t: expand_backup_wave_hbm(t, pending),
            lambda t: expand_backup_wave_hbm_plain(t, pending),
            hbm_wave_work(after_descend, after_backup, V, False)),
        "descend_wave": (tree,
                         lambda t: descend_wave(t, V, recycle=False, **kargs),
                         None, None),
        "expand_backup_wave": (
            after_descend,
            lambda t: expand_backup_wave(t, pending, recycle=False),
            None, None),
    }
    for name, (src, run_k, run_p, work) in runs.items():
        t_kernel = cuda_ms(run_k, reps, src.clone)
        t_plain = cuda_ms(run_p, 1, src.clone) if run_p else None
        t_bound, by = bound(*work) if work else (None, None)
        out[name] = (t_kernel, t_plain, t_bound, by)
    out["fused_step"] = (
        launch_ms(lambda: fused_step(mcts.engine, parents, acts, live)),
        cuda_ms(lambda _: step_plain(mcts.engine, parents, acts, live), 2),
        *bound(*fused_step_work(parents, B * V)))
    out["fused_step_legal"] = (
        launch_ms(lambda: step_legal(mcts.engine, parents, acts, live)),
        cuda_ms(lambda _: step_legal_plain(mcts.engine, parents, acts, live),
                2),
        *bound(*step_legal_work(mcts.engine, parents, B * V)))
    down, up, chase = chain_floor(after_descend, lk, V)
    floors = {"descend_wave_hbm": down, "expand_backup_wave_hbm": up}
    log(f"time large tier ({what}) on {card}: "
        + "; ".join(
            f"{n} {v[0]:.4f} ms"
            + (f" (plain {v[1]:.3f} ms, bound {v[2]:.6f} ms by {v[3]}"
               + (f", chain floor {floors[n]:.4f} ms" if n in floors else "")
               + ")"
               if v[1] is not None else " (pool-tier kernel, recycling off)")
            for n, v in out.items()) + f"; {chase}")
    out["chain_floor_ms"] = floors
    return out


def chain_floor(tree, leaves, V, reps=5):
    """The dependent-load chains of the wave that ended in `leaves` on
    `tree` (after its descend), each followed by one thread per game.
    Descend: all V paths in sequence, downwards through `edge_child`: the
    chase's own time.  Expand+backup: the deepest single path plus V
    ordered adds, times the round trip of the chase up through `parent`.
    Returns (descend floor ms, expand+backup floor ms, a description)."""
    from tak_tpu_torch.mcts.tree_kernels_hbm import (
        child_chase,
        parent_chase,
        wave_paths,
    )

    actions, slots = wave_paths(tree, leaves)
    if not bool((child_chase(tree, actions, slots) == leaves).all()):
        fail("child_chase did not end in the wave's leaves")
    depth = (actions != -1).int() + (slots != -1).sum(-1).int()   # [B, V]
    up_levels = parent_chase(tree, leaves)
    if not bool((up_levels == (depth + 1).sum(1)).all()):
        fail("parent_chase counted other levels than the paths hold")
    down_ms = cuda_ms(lambda _: child_chase(tree, actions, slots), reps)
    up_ms = cuda_ms(lambda _: parent_chase(tree, leaves), reps)
    down_levels = int(depth.sum(1).max())
    up_rt = up_ms / int(up_levels.max())
    deepest = int(depth.max()) + 1
    text = (f"chase down edge_child {down_ms:.4f} ms over {down_levels} "
            f"levels ({1e3 * down_ms / max(down_levels, 1):.3f} us each), "
            f"chase up parent {up_ms:.4f} ms over {int(up_levels.max())} "
            f"levels ({1e3 * up_rt:.3f} us each), deepest path {deepest}")
    return down_ms, (deepest + V) * up_rt, text


def check_hbm_cases(engine, dev, card, V=P_WAVE):
    """Hold the large-tier kernels against their plain versions, bitwise,
    on the hand-built trees of `tree_cases` (two games each, the Player's
    wave and action space, K=128 and three of them at K=32): one descend
    wave, then one expand+backup wave on a seeded evaluation of its leaves;
    and once more with a node of the shared prefix marked unexpanded before
    the backup, so that a path passes through an unexpanded node."""
    import torch

    from tak_tpu_torch.mcts import tree_cases
    from tak_tpu_torch.mcts.search import SearchConfig
    from tak_tpu_torch.mcts.tree import init_tree
    from tak_tpu_torch.mcts.tree_kernels import Pending
    from tak_tpu_torch.mcts.tree_kernels_hbm import (
        descend_wave_hbm,
        descend_wave_hbm_plain,
        expand_backup_wave_hbm,
        expand_backup_wave_hbm_plain,
    )

    t0 = time.perf_counter()
    cfg = SearchConfig()
    kargs = dict(base=float(cfg.exploration_base),
                 init=float(cfg.exploration_init))
    B, A = 2, engine.num_actions
    M = tree_cases.nodes_needed(V) + 8
    roots = engine.initial_batch(B, 4, dev)
    seen = []
    for Kk, cases in ((P_K, (*tree_cases.CASES, "unexpanded_on_path")),
                      (32, ("dups_twice", "deep_chain", "pool_full"))):
        for case in cases:
            name = "shared_prefix" if case == "unexpanded_on_path" else case
            what = f"hand-built tree {case}, K={Kk}"
            tree = init_tree(engine, roots, M, Kk)
            for f, a in tree_cases.hand_tree(name, B, M, Kk, A, V,
                                             SEED).items():
                getattr(tree, f).copy_(torch.as_tensor(a))
            tk, tp = tree.clone(), tree.clone()
            lk, ck = descend_wave_hbm(tk, V, **kargs)
            lp, cp = descend_wave_hbm_plain(tp, V, **kargs)
            sync()
            compare_trees(tk, tp, f"descend_wave_hbm ({what})")
            if not (bool((lk == lp).all()) and bool((ck == cp).all())):
                fail(f"descend_wave_hbm ({what}): leaves/created differ")
            repeats = max(int(torch.bincount(row).max()) for row in lk.long())
            depth = int((tk.edge_virt - tree.edge_virt).sum()) / (B * V)
            if case == "unexpanded_on_path":
                for t in (tk, tp):
                    t.expanded[:, 20] = False
            pending = Pending(
                **{f: torch.as_tensor(a, device=dev) for f, a in
                   tree_cases.hand_pending(lk.cpu().numpy(), Kk, A,
                                           SEED + 1).items()}, valid=1)
            expand_backup_wave_hbm(tk, pending)
            expand_backup_wave_hbm_plain(tp, pending)
            sync()
            compare_trees(tk, tp, f"expand_backup_wave_hbm ({what})")
            seen.append(f"{case} K={Kk}: depth {depth:.1f}, a leaf up to "
                        f"{repeats} times, {int(ck.sum())} created, "
                        f"{int((lk == 0).sum())} root leaves")
    log(f"check large tier on hand-built trees (B={B} V={V} A={A} M={M}): "
        f"descend and expand+backup bitwise equal to the plain versions on "
        + "; ".join(seen) + f" in {time.perf_counter() - t0:.1f} s on {card}")


def player_phase(engine, eval_fn, params, dev, card):
    """The Player slice: default configuration at full width, root noise,
    P_WAVES rollout waves per move, P_MOVES moves with reuse, analysis
    and examples.  Returns (launch counts, per-move lines, rollouts/s,
    the player, a clone of move 1's searched tree)."""
    import torch

    from tak_tpu_torch.game import Game
    from tak_tpu_torch.kernels import build as kb
    from tak_tpu_torch.player import Player

    game = Game.with_komi(N, 2, dev)
    for mv in ("a1", "f6"):
        game.play(mv)
    player = Player(engine, eval_fn, params, game, save_examples=True,
                    create_analysis=True,
                    generator=torch.Generator(device=dev).manual_seed(SEED))
    cfg = player.mcts.config
    if (player.mcts.tier != "hbm" or cfg.wave_size != P_WAVE
            or cfg.max_children != P_K or cfg.max_nodes != P_POOL
            or cfg.recycle):
        fail(f"Player defaults changed: tier {player.mcts.tier}, {cfg}")
    sync()
    kb.reset_launches()
    lines, rates = [], []
    carried = 0
    def visits_on_edges(tree):
        return int(tree.edge_n.sum()) + int(tree.root_n.sum())

    for i in range(P_MOVES):
        t0 = time.perf_counter()
        player.add_noise(0.2, 0.3)     # prepares the root, then mixes noise
        edges_before = visits_on_edges(player.tree)
        sync()
        t_search = time.perf_counter()
        sims = player.rollout(P_WAVES)
        sync()
        sec = time.perf_counter() - t0
        wave_ms = 1e3 * (time.perf_counter() - t_search) / P_WAVES
        # every backup adds one visit per edge between its leaf and the root
        depth = (visits_on_edges(player.tree) - edges_before) / sims
        n0 = int(player.tree.n0[0])
        if n0 != carried + 1 + sims:
            fail(f"Player move {i + 1}: root count {n0}, expected "
                 f"{carried} carried + 1 + {sims} rollouts")
        if not sims <= int(player.tree.root_n.sum()) < n0:
            fail(f"Player move {i + 1}: root edges hold "
                 f"{int(player.tree.root_n.sum())} visits, root {n0}")
        if int(player.tree.virt0[0]) != 0:
            fail(f"Player move {i + 1}: virtual visits left at the root")
        nodes = int(player.tree.next_free[0])
        if i == 0:
            searched = player.tree.clone()   # for the kernel checks afterwards
        mv = player.pick_move(True)
        if not player.game.legal_mask()[mv]:
            fail(f"Player move {i + 1}: illegal move {mv}")
        ptn = engine.tables.action_to_ptn(mv)
        carried = int(player.tree.root_n[0, mv])
        t1 = time.perf_counter()
        player.play_move(mv)
        sync()
        t_play = time.perf_counter() - t1
        if player.tree is None:
            kept = "carry dropped (more than half the pool)"
            carried = 0
        else:
            if int(player.tree.n0[0]) != carried:
                fail(f"Player move {i + 1}: the carried subtree holds "
                     f"{int(player.tree.n0[0])} visits, its edge had "
                     f"{carried}")
            kept = (f"{int(player.tree.next_free[0])} nodes and {carried} "
                    "visits carried")
        rates.append((sims, sec))
        lines.append(
            f"Player move {i + 1} ({ptn}): {sims} rollouts in {sec:.3f} s, "
            f"{sims / sec:,.0f} rollouts/s, {wave_ms:.3f} ms per wave, mean "
            f"leaf depth {depth:.2f}, {nodes} nodes; play_move (examples, "
            f"analysis, reroot) "
            f"{t_play * 1e3:.1f} ms, {kept}")
        log(lines[-1] + f" on {card}")
    launches = dict(kb.LAUNCHES)
    for name in HBM_TIER + ("fused_step",):
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the Player path")
    for name in POOL_TIER:
        if launches.get(name, 0) != 0:
            fail(f"pool-tier kernel {name} launched on the Player path")
    text = str(player.get_analysis())
    if text.count("{evaluation:") < P_MOVES - 1 or "{r: " not in text:
        fail(f"Player analysis did not render:\n{text}")
    examples = player.get_examples(1.0)
    if len(examples) != P_MOVES or any(e.visits.sum() <= 0 for e in examples):
        fail(f"Player examples: {len(examples)} for {P_MOVES} moves")
    rate = sum(s for s, _ in rates) / sum(t for _, t in rates)
    log(f"Player slice: {P_MOVES} moves, {rate:,.0f} rollouts/s overall, "
        f"launches {launches}, analysis {len(text)} chars, "
        f"{len(examples)} examples, on {card}")
    return launches, lines, rate, player, searched


def wide_wave_phase(engine, eval_fn, params, dev, card):
    """The Player at a wave of P_WIDE leaves (`-b 512` of the command
    lines), wider than the backup kernel's shared memory holds: root
    noise, P_WIDE_WAVES waves through the kernels (the root must count
    1 + rollouts), then both large-tier kernels held bitwise against their
    plain versions on that tree at V = P_WIDE and timed
    (`check_hbm_on_tree`).  Returns those times."""
    import torch

    from tak_tpu_torch.game import Game
    from tak_tpu_torch.kernels import build as kb
    from tak_tpu_torch.mcts import tree_kernels_hbm
    from tak_tpu_torch.player import Player

    game = Game.with_komi(N, 2, dev)
    for mv in ("a1", "f6"):
        game.play(mv)
    player = Player(engine, eval_fn, params, game, wave_size=P_WIDE,
                    generator=torch.Generator(device=dev).manual_seed(SEED))
    player.add_noise(0.2, 0.3)
    sync()
    kb.reset_launches()
    t0 = time.perf_counter()
    sims = player.rollout(P_WIDE_WAVES)
    sync()
    sec = time.perf_counter() - t0
    n0 = int(player.tree.n0[0])
    if n0 != 1 + sims or int(player.tree.virt0[0]) != 0:
        fail(f"Player at wave {P_WIDE}: root count {n0} after {sims} "
             "rollouts, or virtual visits left")
    if kb.LAUNCHES.get("expand_backup_wave_hbm", 0) <= 0:
        fail(f"Player at wave {P_WIDE}: the large-tier backup did not launch")
    scratch = tree_kernels_hbm._SCRATCH_BYTES.get(P_WIDE, 0)
    if scratch == 0:
        fail(f"Player at wave {P_WIDE}: the backup's paths were expected in "
             "its global buffer, not in shared memory")
    log(f"Player at wave {P_WIDE}: {sims} rollouts in {sec:.3f} s "
        f"({sims / sec:,.0f} rollouts/s), {int(player.tree.next_free[0])} "
        f"nodes, the backup's recorded paths in a global buffer of "
        f"{scratch:,} B, on {card}")
    return check_hbm_on_tree(player.mcts, params, player.tree,
                             f"the Player's tree at wave {P_WIDE}", card)


def check_single_step(engine, tree, card):
    """The fused step on one row, as `Game.play` launches it: the tree's
    root position and its most visited action, against the plain version."""
    import torch

    from tak_tpu_torch.engine.fused_env import fused_step, step_plain

    root = tree.state[:1, 0].map(lambda x: x.contiguous())
    act = tree.root_n[0].argmax().to(torch.int32).reshape(1)
    got = fused_step(engine, root, act)
    want = step_plain(engine, root, act)
    sync()
    compare_states(got, want, "fused_step on one row")
    if int(got.ply[0]) != int(root.ply[0]) + 1:
        fail("fused_step on one row did not step")
    t_kernel = launch_ms(lambda: fused_step(engine, root, act))
    t_plain = cuda_ms(lambda _: step_plain(engine, root, act), 2)
    t_bound, by = bound(*fused_step_work(root, 1))
    log(f"check fused_step on one row (Game.play): bitwise equal; kernel "
        f"{t_kernel:.4f} ms, plain {t_plain:.3f} ms, bound {t_bound:.7f} ms "
        f"({by}) on {card}")
    return t_kernel, t_plain, t_bound, by


def run_entry(cmd, here, text=None, timeout=300):
    """One entry point as a subprocess from the checkout's root; fatal
    unless it exits 0.  Returns its standard output."""
    try:
        out = subprocess.run([sys.executable, *cmd], cwd=here, input=text,
                             capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        fail(f"{' '.join(cmd)} did not finish in {timeout} s")
    if out.returncode != 0:
        fail(f"{' '.join(cmd)} exited {out.returncode}:\n"
             f"{out.stderr[-3000:]}")
    return out.stdout


def entry_points_phase(here, card):
    """The TEI server over pipes and the analysis command line on a PTN
    file, as a user starts them, on the card."""
    from tak_tpu_torch.engine.core import get_engine
    from tak_tpu_torch.engine.ptn import parse_ptn
    from tak_tpu_torch.game import Game

    t0 = time.perf_counter()
    out = run_entry(
        ["-m", "tak_tpu_torch.cli.tei", "random"], here,
        "tei\nisready\nposition startpos moves a1 f6\n"
        "go wtime 20000 btime 20000 winc 0 binc 0\nquit\n")
    lines = out.splitlines()
    info = [l for l in lines if l.startswith("info ") and " nps " in l]
    best = [l.split()[1] for l in lines if l.startswith("bestmove ")]
    if "teiok" not in lines or "readyok" not in lines or not info:
        fail(f"TEI output malformed:\n{out}")
    game = Game.from_ptn_moves(N, ["a1", "f6"], 4, device="cpu")
    if len(best) != 1 or best[0] not in [str(m) for m in game.possible_moves()]:
        fail(f"TEI bestmove {best} is not one legal move:\n{out}")
    log(f"entry point tei: bestmove {best[0]}; last {info[-1]} "
        f"({time.perf_counter() - t0:.1f} s with process start) on {card}")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ptn = os.path.join(tmp, "game.ptn")
        result = os.path.join(tmp, "analysis.ptn")
        with open(ptn, "w") as f:
            f.write('[Size "6"]\n[Komi "2"]\n\n1. a1 f6\n2. c3 d4\n')
        out = run_entry(
            ["-m", "tak_tpu_torch.cli.analysis_cli", str(N), "random",
             "--ptn-file", ptn, "--think-seconds", "1", "--out", result],
            here)
        if out.count("playing ") != 4 or not os.path.exists(result):
            fail(f"analysis_cli output malformed:\n{out}")
        with open(result) as f:
            text = f.read()
    _, moves = parse_ptn(get_engine(N), text, "cpu")
    if [str(m) for m in moves[:4]] != ["a1", "f6", "c3", "d4"] \
            or "{evaluation:" not in text:
        fail(f"analysis file malformed:\n{text}")
    log(f"entry point analysis_cli: 4 moves analysed, {len(text)} chars "
        f"written ({time.perf_counter() - t0:.1f} s with process start) "
        f"on {card}")


@contextlib.contextmanager
def timed_stages(patches):
    """Wrap each (object, attribute, stage name) callable in a synchronized
    host timer; yields the {stage: seconds} totals and restores the
    callables on exit."""
    stages = collections.defaultdict(float)

    def timed(name, fn):
        def wrapper(*a, **k):
            sync()
            t = time.perf_counter()
            out = fn(*a, **k)
            sync()
            stages[name] += time.perf_counter() - t
            return out
        return wrapper

    saved = [(obj, attr, obj.__dict__.get(attr)) for obj, attr, _ in patches]
    for obj, attr, name in patches:
        setattr(obj, attr, timed(name, getattr(obj, attr)))
    try:
        yield stages
    finally:
        for obj, attr, old in saved:
            if old is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, old)


def log_stages(stages, wall, what, card, per=1):
    log(f"profile stages (synchronized host timers, {what}, "
        f"{wall * 1e3 / per:.3f} ms wall on {card}):")
    for name, sec in sorted(stages.items(), key=lambda kv: -kv[1]):
        log(f"  {name}: {sec * 1e3 / per:.3f} ms ({100 * sec / wall:.1f}%)")
    rest = wall - sum(stages.values())
    log(f"  other host work: {rest * 1e3 / per:.3f} ms "
        f"({100 * rest / wall:.1f}%)")


def device_profile(run, what, card):
    """Device time per kernel and the device's busy share of the wall
    time of `run()` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only (kernels, copies): an operator's own entry
    # repeats the time of the kernels it launched
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(dev_us(e) for e in events) / 1e3
    log(f"profile device (torch.profiler, {what}): wall "
        f"{wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / (wall * 1e3):.1f}%), idle "
        f"{100 - 100 * busy / (wall * 1e3):.1f}% on {card}")
    for e in sorted(events, key=lambda e: -dev_us(e))[:15]:
        log(f"  {dev_us(e) / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:90]}")


def profile_search(mcts, params, root_states, card, what=None):
    """Where one search (by default a self-play move's: 10,240 sims on 32
    games) spends its time: once with a synchronized host timer around
    each stage of every wave, once under torch.profiler."""
    from tak_tpu_torch.mcts import search as search_mod

    patches = [(search_mod, "backup_descend_wave", "tree kernel (merged)"),
               (search_mod, "expand_backup_wave", "tree kernel (flush)"),
               (search_mod, "masked_topk", "masked top-K"),
               (search_mod, "masked_topk_packed", "masked top-K (packed words)"),
               (mcts, "_leaf_states_of", "leaf gather + fused step"),
               (mcts, "eval_fn", "observe + network"),
               (mcts.engine, "legal_mask", "legal mask"),
               (mcts, "_write_nodes", "write nodes")]
    what = what or ("one self-play move's search, fused_leaf_legal="
                    f"{mcts.config.fused_leaf_legal}")
    tree = mcts.prepare_root(params, mcts.init_batch(root_states))
    with timed_stages(patches) as stages:
        sync()
        t0 = time.perf_counter()
        mcts.run_sims(params, tree)
        sync()
        wall = time.perf_counter() - t0
    log_stages(stages, wall, what, card)
    tree = mcts.prepare_root(params, mcts.init_batch(root_states))
    device_profile(lambda: mcts.run_sims(params, tree), what, card)


def profile_player(player, card, waves=200):
    """Where one Player wave spends its time, as the mean over `waves`
    waves on the player's current (carried) tree: per-stage synchronized
    host timers, then torch.profiler; and what `debug()` and the reroot of
    `play_move` cost at this tree size."""
    from tak_tpu_torch.mcts import search as search_mod

    mcts = player.mcts
    patches = [(search_mod, "descend_wave_hbm", "descend kernel"),
               (search_mod, "expand_backup_wave_hbm", "expand+backup kernel"),
               (search_mod, "masked_topk", "masked top-K"),
               (mcts, "_leaf_states_of", "leaf gather + fused step"),
               (mcts, "eval_fn", "observe + network"),
               (mcts.engine, "legal_mask", "legal mask"),
               (mcts, "_write_nodes", "write nodes")]
    player.rollout(20)
    with timed_stages(patches) as stages:
        sync()
        t0 = time.perf_counter()
        player.rollout(waves)
        sync()
        wall = time.perf_counter() - t0
    log_stages(stages, wall, f"one Player wave, mean of {waves}", card, waves)
    device_profile(lambda: player.rollout(waves),
                   f"{waves} Player waves", card)
    sync()
    t0 = time.perf_counter()
    player.debug()
    t_debug = time.perf_counter() - t0
    nodes = int(player.tree.next_free[0])
    mv = player.pick_move(True)
    sync()
    t0 = time.perf_counter()
    player.play_move(mv, with_info=False)
    sync()
    log(f"profile Player host calls at {nodes} nodes on {card}: debug() "
        f"{t_debug * 1e3:.1f} ms, play_move without info (step + reroot) "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")


def state_bytes(state) -> int:
    from tak_tpu_torch.types import FIELDS

    return sum(getattr(state, f).numel() * getattr(state, f).element_size()
               for f in FIELDS)


def fused_step_work(state, rows: int):
    """(bytes, operations) of one fused step over `rows` rows: each state
    column read once and written once, plus the action and enabled
    inputs; per row the per-square decode and insert (~40 ops x n^2), and
    the result with the road flood fill (~12 ops x n^2 iterations x 2
    colors)."""
    n2 = state.heights.shape[-1]
    return 2 * state_bytes(state) + rows * (4 + 1), rows * (40 * n2 + 24 * n2)


def legal_ops(engine) -> int:
    """Integer operations of one row's packed legal bits: per square about
    10 for the placements and ownership and 4 rays of up to n-1 squares at
    about 4 each; about 6 per spread word (three table reads, AND, OR)."""
    n, n2, wp = engine.n, engine.num_squares, engine.pattern_words
    return n2 * (10 + 16 * (n - 1)) + 4 * wp * n2 * 6


def sample_ops(engine) -> int:
    """Integer operations of one row's sample: two passes (count, then
    find) over the 3 placement groups and 4*wp word groups of n^2 squares,
    about 8 operations per word with its popcount."""
    n2, wp = engine.num_squares, engine.pattern_words
    return 2 * (3 + 4 * wp) * n2 * 8


def step_legal_work(engine, state, rows: int):
    """The fused step's work plus the packed words written once (4 B per
    place word, 4 B per spread word: 1,296 B per 6x6 row) and their
    operations."""
    nbytes, ops = fused_step_work(state, rows)
    words = engine.num_squares * (1 + 4 * engine.pattern_words)
    return nbytes + rows * words * 4, ops + rows * legal_ops(engine)


def sampler_work(engine, state, rows: int, external: bool):
    """The state read once, the given words (8 B per row) if any, action
    and count written (8 B per row); the legal bits and the sample."""
    nbytes = state_bytes(state) + rows * (8 + (8 if external else 0))
    return nbytes, rows * (legal_ops(engine) + sample_ops(engine))


def rollout_work(engine, state, rows: int, steps: int, external: bool):
    """One read and one write of the state (plus the given words, 8 B per
    row and step, if any) and `steps` times the per-step operations of a
    row: legal bits, sample, step, result, and the generator's 10 rounds
    of about 10 operations."""
    n2 = engine.num_squares
    nbytes = 2 * state_bytes(state) + (rows * steps * 8 if external else 0)
    per_step = legal_ops(engine) + sample_ops(engine) + 64 * n2 + 100
    return nbytes, rows * steps * per_step


def same_tensors(got, want, what):
    for i, (x, y) in enumerate(zip(got, want)):
        if x.dtype != y.dtype or x.shape != y.shape:
            fail(f"{what}: output {i} is {x.dtype} {tuple(x.shape)}, the "
                 f"plain version gives {y.dtype} {tuple(y.shape)}")
        if not bool((x == y).all()):
            fail(f"{what}: output {i} differs in {int((x != y).sum())} "
                 "entries")


def check_step_legal(engine, states, acts, enabled, what):
    """Hold the fused step with legal bits against its plain version,
    bitwise on the states and on the packed words, and the unpacked words
    against the dense legal mask of the output states."""
    from tak_tpu_torch.engine.legal_bits import (
        step_legal,
        step_legal_plain,
        unpack_legal,
    )

    got, place, spread = step_legal(engine, states, acts, enabled)
    want, wplace, wspread = step_legal_plain(engine, states, acts, enabled)
    sync()
    compare_states(got, want, f"fused_step_legal ({what})")
    same_tensors((place, spread), (wplace, wspread),
                 f"fused_step_legal words ({what})")
    dense = engine.legal_mask(got)
    if not bool((unpack_legal(engine, place, spread) == dense).all()):
        fail(f"fused_step_legal ({what}): the unpacked words are not "
             "Engine.legal_mask of the output states")
    rows = acts.shape[0]
    stepped = int((got.ply != states.ply).sum())
    log(f"check fused_step_legal ({what}): {rows} rows, states and "
        f"{place.shape[1] + spread[0].numel()} words per row bitwise equal, "
        f"unpacked words equal the dense legal mask ({stepped} stepped, "
        f"{rows - stepped} frozen, {int(dense.sum()) / rows:.1f} legal "
        "actions per row)")


def pieces(state):
    """Per row: pieces on the board plus both colours' reserves."""
    return state.heights.sum(-1) + state.stones.sum(-1) + state.caps.sum(-1)


def check_rollout_kernels(engine, states, rng, card):
    """Hold the legal sampler (on `states`) and the env rollout (R_ENVS
    rows x R_STEPS steps, from `states`' first R_ENVS rows) against their
    plain versions, bitwise, with given words and with a seed; time them.
    Returns {kernel: (ms, plain_ms, bound_ms, bound_by)}."""
    import torch

    from tak_tpu_torch.engine.env_rollout import (
        env_rollout,
        env_rollout_plain,
        legal_sampler,
        legal_sampler_plain,
    )

    dev = states.device
    rows = states.ply.shape[0]

    def words(shape):
        return u32_words(rng, shape, dev)

    out = {}
    bits = words(rows)
    for kw, how in ((dict(bits=bits), "given words"), (dict(seed=SEED + 7),
                                                       "seeded")):
        got = legal_sampler(engine, states, **kw)
        want = legal_sampler_plain(engine, states, **kw)
        sync()
        same_tensors(got, want, f"legal_sampler ({how})")
    legal = engine.legal_mask(states)
    ok = legal[torch.arange(rows, device=dev), got[0].long()]
    if not bool((ok | (got[1] == 0)).all()) \
            or not bool((got[1] == legal.sum(1)).all()):
        fail("legal_sampler: an illegal action or a wrong legal count")
    out["legal_sampler"] = (
        launch_ms(lambda: legal_sampler(engine, states, seed=SEED + 7)),
        cuda_ms(lambda _: legal_sampler_plain(engine, states, seed=SEED + 7),
                2),
        *bound(*sampler_work(engine, states, rows, False)))
    out["legal_sampler, given words"] = (
        launch_ms(lambda: legal_sampler(engine, states, bits=bits)),
        cuda_ms(lambda _: legal_sampler_plain(engine, states, bits=bits), 2),
        *bound(*sampler_work(engine, states, rows, True)))
    log(f"check legal_sampler: {rows} rows bitwise equal with given words "
        f"and seeded, every action legal, counts equal the dense mask's "
        f"(mean {float(got[1].float().mean()):.1f} legal actions)")

    start = states[:R_ENVS].map(lambda x: x.contiguous())
    tbits = words((R_STEPS, R_ENVS))
    t_plain = []
    for kw, how in ((dict(bits=tbits), "given words"),
                    (dict(seed=(SEED + 1) << 33 | 5), "seeded")):
        got = env_rollout(engine, start, R_STEPS, **kw)
        sync()
        t0 = time.perf_counter()
        want = env_rollout_plain(engine, start, R_STEPS, **kw)
        sync()
        t_plain.append(1e3 * (time.perf_counter() - t0))
        compare_states(got, want, f"env_rollout ({how})")
        if bool((got.result != 0).any()):
            fail(f"env_rollout ({how}): a finished game was not reset")
    restarted = int((got.ply < start.ply + R_STEPS).sum())
    seeded = dict(seed=(SEED + 1) << 33 | 5)
    out["env_rollout"] = (
        cuda_ms(lambda _: env_rollout(engine, start, R_STEPS, **seeded), 5),
        t_plain[1],
        *bound(*rollout_work(engine, start, R_ENVS, R_STEPS, False)))
    log(f"check env_rollout: {R_ENVS} rows x {R_STEPS} steps bitwise equal on "
        f"every field with given words and seeded ({restarted} rows "
        f"restarted a game; plain versions {t_plain[0]:.0f} / "
        f"{t_plain[1]:.0f} ms) on {card}")
    return out


def check_env_sizes(dev, rng, card):
    """Hold the env kernels against their plain versions, bitwise, at every
    size 3-8 (one or two squares a lane, one to four stack words, one to
    eight words a spread direction): on the hand-built cases of
    `env_cases` (the steps with the cases' actions and enabled rows; the
    rollout CASE_STEPS steps from the cases' positions, with given words
    and seeded) and on SIZE_ROWS playout rows (the steps with random legal
    actions, some rows disabled; the rollout SIZE_STEPS steps with given
    words).  The fused step (#1) and the step with legal bits (#5: states,
    `place` and `spread`, frozen and finished rows included) on both row
    sets; the sampler (#6, given words and seeded) on both row sets and on
    the positions their step leaves; the rollout (#7)."""
    import torch

    from tak_tpu_torch.engine import env_cases
    from tak_tpu_torch.engine.core import get_engine
    from tak_tpu_torch.engine.env_rollout import (
        env_rollout,
        env_rollout_plain,
        legal_sampler,
        legal_sampler_plain,
    )
    from tak_tpu_torch.engine.fused_env import fused_step, step_plain
    from tak_tpu_torch.engine.legal_bits import step_legal, step_legal_plain

    def legal_kernels(engine, st, a, en, what):
        got = step_legal(engine, st, a, en)
        want = step_legal_plain(engine, st, a, en)
        compare_states(got[0], want[0], f"fused_step_legal ({what})")
        same_tensors(got[1:], want[1:], f"fused_step_legal words ({what})")
        rows = st.ply.shape[0]
        seeded = dict(seed=SEED + rows)
        for pos, sst in (("", st), (", stepped", want[0])):
            for kw, how in ((dict(bits=u32_words(rng, rows, dev)),
                             "given words"), (seeded, "seeded")):
                same_tensors(legal_sampler(engine, sst, **kw),
                             legal_sampler_plain(engine, sst, **kw),
                             f"legal_sampler ({what}{pos}, {how})")

    t0 = time.perf_counter()
    for n in env_cases.SIZES:
        engine = get_engine(n)
        names, fields, acts, enabled, _ = env_cases.batch(n)
        st = env_cases.as_state(fields, dev)
        a = torch.as_tensor(acts, device=dev)
        en = torch.as_tensor(enabled, device=dev)
        compare_states(fused_step(engine, st, a, en),
                       step_plain(engine, st, a, en),
                       f"fused_step ({n}x{n} env cases)")
        legal_kernels(engine, st, a, en, f"{n}x{n} env cases")
        for kw, how in ((dict(bits=u32_words(rng, (CASE_STEPS, len(names)),
                                             dev)), "given words"),
                        (dict(seed=SEED + n), "seeded")):
            compare_states(env_rollout(engine, st, CASE_STEPS, **kw),
                           env_rollout_plain(engine, st, CASE_STEPS, **kw),
                           f"env_rollout ({n}x{n} env cases, {how})")
        play = playout_states(engine, SIZE_ROWS, 10 * n, rng, dev)
        pa = random_legal(engine, play, rng)
        pe = torch.as_tensor(rng.random(SIZE_ROWS) < 0.9, device=dev)
        compare_states(fused_step(engine, play, pa, pe),
                       step_plain(engine, play, pa, pe),
                       f"fused_step ({n}x{n} playout rows)")
        legal_kernels(engine, play, pa, pe, f"{n}x{n} playout rows")
        bits = u32_words(rng, (SIZE_STEPS, SIZE_ROWS), dev)
        compare_states(env_rollout(engine, play, SIZE_STEPS, bits=bits),
                       env_rollout_plain(engine, play, SIZE_STEPS, bits=bits),
                       f"env_rollout ({n}x{n} playout rows)")
        sync()
        log(f"check {n}x{n}: fused_step, fused_step_legal (states and "
            f"words), legal_sampler (given words and seeded, before and "
            f"after the step) and env_rollout bitwise equal on "
            f"{len(set(names))} hand-built env cases ({len(names)} rows, max "
            f"height {int(st.heights.max())}; the rollout {CASE_STEPS} steps, "
            f"given words and seeded) and on {SIZE_ROWS} playout rows (max "
            f"height {int(play.heights.max())}; the rollout {SIZE_STEPS} "
            "steps)")
    log(f"check env kernels at sizes 3-8 on {card}: "
        f"{time.perf_counter() - t0:.1f} s")


def env_rollout_phase(engine, dev, card):
    """The env rollout as a user drives it (the JAX package's
    bench.py:70-81): `Engine.env_rollout_fn(R_STEPS)` on R_ENVS fresh games
    at half-komi 4, one warm-up launch, R_LAUNCHES timed launches with
    seeds 1.., one synchronization.  Returns (launch counts, the result
    line, the env steps per second)."""
    import torch

    from tak_tpu_torch.engine.env_rollout import legal_sampler
    from tak_tpu_torch.kernels import build as kb
    from tak_tpu_torch.types import ONGOING

    start = engine.initial_batch(R_ENVS, half_komi=4, device=dev)
    rollout = engine.env_rollout_fn(R_STEPS)
    sync()
    kb.reset_launches()
    states = rollout(start, 0)
    sync()
    t0 = time.perf_counter()
    for i in range(R_LAUNCHES):
        states = rollout(states, i + 1)
    sync()
    sec = time.perf_counter() - t0
    if dict(kb.LAUNCHES) != {"env_rollout": R_LAUNCHES + 1}:
        fail(f"env rollout path: launches {dict(kb.LAUNCHES)}, expected "
             f"{R_LAUNCHES + 1} of env_rollout and nothing else")
    if not bool((states.result == ONGOING).all()):
        fail("env rollout path: a row is not ongoing after the rollout")
    if not bool((pieces(states) == pieces(start)).all()):
        fail("env rollout path: pieces were not conserved")
    if not bool((states.half_komi == 4).all()):
        fail("env rollout path: komi was not kept")
    # one more draw per final row, by the sampler kernel: all legal
    act, total = legal_sampler(engine, states, seed=SEED)
    legal = engine.legal_mask(states)
    sync()
    if not (bool(legal[torch.arange(R_ENVS, device=dev), act.long()].all())
            and bool((total == legal.sum(1)).all())):
        fail("env rollout path: the sampler drew an illegal action")
    launches = dict(kb.LAUNCHES)
    rate = R_ENVS * R_STEPS * R_LAUNCHES / sec
    line = (f"env rollout: {R_LAUNCHES} launches of {R_ENVS} games x "
            f"{R_STEPS} steps in {sec * 1e3:.2f} ms, {rate:,.0f} env steps/s "
            f"({sec * 1e3 / R_LAUNCHES:.3f} ms per launch); every row "
            f"ongoing, pieces conserved, mean ply "
            f"{float(states.ply.float().mean()):.1f}, "
            f"{float(total.float().mean()):.1f} legal actions per row")
    log(line + f"; launches {launches} on {card}")
    return launches, line, rate


def selfplay_phase(engine, eval_fn, params, dev, card, what, moves,
                   **search_options):
    """The self-play slice at the reference config for `moves` searched
    moves, `search_options` added to its SearchConfig.  Checks every
    chosen action legal and every root's gain of exactly the searched
    sims.  Returns (launch counts, per-move lines, sims/s over the moves
    after the first (the only move's, if one), a clone of move 1's
    searched tree)."""
    import torch

    from tak_tpu_torch.kernels import build as kb
    from tak_tpu_torch.types import ONGOING

    actor = make_actor(engine, eval_fn, dev, moves, **search_options)
    scfg = actor.search_config
    per_move, first_tree = [], []
    orig_run, orig_select = actor.mcts.run_sims, actor.mcts.select_moves

    def run_sims(p, t):
        before_n0 = t.n0.clone()
        before_sum = t.root_n.sum(1)
        out = orig_run(p, t)
        gained = out.n0 - before_n0
        visits = out.root_n.sum(1) - before_sum
        want_sims = scfg.num_waves * scfg.wave_size
        if not (bool((gained == want_sims).all())
                and bool((visits == want_sims).all())):
            fail(f"{what}: root visits did not grow by {want_sims}: n0 "
                 f"{gained.tolist()} root_n {visits.tolist()}")
        if not first_tree:
            first_tree.append(out.clone())
        return out

    def select_moves(gen, t, exploit):
        a = orig_select(gen, t, exploit)
        roots = t.state[:, 0]
        legal = engine.legal_mask(roots)
        ok = legal[torch.arange(a.shape[0], device=dev), a.long()]
        ongoing = roots.result == ONGOING
        if not bool((ok | ~ongoing).all()):
            fail(f"{what}: illegal action chosen: {a.tolist()}")
        per_move.append(int(ongoing.sum()))
        return a

    actor.mcts.run_sims = run_sims
    actor.mcts.select_moves = select_moves
    sync()
    kb.reset_launches()
    t0 = time.perf_counter()
    examples = actor.run(params, seed=SEED, log=lambda m: log(f"  {m}"))
    sync()
    wall = time.perf_counter() - t0
    launches = dict(kb.LAUNCHES)
    if len(actor.move_times) != moves:
        fail(f"{what} searched {len(actor.move_times)} moves, expected "
             f"{moves}")
    move_lines = []
    for i, ((sec, sims), games) in enumerate(zip(actor.move_times, per_move)):
        move_lines.append(f"move {i + 1}: {sec:.3f} s, {GAMES} trees x "
                          f"{sims} sims ({games} live games), "
                          f"{GAMES * sims / sec:,.0f} sims/s")
        log(f"{what}: " + move_lines[-1] + f" on {card}")
    steady = actor.move_times[1:] or actor.move_times
    rate = GAMES * sum(s for _, s in steady) / sum(t for t, _ in steady)
    log(f"{what}: {moves} moves in {wall:.2f} s, {len(examples)} examples; "
        f"{rate:,.0f} self-play sims/s over move"
        f"{'s 2-' + str(moves) if moves > 2 else ' ' + str(moves)} on {card}")
    log(f"launches in {what}: {launches}")
    return launches, move_lines, rate, first_tree[0]


def selfplay_rows(engine, rng, dev):
    """One self-play wave's leaf rows (ROWS varied 6x6 positions from
    seeded random playouts, every 37th counted as a finished game) and
    GAMES mid-game roots among them."""
    import torch

    from tak_tpu_torch.types import ONGOING

    states = playout_states(engine, ROWS, 50, rng, dev)
    result = states.result.clone()
    result[::37] = 3  # some rows count as finished games: they must freeze
    states = states.replace(result=result)
    live_rows = torch.nonzero(states.result == ONGOING).flatten()[:GAMES]
    return states, states[live_rows]


def midsearch_tree(engine, eval_fn, params, roots):
    """The pool-tier kernels' main-path tree: GAMES searches of the
    reference self-play config from `roots`, grown by pipelined waves until
    the 1,280-node pool is full in every game.  Returns (the MCTS, the
    tree, the pending wave)."""
    from tak_tpu_torch.mcts.search import MCTS
    from tak_tpu_torch.mcts.tree_kernels import Pending

    dev = roots.ply.device
    scfg = make_actor(engine, eval_fn, dev, MOVES).search_config
    if scfg.max_nodes != POOL or scfg.scan_chunk != 512:
        fail(f"unexpected default search config {scfg}")
    mcts = MCTS(engine, eval_fn, scfg)
    tree = mcts.prepare_root(params, mcts.init_batch(roots))
    pending = Pending.zeros(GAMES, WAVE, K, dev)
    waves = 0
    while waves < 12 and not (waves >= 2 and
                              bool((tree.next_free == POOL).all())):
        pending = mcts._wave_pipelined(params, tree, pending)
        waves += 1
    sync()
    if not bool((tree.next_free == POOL).all()):
        fail(f"pool not full after {waves} waves: {tree.next_free.tolist()}")
    log(f"tree: {waves} waves, pool full ({POOL} nodes) in all {GAMES} "
        "games")
    return mcts, tree, pending


def pool_chain_floors(tree, pending, checks, V=WAVE):
    """The chain floors of the pool-tier kernels on a mid-search tree of
    waves of V (`chain_floor`): #4 the chase down its own wave's paths, #3
    the chase up the pending leaves' paths on the tree before the flush,
    #2 both (its backups, then its own descents).  Returns ({kernel: ms},
    a description)."""
    d_tree, _, _, d_leaves = checks["descend_wave"]
    m_tree, _, _, m_leaves = checks["backup_descend_wave"]
    down4, _, text4 = chain_floor(d_tree, d_leaves, V)
    _, up3, text3 = chain_floor(tree, pending.leaves, V)
    down2, _, text2 = chain_floor(m_tree, m_leaves, V)
    floors = {"backup_descend_wave": up3 + down2, "descend_wave": down4,
              "expand_backup_wave": up3}
    return floors, (f"descend wave: {text4}; the pending leaves: {text3}; "
                    f"merged wave's descents: {text2}")


def check_pool_cases(engine, dev, card):
    """Hold the pool-tier kernels against their plain versions, bitwise,
    on the hand-built trees of `tree_cases` at the self-play shape (two
    games, K=32, A=9,036, M=1,280): the recycling cases at V=256 and the
    large tier's shared-prefix, repeated-leaf and deep-chain trees with
    recycling on, at the largest wave their rows take.  Per case: a first
    wave (descend alone, or the merged kernel on the case's wave in
    flight), which must be the case it was built to be, then the merged
    kernel on a seeded evaluation of its leaves, then the flush of the
    next."""
    import torch

    from tak_tpu_torch.mcts import tree_cases
    from tak_tpu_torch.mcts.search import SearchConfig
    from tak_tpu_torch.mcts.tree import init_tree
    from tak_tpu_torch.mcts.tree_kernels import (
        Pending,
        backup_descend_plain,
        backup_descend_wave,
        expand_backup_plain,
        expand_backup_wave,
    )

    t0 = time.perf_counter()
    cfg = SearchConfig()
    kargs = dict(base=float(cfg.exploration_base),
                 init=float(cfg.exploration_init), recycle=True)
    B, A = 2, engine.num_actions
    roots = engine.initial_batch(B, 4, dev)

    def evaluation(leaves, seed):
        return Pending(**{f: torch.as_tensor(a, device=dev) for f, a in
                          tree_cases.hand_pending(leaves.cpu().numpy(), K, A,
                                                  seed).items()}, valid=1)

    def both(tree, run_k, run_p, what):
        tk, tp = tree.clone(), tree.clone()
        out_k, out_p = run_k(tk), run_p(tp)
        sync()
        compare_trees(tk, tp, what)
        if out_k is not None and not all(bool((x == y).all())
                                         for x, y in zip(out_k, out_p)):
            fail(f"{what}: leaves/created differ")
        return tk, out_k

    seen = []
    for case in (*tree_cases.POOL_CASES, "shared_prefix", "dups_twice",
                 "one_leaf", "deep_chain"):
        V = tree_cases.max_wave(case, K, WAVE)
        what = f"pool-tier kernels, hand-built tree {case}, V={V}"
        tree = init_tree(engine, roots, POOL, K)
        fields = tree_cases.hand_tree(case, B, POOL, K, A, V, SEED)
        in_flight = fields.pop("pending_leaves", None)
        for f, a in fields.items():
            getattr(tree, f).copy_(torch.as_tensor(a))
        if in_flight is not None and (in_flight != -1).all():
            pending = evaluation(torch.as_tensor(in_flight), SEED + 1)
        else:
            pending = Pending.zeros(B, V, K, dev)
        tk, (lk, ck) = both(
            tree, lambda t: backup_descend_wave(t, pending, **kargs),
            lambda t: backup_descend_plain(t, pending, **kargs),
            f"{what}, first wave")
        try:
            tree_cases.check_first_wave(case, tree.to_numpy(), tk.to_numpy(),
                                        lk.cpu().numpy(), ck.cpu().numpy(),
                                        in_flight)
        except AssertionError as e:
            fail(f"{what}: the first wave is not the case it was built to "
                 f"be: {e!r}")
        recycled = int(((tree.parent != -1) & (
            (tk.parent != tree.parent)
            | (tk.parent_action != tree.parent_action))).sum())
        second = evaluation(lk, SEED + 2)
        tk, (lk, _) = both(
            tk, lambda t: backup_descend_wave(t, second, **kargs),
            lambda t: backup_descend_plain(t, second, **kargs),
            f"{what}, merged wave")
        third = evaluation(lk, SEED + 3)
        both(tk, lambda t: expand_backup_wave(t, third, recycle=True),
             lambda t: expand_backup_plain(t, third, recycle=True),
             f"{what}, flush")
        seen.append(f"{case} V={V}: {int(ck.sum())} created, {recycled} "
                    "slots recycled in the first wave")
    log(f"check pool tier on hand-built trees (B={B} K={K} A={A} M={POOL}): "
        "descend, merged backup+descend and flush bitwise equal to the plain "
        "versions on " + "; ".join(seen)
        + f" in {time.perf_counter() - t0:.1f} s on {card}")


def train_run(net, variables, examples, rng, what, **kw):
    """One `Network.train` call, synchronized, its log lines echoed.  Fatal
    unless every step's loss parts are finite, every weight and statistic
    is finite and every parameter changed.  Returns (new variables, wall
    seconds, step lines)."""
    import torch

    logs = []
    sync()
    t0 = time.perf_counter()
    new = net.train(variables, examples, rng=rng, log=logs.append, **kw)
    sync()
    wall = time.perf_counter() - t0
    for line in logs:
        log(f"  {line}")
    steps = [line for line in logs if " step" in line]
    for line in steps:
        parts = [float(line.split(f" {c}=")[1].split()[0]) for c in "pz"]
        if not all(math.isfinite(x) for x in parts):
            fail(f"{what}: loss parts not finite: {line}")
    for k, v in new.items():
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            fail(f"{what}: {k} is not finite after training")
        if (not k.endswith(("running_mean", "running_var",
                            "num_batches_tracked"))
                and torch.equal(v.cpu(), variables[k].cpu())):
            fail(f"{what}: parameter {k} did not change")
    return new, wall, steps


def describe(config) -> str:
    n = config.n
    return (f"{n}x{n}, {config.blocks} x {config.filters}, "
            f"{str(config.dtype).replace('torch.', '')}")


def learner_net5_phase(dev, card):
    """The learner on real data: the trained Net5 and the committed 5x5
    self-play buffer, one `Network.train` pass (56 chunks of 500: 2 steps
    and the trailing flush) after a one-chunk warm-up call.  Returns
    (numbers, network, weights, buffer)."""
    import numpy as np

    from tak_tpu_torch.engine.core import get_engine
    from tak_tpu_torch.examples import ReplayBuffer
    from tak_tpu_torch.model.network import CHUNK_SIZE, Network
    from tak_tpu_torch.model.resnet import NetConfig

    engine = get_engine(5)
    net = Network(engine, NetConfig.for_size(5), device=dev)
    variables = net.load(NET5_WEIGHTS)
    buf = ReplayBuffer()
    t0 = time.perf_counter()
    buf.load(engine, NET5_BUFFER)
    t_load = time.perf_counter() - t0
    if len(buf) != NET5_EXAMPLES:
        fail(f"{NET5_BUFFER} holds {len(buf)} examples, not {NET5_EXAMPLES}")
    # one chunk first, so that cuDNN has picked its algorithms
    _, t_warm, _ = train_run(net, variables, buf.examples[:CHUNK_SIZE],
                             np.random.default_rng(0), "Net5 warm-up",
                             chunks_in_step=1)
    _, wall, steps = train_run(net, variables, buf.examples,
                               np.random.default_rng([0, 6]), "Net5 learner")
    chunks = len(buf) // CHUNK_SIZE
    if len(steps) != 3:
        fail(f"Net5 learner took {len(steps)} steps, not 2 + the flush")
    rate = chunks * CHUNK_SIZE / wall
    out = {"examples_per_s": rate, "ms_per_chunk": wall * 1e3 / chunks,
           "parse_s": t_load}
    log(f"learner Net5 ({describe(net.config)}) on {NET5_BUFFER}: {len(buf)} "
        f"examples parsed in {t_load:.2f} s; warm-up (one chunk, one step) "
        f"{t_warm:.2f} s; one pass, {chunks} chunks of {CHUNK_SIZE} x 8 rows "
        f"(2 steps and the trailing flush), in {wall:.3f} s (prestack "
        "included): "
        f"{rate:,.0f} examples/s, {out['ms_per_chunk']:.2f} ms per chunk; "
        f"every parameter changed, losses and weights finite, on {card}")
    return out, net, variables, buf


def forward_flops_per_row(config) -> int:
    """Operations of one forward row: the 3x3 convolutions and the value
    Linear (2 per multiply-add)."""
    from tak_tpu_torch.sizes import input_channels, move_channels

    n, f = config.n, config.filters
    convs = ([(input_channels(n), f)] + [(f, f)] * (2 * config.blocks)
             + [(f, move_channels(n))])
    return sum(2 * 9 * n * n * ci * co for ci, co in convs) + 2 * f * n * n


def seeded_examples(engine, count, rng, dev):
    """`count` examples of the JAX package's layout from seeded random
    playouts: sparse visits (1-199) over up to 47 legal actions of each
    position, results in {-1, 0, 1}."""
    import numpy as np

    from tak_tpu_torch.examples import Example

    states = playout_states(engine, count, 60, rng, dev)
    legal = engine.legal_mask(states).cpu().numpy()
    host = states.to_numpy()
    out = []
    for i in range(count):
        acts = np.nonzero(legal[i])[0]
        k = min(len(acts), int(rng.integers(1, 48)))
        acts = (np.sort(rng.choice(acts, k, replace=False)) if k
                else np.zeros(1, np.int64))
        out.append(Example(
            state={f: v[i] for f, v in host.items()},
            actions=acts.astype(np.int32),
            visits=rng.integers(1, 200, len(acts)).astype(np.int32),
            result=float(rng.choice([-1.0, 0.0, 1.0]))))
    return out


def learner_net6_phase(dev, card, rng):
    """The learner at the reference step: the trained Net6, 20,000 seeded
    6x6 examples, 2 optimizer steps of 20 chunks x 500 x 8 = 80,000 rows
    (after a one-chunk warm-up call that lets cuDNN pick its algorithms).
    Returns (numbers, network, incumbent, candidate, examples)."""
    import numpy as np

    from tak_tpu_torch.engine.core import get_engine
    from tak_tpu_torch.model.network import (
        CHUNK_SIZE,
        CHUNKS_IN_STEP,
        Network,
    )
    from tak_tpu_torch.model.resnet import NetConfig

    engine = get_engine(6)
    net = Network(engine, NetConfig.for_size(6), device=dev)
    variables = net.load(NET6_WEIGHTS)
    t0 = time.perf_counter()
    examples = seeded_examples(engine, L6_EXAMPLES, rng, dev)
    t_make = time.perf_counter() - t0
    _, t_warm, _ = train_run(net, variables, examples[:CHUNK_SIZE],
                             np.random.default_rng(0), "Net6 warm-up",
                             chunks_in_step=1)
    new, wall, steps = train_run(net, variables, examples,
                                 np.random.default_rng([0, 7]),
                                 "Net6 learner")
    if len(steps) != L6_EXAMPLES // (CHUNK_SIZE * CHUNKS_IN_STEP):
        fail(f"Net6 learner took {len(steps)} steps")
    rows = CHUNKS_IN_STEP * CHUNK_SIZE * 8
    fwd = forward_flops_per_row(net.config)
    step_flops = 3 * fwd * rows
    ms_step = wall * 1e3 / len(steps)
    share = step_flops / (ms_step / 1e3) / BF16_OPS_PER_S
    out = {"examples_per_s": L6_EXAMPLES / wall, "ms_per_step": ms_step,
           "bf16_share": share, "step_tflop": step_flops / 1e12}
    log(f"learner Net6 ({describe(net.config)}) at the reference step: "
        f"{L6_EXAMPLES} seeded examples made in {t_make:.1f} s; warm-up "
        f"(one chunk, one step) {t_warm:.2f} s; {len(steps)} steps of "
        f"{CHUNKS_IN_STEP} x {CHUNK_SIZE} x 8 = {rows:,} rows in {wall:.3f} s "
        f"(prestack included): {out['examples_per_s']:,.0f} examples/s, "
        f"{ms_step:.1f} ms per step; forward {fwd / 1e6:.1f} MFLOP a row, "
        f"a step {step_flops / 1e12:.1f} TFLOP (3 x forward), "
        f"{100 * share:.1f}% of the bf16 peak of {BF16_OPS_PER_S / 1e12:.0f} "
        f"TFLOP/s, on {card}")
    return out, net, variables, new, examples


def card_vs_cpu_phase(dev, card, variables, examples):
    """One 500-example chunk of Net5 on the card and through the port on
    the CPU, the same weights and rows, TF32 off: the loss parts, the
    summed gradients and the new batch statistics, in float32 (and first
    in float64, on the chunk's first 125 examples).  Tolerances (relative
    errors; a tensor's to its own largest magnitude or norm):
      * float64: loss parts, statistics and every gradient tensor 1e-6:
        the same arithmetic on both devices.
      * float32: loss parts and statistics 1e-4; the summed gradients as
        one vector 2e-3 of their norm and each tensor 1e-2 of its norm.
        flax's BatchNorm takes the variance as E[x^2] - E[x]^2, whose
        float32 cancellation each side's gradients carry: the phase prints
        how far each side's float32 gradients lie from float64 ones
        (PERF.md §6, PR 8), and the two sides differ by about that.
    The conv biases that a BatchNorm follows have a gradient of zero up to
    rounding: theirs is held, absolutely, to 1e-3 (float64: 1e-6) of the
    largest gradient of the conv's weight.  Returns the float32 errors."""
    import numpy as np
    import torch

    from tak_tpu_torch.engine.core import get_engine
    from tak_tpu_torch.model.network import CHUNK_SIZE, Network
    from tak_tpu_torch.model.resnet import NetConfig

    chunk = examples[:CHUNK_SIZE]
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def one_chunk(where, dtype, rows):
        cfg = dataclasses.replace(NetConfig.for_size(5), dtype=dtype)
        net = Network(get_engine(5), cfg, device=where)
        model = net._train_model(variables)
        pre = net._prestack(rows)
        sync()
        t0 = time.perf_counter()
        lp, lz = net._accum_chunk(
            model, *net._chunk_arrays(pre, np.arange(len(rows))))
        sync()
        return ((float(lp), float(lz)),
                {k: p.grad.detach().cpu().double()
                 for k, p in model.named_parameters()},
                {k: b.detach().cpu().double() for k, b in model.named_buffers()
                 if k.endswith(("running_mean", "running_var"))},
                time.perf_counter() - t0)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm().clamp(min=1e-300))

    def bn_led(k):   # a conv bias that a BatchNorm follows
        return k.endswith(".bias") and (k.startswith("stem.") or ".conv" in k)

    def flat(grads):
        return torch.cat([g.flatten() for k, g in grads.items()
                          if not bn_led(k)])

    out = {}
    try:
        # float64 on a quarter of the chunk: the host's float64 convolutions
        # are slow, and agreement to 1e-6 needs no more rows.  How far each
        # side's float32 gradients lie from them, on the same rows, is the
        # scale of the float32 tolerance below.
        quarter = chunk[:len(chunk) // 4]
        exact = one_chunk(dev, torch.float64, quarter)[1]
        far = [rel_l2(flat(one_chunk(where, torch.float32, quarter)[1]),
                      flat(exact)) for where in (dev, torch.device("cpu"))]
        log(f"float32 gradients of {len(quarter)} x 8 rows against float64 "
            f"ones (L2, as one vector): the card's {far[0]:.2e}, the host "
            f"CPU's {far[1]:.2e}")
        for dtype, tol, rows in ((torch.float64, 1e-6, quarter),
                                 (torch.float32, None, chunk)):
            (loss_c, grad_c, stat_c, t_c), (loss_h, grad_h, stat_h, t_h) = (
                one_chunk(dev, dtype, rows),
                one_chunk(torch.device("cpu"), dtype, rows))
            bn_bias = [k for k in grad_h if bn_led(k)]
            rest = [k for k in grad_h if not bn_led(k)]
            err = {
                "loss": max(abs(a - b) / abs(b)
                            for a, b in zip(loss_c, loss_h)),
                "stats": max(rel(stat_c[k], stat_h[k]) for k in stat_h),
                "bn_biases": max(
                    float((grad_c[k] - grad_h[k]).abs().max()
                          / grad_h[k[:-4] + "weight"].abs().max())
                    for k in bn_bias),
                "grads": rel_l2(flat(grad_c), flat(grad_h)),
                "tensor_l2": max(rel_l2(grad_c[k], grad_h[k]) for k in rest),
                "tensor_max": max(rel(grad_c[k], grad_h[k]) for k in rest),
            }
            limits = ({k: tol for k in err} if tol else
                      {"loss": 1e-4, "stats": 1e-4, "bn_biases": 1e-3,
                       "grads": 2e-3, "tensor_l2": 1e-2, "tensor_max": None})
            name = str(dtype).replace("torch.", "")
            log(f"card against CPU (Net5 in {name}, TF32 off, one chunk of "
                f"{len(rows)} x 8 rows): largest relative error of the loss "
                f"parts {err['loss']:.2e} (policy {loss_c[0]:.6f} vs "
                f"{loss_h[0]:.6f}, value {loss_c[1]:.6f} vs {loss_h[1]:.6f}), "
                f"of the new batch statistics {err['stats']:.2e}, of the "
                f"summed gradients as one vector {err['grads']:.2e} (L2), "
                f"of a gradient tensor {err['tensor_l2']:.2e} (L2) and "
                f"{err['tensor_max']:.2e} (largest entry), of the BN-led conv "
                f"biases' gradients to their weights' {err['bn_biases']:.2e}; "
                "limits " + ", ".join(f"{k} {v:g}" for k, v in limits.items()
                                      if v)
                + f"; the chunk took {t_c * 1e3:.1f} ms on {card} and "
                f"{t_h:.2f} s on the host CPU")
            if any(v is not None and err[k] > v for k, v in limits.items()):
                fail(f"card against CPU: the {name} training chunk disagrees")
            out = err
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    return out


def pit_phase(engine, net, incumbent, candidate, dev, card):
    """The pit at its defaults (128 games, 800 sims, wave 16, K=128, a
    1,602-node pool, tree reuse) cut to `max_plies` = PIT_PLIES: the first
    Net6 learner step's candidate against the trained Net6.  Checks the
    launch counts of #1-#4 against the config, that every game is
    counted and that reuse carried visits.  Returns (launches, numbers,
    the trees (with their ply and weights, and the search) that the first
    half-batch's searches started from, from the second searched ply
    on)."""
    from tak_tpu_torch import pit as pit_mod
    from tak_tpu_torch.kernels import build as kb
    from tak_tpu_torch.mcts.search import MCTS

    cfg = pit_mod.PitConfig(max_plies=PIT_PLIES)
    opening = 2 + cfg.random_plies
    search_s, captured = [], {}

    class Timed(MCTS):
        def run_sims(self, params, tree):
            if len(search_s) % 2 == 0 and len(search_s) > 0:
                # the first half-batch's tree from the second searched ply
                # on, as reuse carried it in
                captured.setdefault("trees", []).append(
                    (opening + len(search_s) // 2, params, tree.clone()))
                captured["mcts"] = self
            sync()
            t = time.perf_counter()
            out = super().run_sims(params, tree)
            sync()
            search_s.append(time.perf_counter() - t)
            return out

    stats = {}
    pit_mod.MCTS = Timed
    try:
        kb.reset_launches()
        sync()
        t0 = time.perf_counter()
        result = pit_mod.pit(engine, net.policy_eval_states, candidate,
                             incumbent, cfg, seed=SEED,
                             log=lambda m: log(f"  {m}"), stats=stats,
                             device=dev)
        sync()
        wall = time.perf_counter() - t0
        launches = dict(kb.LAUNCHES)
    finally:
        pit_mod.MCTS = MCTS
    S = len(search_s)
    plies = S // 2
    waves = cfg.search.num_waves
    want = {"descend_wave": S, "backup_descend_wave": S * (waves - 1),
            "expand_backup_wave": S,
            # leaf steps, one step a ply, the batched opening steps and
            # the openings' own games (`Game.play_action`)
            "fused_step": S * waves + plies + opening
            + cfg.games // 2 * opening}
    log(f"launches in the pit: {launches} ({S} half-batch searches of "
        f"{waves} waves)")
    if launches != want:
        fail(f"pit launches {launches}, expected {want}")
    if plies != PIT_PLIES - opening:
        fail(f"the pit played {plies} plies")
    total = result.wins + result.losses + result.draws + result.unfinished
    if total != cfg.games or stats["carried_n0"] <= 0:
        fail(f"pit result {result} or carried visits {stats} malformed")
    out = {"plies_per_s": plies / wall,
           "game_plies_per_s": plies * cfg.games / wall,
           "ms_per_search": 1e3 * sum(search_s) / S, "wall_s": wall}
    log(f"pit (Net6 candidate vs trained Net6, {cfg.games} games, "
        f"{cfg.search.num_sims} sims, wave {cfg.search.wave_size}, K "
        f"{cfg.search.max_children}, {captured['mcts'].config.max_nodes}-node "
        f"pool, tree reuse; cut: max_plies {PIT_PLIES}): {result}, "
        f"carried_n0 {stats['carried_n0']}; {plies} plies in {wall:.2f} s: "
        f"{out['plies_per_s']:.2f} lockstep plies/s ({out['game_plies_per_s']:,.0f} "
        f"game plies/s), {out['ms_per_search']:.1f} ms per half-batch search "
        f"({cfg.games // 2} games x {cfg.search.num_sims} sims) on {card}")
    return launches, out, captured


def pit_kernels_phase(captured, card):
    """The pool-tier kernels at the pit's shape (64 games, K=128, M=1,602,
    V=16, no recycling), bitwise against their plain versions: on the tree
    that each first half-batch search started from (carried by reuse),
    grown by 1, 4, 10 or 25 pipelined waves of that search in turn, #2 and
    #3 on the pending wave and #4; then on the tree of ply PIT_CHECK_PLY
    grown by PIT_CHECK_WAVES waves, timed (`launch_ms` over fresh copies
    of the tree) with their bound and chain floor.  Returns ({kernel: (ms,
    plain ms, bound ms, bound by)}, {kernel: floor ms})."""
    from tak_tpu_torch.mcts.tree_kernels import (
        Pending,
        backup_descend_plain,
        backup_descend_wave,
        descend_wave,
        expand_backup_plain,
        expand_backup_wave,
    )

    mcts = captured["mcts"]
    scfg = mcts.config
    V = scfg.wave_size
    kargs = dict(base=scfg.exploration_base, init=scfg.exploration_init,
                 recycle=False)

    def grow(params, tree, waves):
        B, _, K = tree.edge_n.shape
        pending = Pending.zeros(B, V, K, tree.n0.device)
        for _ in range(waves):
            pending = mcts._wave_pipelined(params, tree, pending)
        sync()
        return pending

    def held(tree, pending):
        """#2, #4 and #3 on copies of `tree`, each against its plain
        version.  Returns ({kernel: (tree after, descends, backs up,
        leaves)}, {kernel: (kernel run, plain run, descends, backs up)},
        the empty pending wave)."""
        B, _, K = tree.edge_n.shape
        zero = Pending.zeros(B, V, K, tree.n0.device)
        runs = {
            "backup_descend_wave": (
                lambda t: backup_descend_wave(t, pending, **kargs),
                lambda t: backup_descend_plain(t, pending, **kargs), True,
                True),
            "descend_wave": (
                lambda t: descend_wave(t, V, **kargs),
                lambda t: backup_descend_plain(t, zero, **kargs), True, False),
            "expand_backup_wave": (
                lambda t: expand_backup_wave(t, pending, recycle=False),
                lambda t: expand_backup_plain(t, pending, recycle=False),
                False, True),
        }
        checks = {}
        for name, (run_k, run_p, descend, backup) in runs.items():
            tk, tp = tree.clone(), tree.clone()
            out_k, out_p = run_k(tk), run_p(tp)
            sync()
            compare_trees(tk, tp, f"{name} at the pit's shape")
            if out_k is not None and not all(bool((x == y).all())
                                             for x, y in zip(out_k, out_p)):
                fail(f"{name} at the pit's shape: leaves/created differ")
            checks[name] = (tk, descend, backup, out_k[0] if out_k else None)
        return checks, runs, zero

    seen = []
    for i, (ply, params, tree) in enumerate(captured["trees"]):
        waves = (1, 4, 10, 25)[i % 4]
        carried = int(tree.n0.sum())
        tree = tree.clone()
        held(tree, grow(params, tree, waves))
        seen.append(f"ply {ply}: {carried} visits carried, {waves} waves")
    log("check pool tier at the pit's shape: #2 backup_descend_wave, #4 "
        "descend_wave and #3 expand_backup_wave bitwise equal to the plain "
        "versions on the first half-batch's tree of every searched ply but "
        "the first (" + "; ".join(seen) + ")")

    _, params, tree = next(x for x in captured["trees"]
                           if x[0] == PIT_CHECK_PLY)
    tree = tree.clone()
    B, M, K = tree.edge_n.shape
    A = tree.root_n.shape[1]
    carried = int(tree.n0.sum())
    pending = grow(params, tree, PIT_CHECK_WAVES)
    checks, runs, zero = held(tree, pending)
    times = {}
    for name, (run_k, run_p, descend, backup) in runs.items():
        copies = iter([tree.clone() for _ in range(20)])
        if name == "descend_wave":   # its empty pending wave made beforehand
            t_kernel = launch_ms(lambda: backup_descend_wave(
                next(copies), zero, **kargs))
        else:
            t_kernel = launch_ms(lambda: run_k(next(copies)))
        del copies
        t_plain = cuda_ms(run_p, 1, lambda: tree.clone())
        times[name] = (t_kernel, t_plain, *bound(
            tree_bytes(tree, checks[name][0], V, descend, backup),
            tree_ops(B, V, A, M, descend, recycle=False)))
    floors, chase = pool_chain_floors(tree, pending, checks, V)
    log(f"time pool tier at the pit's shape on {card} (B={B} K={K} M={M} "
        f"V={V}, A={A}, recycling off; the tree of ply {PIT_CHECK_PLY}'s "
        f"first half-batch search, {carried} root visits carried by reuse, "
        f"then {PIT_CHECK_WAVES} pipelined waves): "
        + "; ".join(f"{n} {v[0]:.4f} ms (plain {v[1]:.3f} ms, bound "
                    f"{v[2]:.6f} ms by {v[3]}, chain floor {floors[n]:.4f} "
                    "ms)" for n, v in times.items())
        + f"; {chase}")
    return times, floors


def train_cli_phase(here, card):
    """The generation loop through its command line, as subprocesses, in
    a temporary workdir: two generations from the trained Net6, then
    `--resume` to a third.  Full width (16 x 128); cut: 4 self-play games
    of 256 rollouts, 4 pit games of 64 rollouts, chunks of 50 and 4 chunks
    a step.  Checks the artifacts, that the resumed run starts at
    generation 3, and that the port's `load_run` reads the checkpoint."""
    import torch

    from tak_tpu_torch.model.resnet import NetConfig
    from tak_tpu_torch.utils.checkpoint import load_run

    with tempfile.TemporaryDirectory() as tmp:
        cmd = ["-m", "tak_tpu_torch.cli.train", NET6_WEIGHTS, "--size", "6",
               "--games", "4", "--workers", "4", "--rollouts", "256",
               "--wave", "32", "--pit-games", "4", "--pit-rollouts", "64",
               "--chunk-size", "50", "--chunks-in-step", "4", "--workdir",
               tmp]
        t0 = time.perf_counter()
        first = run_entry(cmd + ["--generations", "2"], here, timeout=600)
        t1 = time.perf_counter()
        second = run_entry(cmd + ["--resume", "--generations", "3"], here,
                           timeout=600)
        t2 = time.perf_counter()
        ckpt = os.path.join(tmp, "_checkpoint")
        for name in ("variables.msgpack", "meta.json", "buffer.data"):
            if not os.path.exists(os.path.join(ckpt, name)):
                fail(f"train CLI: _checkpoint/{name} missing")
        gens = [l.split("]")[0] + "]" for l in second.splitlines()
                if l.startswith("[gen ")]
        if "at generation 2" not in second or not gens \
                or set(gens) != {"[gen 3]"}:
            fail(f"train CLI: the resumed run did not start at generation "
                 f"3:\n{second[-3000:]}")
        for out, last in ((first, 2), (second, 3)):
            if f"[gen {last}] pitting candidate vs incumbent" not in out:
                fail(f"train CLI: generation {last} did not train and "
                     f"gate:\n{out[-3000:]}")
        data = os.listdir(os.path.join(tmp, "_examples"))
        accepted = (first + second).count("accepted; saved")
        models = os.listdir(os.path.join(tmp, "_models"))
        if len(data) != 3 or len(models) != accepted:
            fail(f"train CLI: {len(data)} example files, {len(models)} "
                 f"models for {accepted} accepted candidates")
        variables, meta = load_run(ckpt, config=NetConfig.for_size(6))
        with open(os.path.join(ckpt, "buffer.data")) as f:
            lines = sum(1 for line in f if line.strip())
        if meta.get("generation") != 3 or meta.get("buffer_len") != lines \
                or not all(bool(torch.isfinite(v.float()).all())
                           for v in variables.values()):
            fail(f"train CLI: checkpoint meta {meta} ({lines} buffered "
                 "lines) or weights malformed")
    gates = [l for l in (first + second).splitlines()
             if "win_rate=" in l or "accepted;" in l or "rejected" in l]
    log(f"entry point cli.train (Net6 16 x 128; cut: 4 self-play games x "
        f"256 rollouts, 4 pit games x 64 rollouts, chunks of 50, 4 a step): "
        f"2 generations in {t1 - t0:.1f} s, --resume to generation 3 in "
        f"{t2 - t1:.1f} s (process start included); {'; '.join(gates)}; "
        f"checkpoint read back at generation 3 with {lines} examples, on "
        f"{card}")
    return t2 - t0


def profile_learner_step(net, variables, examples, card):
    """Where one Net6 optimizer step (20 chunks of 500 x 8 rows) spends its
    time: synchronized host timers around its stages; one BatchNorm's
    forward and backward at a chunk's shape (CUDA events) times the step's
    BatchNorms; then torch.profiler's device time by kernel family and the
    device's idle share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tak_tpu_torch.model.network import CHUNK_SIZE, CHUNKS_IN_STEP
    from tak_tpu_torch.model.resnet import BatchNorm

    model = net._train_model(variables)
    opt = net.make_optimizer(model.parameters())
    pre = net._prestack(examples[:CHUNK_SIZE * CHUNKS_IN_STEP])
    idx = [np.arange(i * CHUNK_SIZE, (i + 1) * CHUNK_SIZE)
           for i in range(CHUNKS_IN_STEP)]
    stages = collections.defaultdict(float)

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        sync()
        stages[name] += time.perf_counter() - t
        return out

    def step():
        for i in idx:
            states, acts, vis, z = timed(
                "host chunk assembly + copy to the card", net._chunk_arrays,
                pre, i)
            planes, pi, z = timed(
                "observe + targets + symmetry",
                lambda: net._symmetry_expand(net.observe_batch(states),
                                             net._build_pi(acts, vis), z))
            loss, _, _ = timed("forward + loss", net._loss, model, planes,
                               pi, z)
            timed("backward", loss.backward)
        timed("Adam step", lambda: (opt.step(), opt.zero_grad()))

    step()
    stages.clear()
    sync()
    t0 = time.perf_counter()
    step()
    wall = time.perf_counter() - t0
    log_stages(stages, wall, "one Net6 optimizer step", card)

    bn = BatchNorm(net.config.filters).to(net.device).train()
    n = net.config.n
    x = torch.randn((CHUNK_SIZE * 8, net.config.filters, n, n),
                    device=net.device, dtype=net.config.dtype)
    xl = x.to(memory_format=torch.channels_last).requires_grad_()
    ms = cuda_ms(lambda _: bn(xl).float().sum().backward(), 5)
    ms_nchw = cuda_ms(lambda _: bn(x.requires_grad_()).float().sum()
                      .backward(), 5)
    count = 1 + 2 * net.config.blocks
    log(f"profile BatchNorm (CUDA events): one forward + backward at "
        f"{tuple(x.shape)} {net.config.dtype}, channels-last as in training, "
        f"{ms:.3f} ms (contiguous NCHW {ms_nchw:.3f} ms); x {count} "
        f"BatchNorms x {len(idx)} chunks = {ms * count * len(idx):.1f} ms of "
        f"the step's {wall * 1e3:.1f} ms; its least time from bytes (bf16: "
        f"forward reads x and writes y, backward reads dy and x and writes "
        f"dx) {5 * x.numel() * 2 / HBM_BYTES_PER_S * 1e3:.3f} ms, on {card}")

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    def family(name):
        """A device kernel's family, from cuDNN's and PyTorch's names."""
        if "fprop" in name:
            return "convolutions, forward"
        if "dgrad" in name or "wgrad" in name:
            return "convolutions, backward (data and weight gradients)"
        if any(w in name for w in ("conv", "xmma", "cudnn", "gemm",
                                   "cutlass", "implicit", "winograd")):
            return "other convolution and matrix-product kernels"
        if "multi_tensor" in name:
            return "Adam (multi-tensor)"
        return "other kernels (BatchNorm, loss, observe, symmetry, copies)"

    families = collections.defaultdict(float)
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            families[family(e.key.lower())] += dev_us(e) / 1e3
    busy = sum(families.values())
    log(f"profile device (torch.profiler, one Net6 optimizer step): wall "
        f"{wall * 1e3:.1f} ms, device busy {busy:.1f} ms, idle "
        f"{100 - 100 * busy / (wall * 1e3):.1f}% on {card}")
    for fam, ms_f in sorted(families.items(), key=lambda kv: -kv[1]):
        log(f"  {ms_f:9.2f} ms  {fam}")
    top = sorted((e for e in prof.key_averages()
                  if str(getattr(e, "device_type", "")).endswith("CUDA")),
                 key=lambda e: -dev_us(e))[:12]
    for e in top:
        log(f"  {dev_us(e) / 1e3:9.2f} ms  x{e.count:<6d} "
            f"[{family(e.key.lower()).split(' (')[0]}] {e.key[:80]}")


def make_actor(engine, eval_fn, dev, moves, **search_options):
    from tak_tpu_torch.mcts.search import SearchConfig
    from tak_tpu_torch.selfplay import SelfPlayActor, SelfPlayConfig

    cfg = SelfPlayConfig(
        games=GAMES, workers=GAMES, max_plies=2 + moves,
        search=SearchConfig(num_sims=SIMS, wave_size=WAVE, max_children=K,
                            recycle=True, **search_options))
    return SelfPlayActor(engine, eval_fn, cfg, device=dev)


def main(do_profile: bool = False):
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    here = Path(__file__).resolve().parent
    if not (here / "tak_tpu_torch" / "csrc").is_dir():
        fail("the tak_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, str(here))

    import numpy as np

    card = card_line()
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.benchmark = True
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    from tak_tpu_torch.engine.core import get_engine
    from tak_tpu_torch.engine.fused_env import fused_step, step_plain
    from tak_tpu_torch.engine.legal_bits import step_legal, step_legal_plain
    from tak_tpu_torch.kernels import build as kb
    from tak_tpu_torch.mcts.search import MCTS, SearchConfig
    from tak_tpu_torch.mcts.tree_kernels import (
        Pending,
        backup_descend_plain,
        backup_descend_wave,
        descend_wave,
        expand_backup_plain,
        expand_backup_wave,
    )
    from tak_tpu_torch.model.network import Network
    from tak_tpu_torch.model.resnet import NetConfig

    # ---- 2. build --------------------------------------------------------
    t_build = kb.build(verbose=True)
    log(f"build: {t_build:.1f} s for {', '.join(kb.SOURCES)}")
    for name, text in kb.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {name}: {line.strip()}")
    for name in kb.SOURCES:
        kb.library(name)

    engine = get_engine(N)
    rng = np.random.default_rng(SEED)

    # ---- 3a. fused step against its plain version -------------------------
    # one wave's leaves: 8,192 varied rows, some finished, some disabled
    t0 = time.perf_counter()
    states, roots = selfplay_rows(engine, rng, dev)
    acts = random_legal(engine, states, rng)
    enabled = torch.as_tensor(rng.random(ROWS) < 0.9, device=dev)
    got = fused_step(engine, states, acts, enabled)
    want = step_plain(engine, states, acts, enabled)
    sync()
    compare_states(got, want, "fused_step")
    stepped = int(((got.ply != states.ply)).sum())
    log(f"check fused_step: {ROWS} rows bitwise equal "
        f"({stepped} stepped, {ROWS - stepped} frozen) "
        f"in {time.perf_counter() - t0:.1f} s")
    # the fused step with legal bits: the same rows, then other sizes (5x5:
    # wp = 1; 8x8: wp = 8, four stack words, bit 63 of the road bitboard)
    check_step_legal(engine, states, acts, enabled,
                     f"{N}x{N}, one self-play wave's rows")
    for size in (5, 8):
        other = get_engine(size)
        ost = playout_states(other, 1024, 60, rng, dev)
        check_step_legal(
            other, ost, random_legal(other, ost, rng),
            torch.as_tensor(rng.random(1024) < 0.9, device=dev),
            f"{size}x{size} playout rows")
        del ost

    # the per-move instant-win scan: every (game, action) probe row of 32
    # mid-game roots, illegal pairs on the freeze path
    wst, wacts, wen = win_scan_rows(engine, roots)
    wins_rows = wacts.shape[0]
    got = fused_step(engine, wst, wacts, wen)
    want = step_plain(engine, wst, wacts, wen)
    sync()
    compare_states(got, want, "fused_step (win scan)")
    stepped = int(((got.ply != wst.ply)).sum())
    log(f"check fused_step at the win-scan shape: {wins_rows} rows bitwise "
        f"equal ({stepped} legal probes stepped, {wins_rows - stepped} "
        "frozen)")
    del got, want
    # the fused step and the env rollout at every size 3-8
    check_env_sizes(dev, rng, card)

    # ---- 3b. tree waves against their plain versions -----------------------
    t0 = time.perf_counter()
    net = Network(engine, NetConfig.for_size(N), device=dev)
    params = net.init_variables(SEED)

    def eval_fn(p, s):
        return net.policy_eval_states(p, s)

    mcts, tree, pending = midsearch_tree(engine, eval_fn, params, roots)
    scfg = mcts.config
    M = scfg.max_nodes
    kargs = dict(base=scfg.exploration_base, init=scfg.exploration_init,
                 recycle=True)

    checks = {}
    # merged backup + descend (valid=1)
    tk, tp = tree.clone(), tree.clone()
    lk, ck = backup_descend_wave(tk, pending, **kargs)
    lp, cp = backup_descend_plain(tp, pending, **kargs)
    sync()
    compare_trees(tk, tp, "backup_descend_wave")
    if not (bool((lk == lp).all()) and bool((ck == cp).all())):
        fail("backup_descend_wave: leaves/created differ")
    recycled = int(((tk.parent != tree.parent)
                    | (tk.parent_action != tree.parent_action)).sum())
    if recycled == 0:
        fail("backup_descend_wave: no node was recycled")
    checks["backup_descend_wave"] = (tk, True, True, lk)
    log(f"check backup_descend_wave: bitwise equal, {recycled} slots "
        f"recycled, {int(ck.sum())} nodes created")

    # descend (the merged kernel with valid=0)
    tk, tp = tree.clone(), tree.clone()
    zero = Pending.zeros(GAMES, WAVE, K, dev)
    lk, ck = descend_wave(tk, WAVE, **kargs)
    lp, cp = backup_descend_plain(tp, zero, **kargs)
    sync()
    compare_trees(tk, tp, "descend_wave")
    if not (bool((lk == lp).all()) and bool((ck == cp).all())):
        fail("descend_wave: leaves/created differ")
    checks["descend_wave"] = (tk, True, False, lk)
    log("check descend_wave: bitwise equal")

    # expand + backup flush
    tk, tp = tree.clone(), tree.clone()
    expand_backup_wave(tk, pending, recycle=True)
    expand_backup_plain(tp, pending, recycle=True)
    sync()
    compare_trees(tk, tp, "expand_backup_wave")
    checks["expand_backup_wave"] = (tk, False, True, None)
    log(f"check expand_backup_wave: bitwise equal "
        f"(tree checks {time.perf_counter() - t0:.1f} s)")
    pool_floors, pool_chase = pool_chain_floors(tree, pending, checks)
    check_pool_cases(engine, dev, card)

    # ---- 3c. large-tier waves against their plain versions -------------------
    p_cfg = SearchConfig(num_sims=P_WAVE, wave_size=P_WAVE,
                         max_children=P_K, node_budget=P_POOL)
    one_root = roots[:1].map(lambda x: x.contiguous())
    hbm_check = check_hbm_kernels(
        MCTS(engine, eval_fn, p_cfg), params, one_root, 60,
        "the Player's shape: one game, Net6", card)
    peaked = peaked_eval(engine.num_actions)
    hbm_times_8 = check_hbm_kernels(
        MCTS(engine, peaked, p_cfg), None,
        roots[:8].map(lambda x: x.contiguous()), 30,
        "8 games, peaked priors", card)
    small_cfg = SearchConfig(num_sims=P_WAVE, wave_size=P_WAVE,
                             max_children=P_K, node_budget=150)
    check_hbm_kernels(MCTS(engine, peaked, small_cfg), None,
                      roots[:2].map(lambda x: x.contiguous()), 3,
                      "a 150-node pool that runs out inside the wave", card,
                      pool_runs_out=True)
    check_hbm_cases(engine, dev, card)

    # ---- 3d. the legal sampler and the env rollout --------------------------
    rollout_times = check_rollout_kernels(engine, states, rng, card)

    # ---- 4. the self-play slice ------------------------------------------------
    launches, move_lines, rate, tree_off = selfplay_phase(
        engine, eval_fn, params, dev, card, "self-play slice", MOVES)
    moves = MOVES
    for name in POOL_TIER + ("fused_step",):
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the self-play path")
    for name in HBM_TIER + ("fused_step_legal", "legal_sampler",
                            "env_rollout"):
        if launches.get(name, 0) != 0:
            fail(f"kernel {name} launched on the self-play path")

    # ---- 5. the Player slice, 6. the entry points --------------------------
    p_launches, p_lines, p_rate, player, searched = player_phase(
        engine, eval_fn, params, dev, card)
    # the kernels of the Player path again, at the shapes that path gave
    # them: move 1's searched tree (a 64-leaf wave) and a one-row step
    player_times = check_hbm_on_tree(
        player.mcts, params, searched,
        "the Player's own tree after move 1's search", card)
    one_row = check_single_step(engine, searched, card)
    del searched
    wide_times = wide_wave_phase(engine, eval_fn, params, dev, card)
    entry_points_phase(here, card)

    # ---- 6a. the self-play slice with fused_leaf_legal, then packedq --------
    f_launches, f_lines, f_rate, tree_on = selfplay_phase(
        engine, eval_fn, params, dev, card,
        "self-play with fused_leaf_legal", FUSED_MOVES, fused_leaf_legal=True)
    if f_launches.get("fused_step_legal", 0) <= 0:
        fail("fused_step_legal was not launched with fused_leaf_legal=True")
    for name in POOL_TIER + ("fused_step",):   # the win scan still steps
        if f_launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched with fused_leaf_legal=True")
    compare_trees(tree_on, tree_off, "move 1's tree with fused_leaf_legal on "
                  "against the option off")
    log(f"check fused_leaf_legal: move 1's searched tree ({GAMES} games, "
        f"{SIMS} sims each, root noise from the same seed) is bitwise the "
        "tree of the option off, node states included")
    del tree_on, tree_off
    _, q_lines, q_rate, _ = selfplay_phase(
        engine, eval_fn, params, dev, card, 'self-play with topk_impl="packedq"',
        1, topk_impl="packedq")
    options_line = (
        f"self-play sims/s: {rate:,.0f} (exact top-K, dense legal mask; moves "
        f"2-{MOVES}), {f_rate:,.0f} with fused_leaf_legal (move "
        f"2 of {FUSED_MOVES}; {'; '.join(f_lines)}), {q_rate:,.0f} with "
        f'topk_impl="packedq" (one move: {q_lines[0]})')
    log(f"{options_line} on {card}")

    # ---- 6b. the env rollout path ---------------------------------------------
    r_launches, r_line, _ = env_rollout_phase(engine, dev, card)
    for name in ("env_rollout", "legal_sampler"):
        if r_launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the env rollout path")

    # ---- 6c-6h. the training slice ------------------------------------------
    l5, _, vars5, buf5 = learner_net5_phase(dev, card)
    agree = card_vs_cpu_phase(dev, card, vars5, buf5.examples)
    del vars5, buf5
    l6, net6, vars6, cand6, ex6 = learner_net6_phase(dev, card, rng)
    pit_launches, pit_out, captured = pit_phase(engine, net6, vars6, cand6,
                                                dev, card)
    pit_times, pit_floors = pit_kernels_phase(captured, card)
    t_cli = train_cli_phase(here, card)
    train_line = (
        f"learner Net5 {l5['examples_per_s']:,.0f} examples/s "
        f"({l5['ms_per_chunk']:.2f} ms per chunk); learner Net6 "
        f"{l6['examples_per_s']:,.0f} examples/s ({l6['ms_per_step']:.1f} ms "
        f"per step, {100 * l6['bf16_share']:.1f}% of the bf16 peak); card "
        f"against CPU in float32: loss {agree['loss']:.1e}, gradients "
        f"{agree['grads']:.1e} (L2), statistics {agree['stats']:.1e}; pit "
        f"{pit_out['plies_per_s']:.2f} plies/s ({pit_out['ms_per_search']:.1f} "
        f"ms per half-batch search); cli.train 3 generations in "
        f"{t_cli:.1f} s")

    # each path was driven from counts of 0 (the packedq move is no path
    # of its own: it launches what the self-play slice launches)
    by_path = {name: dict(zip(PATHS, (c.get(name, 0) for c in (
        launches, p_launches, f_launches, r_launches, pit_launches))))
        for name in REPLACES}

    # ---- 7. timing ---------------------------------------------------------
    rows = []
    st = states.clone()
    t_kernel = launch_ms(lambda: fused_step(engine, st, acts, enabled))
    t_plain = cuda_ms(lambda _: step_plain(engine, st, acts, enabled), 3)
    t_bound, by = bound(*fused_step_work(st, ROWS))
    rows.append(("fused_step", t_kernel, t_plain, t_bound, by))

    t_kernel = launch_ms(lambda: step_legal(engine, st, acts, enabled))
    t_plain = cuda_ms(lambda _: step_legal_plain(engine, st, acts, enabled), 3)
    t_bound, by = bound(*step_legal_work(engine, st, ROWS))
    rows.append(("fused_step_legal", t_kernel, t_plain, t_bound, by))
    for name in ("legal_sampler", "env_rollout"):
        rows.append((name, *rollout_times[name]))

    t_wins = cuda_ms(lambda _: fused_step(engine, wst, wacts, wen), 5)
    t_wins_plain = cuda_ms(lambda _: step_plain(engine, wst, wacts, wen), 2)
    wins_bound, wins_by = bound(*fused_step_work(wst, wins_rows))
    wins_line = (f"fused_step at the win-scan shape ({wins_rows} rows): "
                 f"kernel {t_wins:.4f} ms, plain {t_wins_plain:.3f} ms, "
                 f"bound {wins_bound:.5f} ms ({wins_by})")
    log(f"time {wins_line} on {card}")
    floor = launch_floor_ms(dev)
    log(f"time fused_step at small shapes: the Player's {P_WAVE} leaf rows "
        f"{player_times['fused_step'][0]:.4f} ms, one row {one_row[0]:.4f} "
        f"ms, against a launch floor of {floor:.4f} ms (zero_() on 64 "
        f"int32) on {card}")

    for name, (after, descend, backup, _) in checks.items():
        def setup():
            return tree.clone()

        if name == "backup_descend_wave":
            run_k = lambda t: backup_descend_wave(t, pending, **kargs)
            run_p = lambda t: backup_descend_plain(t, pending, **kargs)
        elif name == "descend_wave":
            # the wrapper of `descend_wave` with its empty pending wave made
            # beforehand: an allocation inside the span could wait
            run_k = lambda t: backup_descend_wave(t, zero, **kargs)
            run_p = lambda t: backup_descend_plain(t, zero, **kargs)
        else:
            run_k = lambda t: expand_backup_wave(t, pending, recycle=True)
            run_p = lambda t: expand_backup_plain(t, pending, recycle=True)
        t_kernel = cuda_ms(run_k, 5, setup)
        t_plain = cuda_ms(run_p, 1, setup)
        nbytes = tree_bytes(tree, after, WAVE, descend, backup)
        ops = tree_ops(GAMES, WAVE, engine.num_actions, M, descend)
        t_bound, by = bound(nbytes, ops)
        rows.append((name, t_kernel, t_plain, t_bound, by))
    log(f"time pool tier on {card}: chain floors "
        + ", ".join(f"{n} {v:.4f} ms" for n, v in pool_floors.items())
        + f"; {pool_chase}")

    for name in HBM_TIER:
        rows.append((name, *player_times[name]))
    for what, times in (("the Player's own tree", player_times),
                        ("one game, check tree", hbm_check),
                        ("8 games", hbm_times_8),
                        (f"the Player's tree at wave {P_WIDE}", wide_times)):
        log(f"comparison at K={P_K} M={P_POOL}, {what}, on {card}: "
            f"descend_wave_hbm {times['descend_wave_hbm'][0]:.4f} ms vs the "
            f"pool-tier descend_wave {times['descend_wave'][0]:.4f} ms; "
            f"expand_backup_wave_hbm "
            f"{times['expand_backup_wave_hbm'][0]:.4f} ms vs the pool-tier "
            f"expand_backup_wave {times['expand_backup_wave'][0]:.4f} ms "
            "(recycling off, same trees)")

    if do_profile:
        profile_search(mcts, params, roots, card)
        profile_search(
            MCTS(engine, eval_fn,
                 dataclasses.replace(scfg, fused_leaf_legal=True)),
            params, roots, card)
        profile_player(player, card)
        profile_learner_step(net6, vars6, ex6, card)
        _, pit_params, pit_tree = captured["trees"][0]
        profile_search(captured["mcts"], pit_params, pit_tree.state[:, 0],
                       card, "one pit half-batch search (64 games x 800 "
                       "sims, K=128, fresh trees)")
    del captured

    def times(t):
        return dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"), t))

    def hbm_times(measured, name):
        return {**times(measured[name]),
                "chain_floor_ms": measured["chain_floor_ms"][name]}

    # a kernel's times at its other shapes, beside the headline ones: the
    # large-tier waves on the check tree grown by the plain versions, the
    # fused step on the Player path's 64 leaf rows and on one row
    other_shapes = {
        "fused_step": {f"win scan, {wins_rows} rows":
                       times((t_wins, t_wins_plain, wins_bound, wins_by)),
                       f"player wave, {P_WAVE} rows":
                       times(player_times["fused_step"]),
                       "one row": times(one_row),
                       "launch_floor_ms": floor},
        "fused_step_legal": {f"player wave, {P_WAVE} rows":
                             times(player_times["fused_step_legal"])},
        "legal_sampler": {"given words":
                          times(rollout_times["legal_sampler, given words"])},
        **{name: {"check tree": hbm_times(hbm_check, name),
                  f"player wave {P_WIDE}": hbm_times(wide_times, name)}
           for name in HBM_TIER},
        **{name: {"pit, B=64 K=128 M=1602 V=16":
                  {**times(pit_times[name]),
                   "chain_floor_ms": pit_floors[name]}}
           for name in POOL_TIER},
    }
    kernels = []
    for name, t_kernel, t_plain, t_bound, by in rows:
        paths = by_path[name]
        log(f"time {name}: kernel {t_kernel:.4f} ms, plain {t_plain:.3f} ms, "
            f"bound {t_bound:.6f} ms ({by}); launches by path: {paths}, "
            f"on {card}")
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            # each path was driven from counts of 0; a kernel of several
            # paths reports their sum, and the split beside it
            "launches": sum(paths.values()),
            "launches_by_path": paths,
            # every kernel was held bitwise against its plain version above
            # (any differing entry fails the run), so the error is 0
            "max_abs_err": 0.0,
            "ms": t_kernel, "plain_ms": t_plain, "bound_ms": t_bound,
            "bound_by": by, "library_ms": None,
        }
        # the tree waves are sequential by definition: the pointer chase
        # along the wave's own paths, beside the throughput bound
        if name in HBM_TIER:
            entry["chain_floor_ms"] = player_times["chain_floor_ms"][name]
        elif name in POOL_TIER:
            entry["chain_floor_ms"] = pool_floors[name]
        if name in other_shapes:
            entry["other_shapes"] = other_shapes[name]
        kernels.append(entry)
    # the end-to-end numbers again, next to the result lines
    log(f"summary on {card}: build {t_build:.1f} s; "
        + "; ".join(move_lines)
        + f"; moves 2-{moves}: {rate:,.0f} self-play sims/s; {wins_line}; "
        + f"{options_line}; {r_line}; "
        + "; ".join(p_lines)
        + f"; Player: {p_rate:,.0f} rollouts/s over {P_MOVES} moves; "
        + train_line)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


if __name__ == "__main__":
    main(do_profile="--profile" in sys.argv[1:])
