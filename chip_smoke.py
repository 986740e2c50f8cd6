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
         on a tree of about two thousand nodes grown by 30 waves of the
         plain versions, again on 8 trees grown by 20, and on a small pool
         that runs out inside the wave; the pool-tier kernels run on the same trees with
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
     within the tolerances of `card_vs_cpu_phase` (the card's BatchNorms
     on the `tak_bn_*` kernels, float64 ones included; the CPU's on the
     plain Function);
  6e. the learner at the reference step: the trained Net6
     (`runs/train6_r4/_models/1787285471.model`), 20,000 seeded 6x6
     examples, 2 steps of 20 x 500 x 8 = 80,000 rows after a one-chunk
     warm-up: examples/s, ms per step, the share of the bf16 peak; every
     BatchNorm of the 2 steps on the `tak_bn_*` kernels (six launches a
     forward and backward) and none on the plain version; then the
     kernels against the plain Function at a chunk's shape (4,000 x 128 x
     6 x 6, bf16, channels-last; `batch_norm_phase`): y and dx within one
     bf16 step, statistics and parameter gradients within stated float32
     tolerances, and their forward and backward times beside the byte
     floor and the plain version's;
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
  6h. the "xla" search path against the pool-tier kernels at V = 1: the
     32 mid-game roots, K=32, a recycled 48-node pool (full in every
     game), the trained Net6 in bf16, 128 waves of one descent: the two
     trees bitwise equal in every field, node states, `root_w` and
     `edge_w` included; the launches of both from the config;
  6i. self-play on the "xla" path (`backend="xla"`) at the reference
     config for one searched move: the tier, visit conservation and the
     recycling invariants of `tests/test_recycle.py` on every tree, sims/s
     and ms per wave beside the pool tier's sims/s of phase 4;
  6j. Gumbel self-play (gumbel_m=16) at the reference config, 2 searched
     moves: the tier, move 1's root visits equal to the sequential-halving
     schedule's in every game, targets summing to 65535 within rounding,
     legal moves; sims/s;
  6k. quad-rollout self-play (workers=1, quad_rollout_plies=6, the
     reference search config), cut to 8 plies: the #1-#4 launches of
     every search call from the config, 4 calls a move below ply 6, early
     examples carrying 4x the visits of late ones; sims/s;
  6l. the dense Net5 head (5x5, 8 x 128, 1,575 legacy moves, seeded
     weights): the card's float32 forward against the CPU's within
     DENSE_TOL, a pool-tier self-play search of 2 moves with its launch
     counts, one `Network.train` pass over the committed 5x5 buffer;
     examples/s;
  6m. the playtak bot over a scripted server on 127.0.0.1 (a thread of
     this script): the trained Net6, the `Player` at its defaults,
     time_to_think 1 s, the server pausing 0.5 s before each reply so the
     bot ponders; checks the lines received (each move legal), at least
     two ponder ticks, the analysis PTN and the examples file read back,
     #1, #8 and #9 launched; rollouts per think, ms per wave;
  6n. 256 seeded playouts on the native engine (`tak_tpu_torch.native`)
     replayed through the batched step on the card (#1): results, plies,
     reserves and boards equal;
  6o. two ranks on the one card (spawned processes, an explicit gloo group,
     CUDA tensors; NCCL refuses two ranks on one device):
     `graft_entry.dryrun_multichip(2, "cuda")` (the flagship Net6 in
     float32: a `DPLearner` step within 4x a row-permutation control of one
     process's, and a sharded move equal to one process's), then one
     self-play move at the reference config, 16 games a rank, with the
     exact evaluator of `graft_entry.exact_eval`: examples and chosen
     moves bitwise those of one process, each rank's #2-#4 launches from
     the config; then two moves of the trained Net6, the second timed (a
     shared card: not a scaling figure);
  6p. NCCL at world size 1 in a spawned process: one `Network.train` step
     of the trained Net6 on one chunk (500 seeded examples, 4,000 rows)
     and one searched move, each with the mesh and without, bitwise equal
     (cuDNN deterministic);
  6q. `python -m tak_tpu_torch.cli.warmup` at the reference config (Net6,
     the pit at its defaults): every stage named, their times; then
     `utils.profiling.trace` around one self-play move: the Chrome trace
     names `backup_descend_kernel` (#2, #4) and `expand_backup_kernel`
     (#3);
  6r. the root-policy quality probe (`tak_tpu_torch.tools.quality`) at
     `quality_recycle`'s defaults: 8 random 6x6 positions 24 plies deep,
     Net6 on seed-0 weights, 10,000 sims at wave 16 on the recycled
     1,280-node pool (K=32, chunks of 512 sims) and on the large-tree
     tier (K=128, budget 20,002): TV, top-1 agreement and each side's
     seconds; every policy row sums to 1 (within 1e-9) on the legal mask
     and the root's edge visits equal what the root holds; #2-#4 launched
     on the pool side only, #8/#9 on the other; then #2-#4
     (`captured_pool_phase`) and #8/#9 (`check_hbm_on_tree`) bitwise and
     timed on each side's searched tree; `python -m
     tak_tpu_torch.tools.quality_k` at its defaults on the card;
  6s. the strength A/B (`tak_tpu_torch.tools.strength_ab`) on the trained
     Net6: preset `recycle`, 8 games, 800 sims, cut to 16 plies, in
     process: the record's keys, game count and `wilson_ci`, #2-#4 and
     #8/#9 launched; then `--subprocess-rounds` over two child rounds of
     4 games cut to 8 plies: two lines, the printed total their sum;
     the peak RSS of this process before and after, and of the children;
  6t. the port's benchmark program, `python -m tak_tpu_torch.bench` at its
     defaults, as a subprocess: its one line has `bench.py`'s keys, names
     the card, echoes the sizes, every rate positive (the line is printed
     here, never in the last line); then its MCTS tier in process (512
     games x 512 sims, wave 32, K=32, 514 nodes without recycling, Net6 on
     seed-0 weights) with the #1-#4 launches of its 4 searches asserted and
     every root holding 513 visits; then the tier's tree grown by 8 of its
     16 pipelined waves: #2, #4 and #3 bitwise against their plain
     versions and timed beside bound and chain floor, and #1 bitwise and
     timed on that wave's 16,384 leaf rows;
  6u. the profiling harnesses (`tak_tpu_torch.tools.profile_*`,
     `diag_bn_mismatch`) in process from launch counts of 0, each
     `main(argv, env)` (`U_RUNS`): at their defaults profile_kernels,
     profile_wave (also `BENCH_RECYCLE=1`), profile_ab (pairs `topk` and
     `fused-legal`), profile_hbm, profile_micro, the three profile_topk*
     and profile_nn; with smaller knobs profile_selfplay (2,048 sims, 2
     moves), profile_move_phases (one rep) and profile_recycle_grid (one
     grid point at 2,048 sims); then `diag_bn_mismatch.run` (2 games, 64
     sims, pits cut to 24 plies: `U_DIAG`) on a 6x6 checkpoint of the
     trained Net6 and 1,000 seeded examples written by
     `save_training_run`;
     every time and rate on their lines finite and positive, profile_nn's
     matmul towers within 2^-5 of the cuDNN tower's largest policy
     magnitude, the exact top-K strategies equal to `torch.topk`, and
     #1-#5, #8, #9 launched; then #2-#4 and #1 bitwise and timed at
     B=256, V=16, K=64 on 514 nodes after 16 of 32 waves and on a full
     recycled 1,280-node pool, and #8/#9 (with #1, #5 and the pool-tier
     kernels on the same tree) at profile_hbm's B=32, V=8, K=96, M=20,002
     and at profile_selfplay's default tree (V=16, K=128);
  6v. the SE net at 8x8 (`lc0se-20x256-8x8`: 20 x 256, 32 SE channels,
     seeded random weights): `tak_se_epilogue` against its plain version
     (within one bf16 step, at most 0.1% of outputs off) at a wave's 8,192
     rows and at odd shapes, timed beside its byte floor; one searched
     32-game move at the reference search through `SelfPlayActor.run` on
     the pool tier, the epilogue launched once a block a call; #2, #4, #3
     and #1 bitwise at 8x8 (A=65,216) on a full recycled pool;
  6w. with four cards, four NCCL ranks of `Network.train` on the trained
     Net6 (two steps of 4 chunks of 500): every rank's variables bitwise
     equal, each leaf's change within the benchmark learner's limits of
     one process's (skipped, and said so, on fewer cards);
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
     holds its times elsewhere (#2-#4 at the pit's, quad, dense Net5,
     quality-probe, bench MCTS-tier and the harnesses' shapes, #1 at the
     bench tier's wave and the harnesses' leaf rows, #8/#9 at the quality
     probe's and the harnesses' too), `launches_by_path` the count of
     each path (the pit's, the quality probe's, the A/B's, the bench MCTS
     tier's and the harnesses' included).  The tenth entry, `batch_norm`
     (`csrc/batch_norm.cu`), replaces no TPU kernel (`replaces` null):
     one forward and backward at a Net6 chunk's shape (`other_shapes`
     splits them), its launches those of 6e's two steps.  The eleventh,
     `squeeze_excite` (`csrc/squeeze_excite.cu`), replaces none either:
     6v's wave, and the pool-tier kernels at 8x8 under `other_shapes`.

`--se8` runs the build, 6v and 6w only, and prints the eleventh entry
and a `{"se8_ok": true, ...}` line: a pass of those phases alone, never
the whole smoke's `ok`.

`--profile` adds, before the last two lines, where one self-play move's
search (with `fused_leaf_legal` off and on), 200 Player waves, one Net6
optimizer step (also one BatchNorm alone, device time by kernel family),
one pit half-batch search and one bench MCTS-tier search spend their
time: the program's spans under `utils.profiling.trace` (calls, host
self ms and device ms by `tak.` range, no synchronisation added), then
torch.profiler's device time by kernel.

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
BN_ROWS = 4_000                # a learner chunk: 500 examples x 8 symmetries
BN_CHANNELS = 128              # Net6's filters
PIT_PLIES = 16                 # the pit's max_plies: its only cut
PIT_CHECK_PLY = 8              # the pit tree that the kernel checks start from
PIT_CHECK_WAVES = 10           # pipelined waves grown on it before the checks

# the ninth slice's paths
X1_SIMS = 128                  # waves of one descent in the V=1 check
X1_POOL = 48                   # its recycled pool: full within the search
GUMBEL_MOVES = 2               # gumbel self-play: searched moves
QUAD_PLIES = 8                 # quad-rollout self-play: max_plies
DENSE_MOVES = 2                # dense Net5 self-play: searched moves
DENSE_TOL = 1e-4               # dense Net5 float32 forward, card vs CPU
BOT_THINK_S = 1.0              # the bot's time_to_think
BOT_REPLY_S = 0.5              # the scripted server's pause before a reply
BOT_PLIES = 7                  # the scripted game ends after the bot's ply 6
NATIVE_GAMES = 256             # native playouts replayed on the card
NATIVE_MAX_PLIES = 300

# the eleventh slice: the quality probe at `tools.quality_recycle`'s
# defaults, the strength A/B cut to a few plies
Q_SIMS = 10_000
Q_WAVE = 16
Q_GAMES = 8
Q_PLIES = 24
Q_POOL = 1280
Q_K = 32
Q_CHUNK = 512
Q_REF_K = 128
AB_GAMES = 8                   # in-process round: games
AB_SIMS = 800
AB_PLIES = 16                  # its max_plies: the opening's 4 + 12 searched
AB_SUB_GAMES = 4               # each of the two child rounds
AB_SUB_PLIES = 8

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
PATHS = ("selfplay", "player", "fused_leaf_legal", "env_rollout", "pit",
         "xla_v1", "xla", "gumbel", "quad", "dense_net5", "bot",
         "native_replay", "sharded_rank0", "nccl_world1", "quality",
         "strength_ab", "bench_mcts", "profiling_tools")
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
    """Mean device milliseconds of fn(setup()) over `reps` runs, each timed
    alone by the harnesses' `tools.timing.span` (`setup` outside the span;
    CUDA events behind a spin of `spin` cycles, about half a millisecond,
    so that the host has queued the launch before the card reaches it: the
    span holds the kernel and not the host's way to the launch)."""
    import torch

    from tak_tpu_torch.tools.timing import span

    dev = torch.device("cuda", torch.cuda.current_device())
    wrap = (lambda: (setup(),)) if setup is not None else None
    return sum(span(fn, dev, wrap, (None,), spin)[1]
               for _ in range(reps)) * 1e3 / reps


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


def device_events(prof) -> list:
    """The device-side entries of `prof.key_averages()` (kernels, copies;
    an operator's own entry repeats the time of the kernels it launched),
    without the program's `tak.` ranges, which the profiler mirrors on the
    device's timeline as annotations spanning their kernels."""
    return [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("tak.")]


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

    events = device_events(prof)
    busy = sum(dev_us(e) for e in events) / 1e3
    log(f"profile device (torch.profiler, {what}): wall "
        f"{wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / (wall * 1e3):.1f}%), idle "
        f"{100 - 100 * busy / (wall * 1e3):.1f}% on {card}")
    for e in sorted(events, key=lambda e: -dev_us(e))[:15]:
        log(f"  {dev_us(e) / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:90]}")


def traced(run, what, card):
    """`run()` under `utils.profiling.trace`: the program's table by
    `tak.` range (calls, host self ms, device ms of the kernels launched
    inside) for `what`."""
    from tak_tpu_torch.utils.profiling import trace

    log(f"profile ranges ({what}, on {card}):")
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp, log=log):
            run()


def profile_search(mcts, params, root_states, card, what=None):
    """Where one search (by default a self-play move's: 10,240 sims on 32
    games) spends its time: once under `utils.profiling.trace` (the
    program's spans by wave stage), once under torch.profiler."""
    what = what or ("one self-play move's search, fused_leaf_legal="
                    f"{mcts.config.fused_leaf_legal}")
    tree = mcts.prepare_root(params, mcts.init_batch(root_states))
    traced(lambda: mcts.run_sims(params, tree), what, card)
    tree = mcts.prepare_root(params, mcts.init_batch(root_states))
    device_profile(lambda: mcts.run_sims(params, tree), what, card)


def profile_player(player, card, waves=200):
    """Where `waves` Player waves on the player's current (carried) tree
    spend their time: under `utils.profiling.trace`, then torch.profiler;
    and what `debug()` and the reroot of `play_move` cost at this tree
    size."""
    player.rollout(20)
    traced(lambda: player.rollout(waves), f"{waves} Player waves", card)
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
                   check_tier=None, **search_options):
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
    if check_tier is not None and actor.mcts.tier != check_tier:
        fail(f"{what} took tier {actor.mcts.tier}, not {check_tier}")
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

    def select_moves(gen, t, exploit, mesh=None):
        a = orig_select(gen, t, exploit, mesh)
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
    from tak_tpu_torch.kernels import build as kb
    from tak_tpu_torch.model.batch_norm import BatchNormPlain
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
    # every train-mode BatchNorm goes through the tak_bn_* kernels: six
    # launches each a chunk, and no CUDA tensor reaches the plain version
    plain_devices = []
    plain_forward = BatchNormPlain.forward

    def spy(ctx, x, *rest):
        plain_devices.append(x.device.type)
        return plain_forward(ctx, x, *rest)

    before = dict(kb.LAUNCHES)
    BatchNormPlain.forward = staticmethod(spy)
    try:
        new, wall, steps = train_run(net, variables, examples,
                                     np.random.default_rng([0, 7]),
                                     "Net6 learner")
    finally:
        BatchNormPlain.forward = staticmethod(plain_forward)
    if len(steps) != L6_EXAMPLES // (CHUNK_SIZE * CHUNKS_IN_STEP):
        fail(f"Net6 learner took {len(steps)} steps")
    bns = (1 + 2 * net.config.blocks) * L6_EXAMPLES // CHUNK_SIZE
    bn_launches = {k: v for k, v in launches_since(before).items()
                   if k.startswith("tak_bn_")}
    want = {"tak_bn_stats": bns, "tak_bn_finalize": 2 * bns,
            "tak_bn_normalize": bns, "tak_bn_grad_sums": bns,
            "tak_bn_grad_input": bns}
    if bn_launches != want or plain_devices:
        fail(f"Net6 learner: launches {bn_launches}, expected {want}; the "
             f"plain BatchNorm ran on {plain_devices[:3]}")
    log(f"Net6 learner: every one of its {bns:,} BatchNorm forwards and "
        f"backwards ran on the tak_bn_* kernels ({bn_launches}), none on "
        "the plain version")
    rows = CHUNKS_IN_STEP * CHUNK_SIZE * 8
    fwd = forward_flops_per_row(net.config)
    step_flops = 3 * fwd * rows
    ms_step = wall * 1e3 / len(steps)
    share = step_flops / (ms_step / 1e3) / BF16_OPS_PER_S
    out = {"examples_per_s": L6_EXAMPLES / wall, "ms_per_step": ms_step,
           "bf16_share": share, "step_tflop": step_flops / 1e12,
           "bn_launches": bn_launches}
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


def bf16_steps(got, want, terms):
    """Per element, |got - want| over one bf16 step (ulp) at the larger
    magnitude of the two, after a float32 slack of 2^-14 of `terms` (the
    magnitude of what was summed into the element before it was rounded:
    the two sides' float32 statistics differ in their summation order)."""
    import torch

    g, w = got.float(), want.float()
    big = torch.maximum(g.abs(), w.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    return ((g - w).abs() - terms * 2.0 ** -14).clamp(min=0) / ulp


def batch_norm_phase(dev, card):
    """The `tak_bn_*` kernels against the plain Function on the card, at the
    learner's shape: 4,000 x 128 x 6 x 6 in bf16, channels-last, per-channel
    offsets and scales, one constant channel (its variance may clip), the
    running statistics starting at 0 (so that after one call they hold
    0.01 x the batch statistics).  Fatal unless y and dx lie within one
    bf16 step (`bf16_steps`), the batch statistics within 1e-5 and the
    parameter gradients within 1e-4 of their largest entry, and dx within
    one bf16 step of the float64 plain version's too.  Then times the
    forward and the backward of each (CUDA events, `launch_ms`) beside the
    byte floor (3 and 5 passes over x at 3.35 TB/s), and the host's cost
    of the kernels' forward and backward through autograd.  Returns the
    times."""
    import torch

    from tak_tpu_torch.kernels import build as kb
    from tak_tpu_torch.model.batch_norm import (
        BatchNormKernel,
        BatchNormPlain,
    )

    rows, C, n = BN_ROWS, BN_CHANNELS, N
    g = torch.Generator(device=dev).manual_seed(SEED)
    scale = torch.rand(C, 1, 1, generator=g, device=dev) * 2 + 0.1
    shift = torch.randn(C, 1, 1, generator=g, device=dev)
    x = torch.randn((rows, C, n, n), generator=g, device=dev) * scale + shift
    x[:, 7] = 0.3
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    dy = (torch.randn((rows, C, n, n), generator=g, device=dev)
          .to(torch.bfloat16).contiguous(memory_format=torch.channels_last))
    weight = torch.rand(C, generator=g, device=dev) + 0.5
    bias = torch.randn(C, generator=g, device=dev)

    def run(fn, xin, dyin):
        xg = xin.detach().clone().requires_grad_()
        w, b = weight.clone().requires_grad_(), bias.clone().requires_grad_()
        rm = torch.zeros(C, device=dev)
        rv = torch.zeros(C, device=dev)
        y = fn.apply(xg, w, b, rm, rv, None)
        y.backward(dyin)
        return y.detach(), xg.grad, w.grad, b.grad, rm, rv

    before = dict(kb.LAUNCHES)
    k = run(BatchNormKernel, x, dy)
    sync()
    launched = launches_since(before)
    want = {"tak_bn_stats": 1, "tak_bn_finalize": 2, "tak_bn_normalize": 1,
            "tak_bn_grad_sums": 1, "tak_bn_grad_input": 1}
    if launched != want:
        fail(f"BatchNorm kernels launched {launched}, expected {want}")
    p = run(BatchNormPlain, x, dy)
    e = run(BatchNormPlain, x.double(), dy.double())
    sync()

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()
                     / b.double().abs().max())

    mean = p[4] / 0.01
    var = p[5] / 0.01
    inv = torch.rsqrt(var + 1e-5)
    xhat = (x.float() - mean[:, None, None]) * inv[:, None, None]
    y_terms = (xhat.abs() * weight[:, None, None].abs()
               + bias[:, None, None].abs())
    count = rows * n * n            # dx = (dy - mdy - xhat * mdyx) * a
    mdy, mdyx = p[3] / count, p[2] / count
    dx_terms = ((dy.float().abs() + mdy.abs()[:, None, None]
                 + xhat.abs() * mdyx.abs()[:, None, None])
                * (weight * inv).abs()[:, None, None])
    err = {
        "y_steps": float(bf16_steps(k[0], p[0], y_terms).max()),
        "dx_steps": float(bf16_steps(k[1], p[1], dx_terms).max()),
        "dx_steps_f64": float(bf16_steps(k[1], e[1], dx_terms).max()),
        "mean": rel(k[4], p[4]),
        "var": rel(k[5], p[5]),
        "dweight": rel(k[2], p[2]),
        "dbias": rel(k[3], p[3]),
    }
    limits = {"y_steps": 1, "dx_steps": 1, "dx_steps_f64": 1, "mean": 1e-5,
              "var": 1e-5, "dweight": 1e-4, "dbias": 1e-4}
    exact = {"y": float((k[0] != p[0]).float().mean()),
             "dx": float((k[1] != p[1]).float().mean())}
    log(f"check BatchNorm kernels against the plain Function ({rows} x {C} "
        f"x {n} x {n}, bf16, channels-last): y and dx differ from the plain "
        f"version's in {100 * exact['y']:.3f}% and {100 * exact['dx']:.3f}% "
        f"of elements, by at most {err['y_steps']:.2f} and "
        f"{err['dx_steps']:.2f} bf16 steps (beyond 2^-14 of the terms); dx "
        f"{err['dx_steps_f64']:.2f} steps from float64's; batch mean "
        f"{err['mean']:.1e}, variance {err['var']:.1e}, dweight "
        f"{err['dweight']:.1e}, dbias {err['dbias']:.1e} (relative); limits "
        + ", ".join(f"{a} {b:g}" for a, b in limits.items()))
    if any(err[a] > b for a, b in limits.items()):
        fail("BatchNorm kernels disagree with the plain Function")

    # device times of the forward's and the backward's launches alone,
    # back to back (`launch_ms`), the Function's own steps called with a
    # stand-in for autograd's context; then the host's cost of a forward
    # and backward through autograd, on a tensor small enough that the
    # card never holds the host back
    class Ctx:
        def save_for_backward(self, *tensors):
            self.saved_tensors = tensors

    out = {}
    for name, fn in (("kernel", BatchNormKernel), ("plain", BatchNormPlain)):
        ctx = Ctx()

        def fwd():
            fn.forward(ctx, x, weight, bias, torch.zeros(C, device=dev),
                       torch.zeros(C, device=dev), None)

        fwd()
        out[name] = (launch_ms(fwd), launch_ms(lambda: fn.backward(ctx, dy)))
    small = x[:8].detach().requires_grad_()
    small_dy = dy[:8]

    def host_step():
        BatchNormKernel.apply(small, weight, bias, torch.zeros(C, device=dev),
                              torch.zeros(C, device=dev),
                              None).backward(small_dy)

    for _ in range(20):
        host_step()
    sync()
    t0 = time.perf_counter()
    for _ in range(200):
        host_step()
    sync()
    out["host_us"] = (time.perf_counter() - t0) / 200 * 1e6
    nbytes = x.numel() * x.element_size()
    bound = (3 * nbytes / HBM_BYTES_PER_S * 1e3,
             5 * nbytes / HBM_BYTES_PER_S * 1e3)
    out["bound"] = bound
    out["err"] = err
    log(f"time BatchNorm at {rows} x {C} x {n} x {n} bf16: kernels forward "
        f"{out['kernel'][0]:.4f} ms, backward {out['kernel'][1]:.4f} ms "
        f"(byte floor {bound[0]:.4f} and {bound[1]:.4f} ms: 3 and 5 passes "
        f"over x at 3.35 TB/s); plain forward {out['plain'][0]:.3f} ms, "
        f"backward {out['plain'][1]:.3f} ms; x {1 + 2 * 16} BatchNorms a "
        f"Net6 chunk: {(1 + 2 * 16) * sum(out['kernel']):.2f} ms against "
        f"{(1 + 2 * 16) * sum(out['plain']):.2f} ms plain; the host's cost "
        f"of a forward and backward through autograd {out['host_us']:.1f} "
        f"us, on {card}")
    return out


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


def grow_pipelined(mcts, params, tree, waves, pending=None):
    """`waves` pipelined waves of `mcts`'s search on `tree` (in place), from
    `pending` (default: nothing pending).  Returns the pending wave."""
    from tak_tpu_torch.mcts.tree_kernels import Pending

    B, _, K = tree.edge_n.shape
    if pending is None:
        pending = Pending.zeros(B, mcts.config.wave_size, K, tree.n0.device)
    for _ in range(waves):
        pending = mcts._wave_pipelined(params, tree, pending)
    sync()
    return pending


def pool_kernel_runs(mcts, tree, pending):
    """#2 on the pending wave, #4 (the merged kernel's plain version with
    nothing pending) and #3 on `tree`'s search shape: {kernel: (kernel
    run, plain run, descends, backs up)} and the empty pending wave."""
    from tak_tpu_torch.mcts.tree_kernels import (
        Pending,
        backup_descend_plain,
        backup_descend_wave,
        descend_wave,
        expand_backup_plain,
        expand_backup_wave,
    )

    scfg = mcts.config
    V, rc = scfg.wave_size, scfg.recycle
    kargs = dict(base=scfg.exploration_base, init=scfg.exploration_init,
                 recycle=rc)
    B, _, K = tree.edge_n.shape
    zero = Pending.zeros(B, V, K, tree.n0.device)
    runs = {
        "backup_descend_wave": (
            lambda t: backup_descend_wave(t, pending, **kargs),
            lambda t: backup_descend_plain(t, pending, **kargs), True, True),
        "descend_wave": (
            lambda t: descend_wave(t, V, **kargs),
            lambda t: backup_descend_plain(t, zero, **kargs), True, False),
        "expand_backup_wave": (
            lambda t: expand_backup_wave(t, pending, recycle=rc),
            lambda t: expand_backup_plain(t, pending, recycle=rc),
            False, True),
    }
    return runs, zero, kargs


def hold_pool_kernels(mcts, tree, pending, what):
    """#2, #4 and #3 on copies of `tree`, each bitwise against its plain
    version.  Returns {kernel: (tree after, descends, backs up, leaves)}."""
    runs, _, _ = pool_kernel_runs(mcts, tree, pending)
    checks = {}
    for name, (run_k, run_p, descend, backup) in runs.items():
        tk, tp = tree.clone(), tree.clone()
        out_k, out_p = run_k(tk), run_p(tp)
        sync()
        compare_trees(tk, tp, f"{name} {what}")
        if out_k is not None and not all(bool((x == y).all())
                                         for x, y in zip(out_k, out_p)):
            fail(f"{name} {what}: leaves/created differ")
        checks[name] = (tk, descend, backup, out_k[0] if out_k else None)
    return checks


def time_pool_kernels(mcts, tree, pending, checks):
    """#2, #4 and #3 on `tree` and its pending wave: the kernel (`launch_ms`
    over fresh copies of the tree), its plain version, its bound and chain
    floor.  Returns ({kernel: (ms, plain ms, bound ms, bound by)},
    {kernel: floor ms}, a description of the chase)."""
    from tak_tpu_torch.mcts.tree_kernels import backup_descend_wave

    runs, zero, kargs = pool_kernel_runs(mcts, tree, pending)
    B, M, K = tree.edge_n.shape
    A = tree.root_n.shape[1]
    V = mcts.config.wave_size
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
            tree_ops(B, V, A, M, descend, recycle=kargs["recycle"])))
    floors, chase = pool_chain_floors(tree, pending, checks, V)
    return times, floors, chase


def pool_times_line(times, floors):
    return "; ".join(
        f"{n} {v[0]:.4f} ms (plain {v[1]:.3f} ms, bound {v[2]:.6f} ms by "
        f"{v[3]}, chain floor {floors[n]:.4f} ms)" for n, v in times.items())


def pit_kernels_phase(captured, card):
    """The pool-tier kernels at the pit's shape (64 games, K=128, M=1,602,
    V=16, no recycling), bitwise against their plain versions: on the tree
    that each first half-batch search started from (carried by reuse),
    grown by 1, 4, 10 or 25 pipelined waves of that search in turn, #2 and
    #3 on the pending wave and #4; then on the tree of ply PIT_CHECK_PLY
    grown by PIT_CHECK_WAVES waves, timed (`launch_ms` over fresh copies
    of the tree) with their bound and chain floor.  Returns ({kernel: (ms,
    plain ms, bound ms, bound by)}, {kernel: floor ms})."""
    mcts = captured["mcts"]
    V = mcts.config.wave_size
    seen = []
    for i, (ply, params, tree) in enumerate(captured["trees"]):
        waves = (1, 4, 10, 25)[i % 4]
        carried = int(tree.n0.sum())
        tree = tree.clone()
        hold_pool_kernels(mcts, tree, grow_pipelined(mcts, params, tree,
                                                     waves),
                          "at the pit's shape")
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
    pending = grow_pipelined(mcts, params, tree, PIT_CHECK_WAVES)
    checks = hold_pool_kernels(mcts, tree, pending, "at the pit's shape")
    times, floors, chase = time_pool_kernels(mcts, tree, pending, checks)
    log(f"time pool tier at the pit's shape on {card} (B={B} K={K} M={M} "
        f"V={V}, A={A}, recycling off; the tree of ply {PIT_CHECK_PLY}'s "
        f"first half-batch search, {carried} root visits carried by reuse, "
        f"then {PIT_CHECK_WAVES} pipelined waves): "
        + pool_times_line(times, floors) + f"; {chase}")
    return times, floors


def captured_pool_phase(mcts, params, tree, what, card):
    """The pool-tier kernels on a tree captured from a path's own search
    (a copy taken as a search call began, carried by reuse): grown by that
    search's pipelined waves until the recycled pool is full in every game
    (at least 2 waves, at most 12), then #2, #4 and #3 held bitwise
    against their plain versions on it and timed beside their bound.
    Returns (a shape label, {kernel: (ms, plain ms, bound ms, bound by)},
    {kernel: floor ms})."""
    B, M, K = tree.edge_n.shape
    A = tree.root_n.shape[1]
    V = mcts.config.wave_size
    carried = int(tree.n0.sum())
    tree = tree.clone()
    pending, waves = None, 0
    while waves < 12 and not (waves >= 2 and
                              bool((tree.next_free == M).all())):
        pending = grow_pipelined(mcts, params, tree, 1, pending)
        waves += 1
    if mcts.config.recycle and not bool((tree.next_free == M).all()):
        fail(f"{what}: pool not full after {waves} waves")
    label = f"{what}, B={B} K={K} M={M} V={V} A={A}"
    checks = hold_pool_kernels(mcts, tree, pending, f"at the {label}")
    times, floors, chase = time_pool_kernels(mcts, tree, pending, checks)
    log(f"check and time pool tier at the {label} ({carried} root visits "
        f"carried by reuse, then {waves} pipelined waves, pool full): #2, #4 "
        f"and #3 bitwise equal to the plain versions; "
        + pool_times_line(times, floors) + f"; {chase} on {card}")
    return label, times, floors


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
    """Where one Net6 optimizer step (a `Network.train` call on 20 chunks
    of 500 x 8 rows) spends its time: under `utils.profiling.trace` (the
    program's spans by prestack, chunk assembly, forward and backward,
    step); one BatchNorm's forward and backward at a chunk's shape (CUDA
    events) times the step's BatchNorms; then torch.profiler's device
    time by kernel family and the device's idle share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tak_tpu_torch.model.batch_norm import BatchNormPlain
    from tak_tpu_torch.model.network import CHUNK_SIZE, CHUNKS_IN_STEP
    from tak_tpu_torch.model.resnet import BatchNorm

    part = examples[:CHUNK_SIZE * CHUNKS_IN_STEP]

    def step():
        net.train(variables, part, rng=np.random.default_rng(0),
                  log=lambda *a, **k: None)
        sync()

    step()
    t0 = time.perf_counter()
    step()
    wall = time.perf_counter() - t0
    traced(step, "one Net6 optimizer step", card)

    bn = BatchNorm(net.config.filters).to(net.device).train()
    n = net.config.n
    x = torch.randn((CHUNK_SIZE * 8, net.config.filters, n, n),
                    device=net.device, dtype=net.config.dtype)
    xl = x.to(memory_format=torch.channels_last).requires_grad_()
    ms = cuda_ms(lambda _: bn(xl).float().sum().backward(), 5)

    def plain(_):
        BatchNormPlain.apply(xl, bn.weight, bn.bias, bn.running_mean,
                             bn.running_var, None).float().sum().backward()

    ms_plain = cuda_ms(plain, 5)
    count = 1 + 2 * net.config.blocks
    log(f"profile BatchNorm (CUDA events): one forward + backward at "
        f"{tuple(x.shape)} {net.config.dtype}, channels-last as in training, "
        f"{ms:.3f} ms (the plain Function {ms_plain:.3f} ms); x {count} "
        f"BatchNorms x {CHUNKS_IN_STEP} chunks = "
        f"{ms * count * CHUNKS_IN_STEP:.1f} ms of "
        f"the step's {wall * 1e3:.1f} ms; its least time from bytes (bf16: "
        f"forward reads x twice and writes y, backward reads dy and x twice "
        f"and writes dx) {8 * x.numel() * 2 / HBM_BYTES_PER_S * 1e3:.3f} ms, "
        f"on {card}")

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
    events = device_events(prof)
    for e in events:
        families[family(e.key.lower())] += dev_us(e) / 1e3
    busy = sum(families.values())
    log(f"profile device (torch.profiler, one Net6 optimizer step): wall "
        f"{wall * 1e3:.1f} ms, device busy {busy:.1f} ms, idle "
        f"{100 - 100 * busy / (wall * 1e3):.1f}% on {card}")
    for fam, ms_f in sorted(families.items(), key=lambda kv: -kv[1]):
        log(f"  {ms_f:9.2f} ms  {fam}")
    top = sorted(events, key=lambda e: -dev_us(e))[:12]
    for e in top:
        log(f"  {dev_us(e) / 1e3:9.2f} ms  x{e.count:<6d} "
            f"[{family(e.key.lower()).split(' (')[0]}] {e.key[:80]}")


# ---------------------------------------------------------------------------
# The ninth slice's paths: the "xla" search path and Gumbel root search,
# quad-rollout self-play, the dense Net5 head, the playtak bot, the native
# engine.  Each path is driven from launch counts of 0.
# ---------------------------------------------------------------------------

def launches_since(before):
    from tak_tpu_torch.kernels import build as kb

    return {k: v - before.get(k, 0) for k, v in kb.LAUNCHES.items()
            if v - before.get(k, 0)}


def recycle_invariants(tree, sims, what):
    """`tests/test_recycle.py`'s invariants of a finished search on a fresh
    tree, for every game at once: the root holds 1 + sims visits and its
    edges `sims`, no virtual visit or pin is left, every materialized
    child links back to its edge, `child_count` counts them, and a node's
    `node_n` snapshot never exceeds its edge's visits."""
    import torch

    from tak_tpu_torch.mcts.tree import NONE

    B, M, K = tree.edge_n.shape
    dev = tree.n0.device
    if not bool((tree.n0 == sims + 1).all()):
        fail(f"{what}: root counts {tree.n0.tolist()}, expected {sims + 1}")
    if not bool((tree.root_n.sum(1) == sims).all()):
        fail(f"{what}: root edges hold {tree.root_n.sum(1).tolist()}")
    for f in ("virt0", "root_virt", "edge_virt", "node_virt"):
        if bool(getattr(tree, f).any()):
            fail(f"{what}: {f} left nonzero")
    counts = torch.zeros((B, M), dtype=torch.long, device=dev)
    # root children
    g, a = torch.nonzero(tree.root_child != NONE, as_tuple=True)
    c = tree.root_child[g, a].long()
    counts[:, 0] = (tree.root_child != NONE).sum(1)
    if not (bool((tree.parent[g, c] == 0).all())
            and bool((tree.parent_slot[g, c] == NONE).all())
            and bool((tree.parent_action[g, c] == a).all())
            and bool((tree.node_n[g, c] <= tree.root_n[g, a]).all())
            and bool((tree.node_n[g, c] >= 0).all())):
        fail(f"{what}: a root child does not link back to its action")
    # edge children of expanded nodes
    live = (tree.edge_child != NONE) & tree.expanded[:, :, None]
    g, r, s = torch.nonzero(live, as_tuple=True)
    c = tree.edge_child[g, r, s].long()
    counts += live.sum(2)
    if not (bool((tree.parent[g, c] == r).all())
            and bool((tree.parent_slot[g, c] == s).all())
            and bool((tree.node_n[g, c] <= tree.edge_n[g, r, s]).all())):
        fail(f"{what}: an edge child does not link back to its edge")
    attached = torch.zeros((B, M), dtype=torch.bool, device=dev)
    attached[:, 0] = True
    ga, aa = torch.nonzero(tree.root_child != NONE, as_tuple=True)
    attached[ga, tree.root_child[ga, aa].long()] = True
    attached[g, c] = True
    bad = attached & (tree.child_count.long() != counts)
    if bool(bad.any()):
        fail(f"{what}: child_count differs from the materialized children "
             f"at {int(bad.sum())} nodes")
    return int(attached.sum())


def xla_v1_phase(engine, net6_eval, params6, roots, card):
    """The "xla" path against the pool-tier kernels at V = 1 (the card's
    counterpart of `tests/test_recycle.py:207`): the same GAMES roots,
    6x6, K=32, a recycled X1_POOL-node pool that evicts, the trained Net6
    in bf16, X1_SIMS waves of one descent; the two trees must be equal in
    every field, node states, `root_w` and `edge_w` included.  Returns
    the launch counts of both searches."""
    import torch

    from tak_tpu_torch.kernels import build as kb
    from tak_tpu_torch.mcts.search import MCTS, SearchConfig

    trees, secs, counts = {}, {}, {}
    for backend in ("pallas", "xla"):
        m = MCTS(engine, net6_eval, SearchConfig(
            num_sims=X1_SIMS, wave_size=1, max_children=K,
            node_budget=X1_POOL, recycle=True, backend=backend))
        want = {"pallas": "pool", "xla": "xla"}[backend]
        if m.tier != want:
            fail(f"backend {backend!r} took tier {m.tier!r}")
        t = m.prepare_root(params6, m.init_batch(roots))
        sync()
        kb.reset_launches()
        t0 = time.perf_counter()
        trees[backend] = m.run_sims(params6, t)
        sync()
        secs[backend] = time.perf_counter() - t0
        counts[backend] = dict(kb.LAUNCHES)
    compare_trees(trees["xla"], trees["pallas"],
                  "the xla path against the pool-tier kernels at V=1")
    compare_states(trees["xla"].state, trees["pallas"].state,
                   "the node states of the V=1 trees")
    evicted = int((trees["xla"].next_free == X1_POOL).sum())
    if evicted != GAMES:
        fail(f"V=1 check: only {evicted} of {GAMES} pools filled up")
    recycle_invariants(trees["xla"], X1_SIMS, "V=1 xla tree")
    want_pool = {"descend_wave": 1, "backup_descend_wave": X1_SIMS - 1,
                 "expand_backup_wave": 1, "fused_step": X1_SIMS}
    if counts["pallas"] != want_pool:
        fail(f"V=1 pool-tier launches {counts['pallas']}, want {want_pool}")
    if counts["xla"] != {"fused_step": X1_SIMS}:
        fail(f"V=1 xla launches {counts['xla']}: only the leaf steps "
             "should launch a kernel")
    log(f"check xla path at V=1: {GAMES} games x {X1_SIMS} waves of one "
        f"descent, K={K}, a {X1_POOL}-node recycled pool (full in every "
        f"game), the trained Net6 in bf16: the tree equals the pool-tier "
        f"kernels' bitwise in every field (root_w, edge_w and node states "
        f"included); xla {secs['xla']:.2f} s, pool tier "
        f"{secs['pallas']:.2f} s; launches xla {counts['xla']}, pool tier "
        f"{counts['pallas']} on {card}")
    total = collections.Counter(counts["xla"]) + collections.Counter(
        counts["pallas"])
    return dict(total)


def graph_descent_phase(mcts, tree, what, card, gumbel=None):
    """The "xla" path's descent iteration replayed as a CUDA graph (its
    mode on the card) against the same iteration run eagerly (`_graphs`
    off, as on the CPU): one wave's descents from `tree` (with `gumbel`,
    the Gumbel root pick) must leave bitwise-equal trees, leaves and
    created flags, in the capturing call and in a replay on the tree
    reset in the captured storage.  Both modes are timed on that tree.
    Returns (graph ms, eager ms) for one wave's descents."""
    from tak_tpu_torch.mcts.tree import TENSOR_FIELDS

    def descend(t):
        sync()
        t0 = time.perf_counter()
        leaves, created = mcts._descend_xla(t, gumbel)
        sync()
        return (leaves, created), 1e3 * (time.perf_counter() - t0)

    tg = tree.clone()
    out_c, capture_ms = descend(tg)
    after_capture = tg.clone()
    for f in TENSOR_FIELDS:     # the same tree again in the same storage
        getattr(tg, f).copy_(getattr(tree, f))
    out_g, graph_ms = descend(tg)
    te = tree.clone()
    mcts._graphs = False
    try:
        out_e, eager_ms = descend(te)
    finally:
        mcts._graphs = True
    for got, t, mode in ((out_c, after_capture, "capturing"),
                         (out_g, tg, "replayed")):
        compare_trees(t, te, f"{what}: the {mode} graph descent against "
                      "the eager one")
        if not all(bool((x == y).all()) for x, y in zip(got, out_e)):
            fail(f"{what}: {mode} graph descent: leaves/created differ")
    log(f"check xla descent as CUDA graphs against eager ({what}): one wave "
        f"of {mcts.config.wave_size} descents in {tree.n0.shape[0]} games, "
        f"trees, "
        f"leaves and created flags bitwise equal when capturing and "
        f"replayed; graph {graph_ms:.1f} ms (capturing {capture_ms:.1f} "
        f"ms), eager {eager_ms:.1f} ms on {card}")
    return graph_ms, eager_ms


def xla_selfplay_phase(engine, eval_fn, params, dev, card, pool_rate):
    """Self-play on the "xla" path at the reference config for one searched
    move (`backend="xla"`: 32 games, 10,240 sims, wave 256, K=32, the
    recycled 1,280-node pool): the tier, visit conservation and the
    recycling invariants of the searched trees, sims/s and ms per wave
    beside the pool tier's sims/s of this run; then the descent's CUDA
    graphs against the eager descent on move 1's searched tree."""
    from tak_tpu_torch.mcts.search import MCTS

    launches, lines, _, tree = selfplay_phase(
        engine, eval_fn, params, dev, card, "self-play on the xla path", 1,
        backend="xla", check_tier="xla")
    nodes = recycle_invariants(tree, SIMS, "xla self-play tree")
    mcts = MCTS(engine, eval_fn, make_actor(engine, eval_fn, dev, 1,
                                            backend="xla").search_config)
    graph_ms, eager_ms = graph_descent_phase(
        mcts, tree, "move 1's searched tree", card)
    waves = SIMS // WAVE
    sec = float(lines[0].split(": ")[1].split(" s,")[0])
    rate = GAMES * SIMS / sec
    want = {"fused_step"}
    if set(launches) != want:
        fail(f"xla self-play launched {launches}: the search should launch "
             "only leaf steps (the win scan and the move tail step too)")
    out = {"sims_per_s": rate, "ms_per_wave": 1e3 * sec / waves,
           "pool_sims_per_s": pool_rate, "descent_graph_ms": graph_ms,
           "descent_eager_ms": eager_ms}
    log(f"xla path at the reference self-play config: {GAMES} games x "
        f"{SIMS} sims, {waves} waves of {WAVE}, one move in {sec:.2f} s: "
        f"{rate:,.0f} sims/s, {out['ms_per_wave']:.1f} ms per wave (the pool "
        f"tier: {pool_rate:,.0f} sims/s, {pool_rate / rate:.1f} times as "
        f"fast); {nodes} attached nodes, invariants hold; launches "
        f"{launches} on {card}")
    return launches, out


def sequential_halving_visits(seq):
    """The root visit multiset that the schedule `seq` implies on a fresh
    tree: each descent takes an action whose count equals its target."""
    have = collections.Counter()
    for t in seq:
        if t > 0:
            if have[t] == 0:
                return None
            have[t] -= 1
        have[t + 1] += 1
    return sorted(have.elements(), reverse=True)


def gumbel_phase(engine, eval_fn, params, dev, card):
    """Gumbel self-play at the reference config with gumbel_m=16, cut to
    GUMBEL_MOVES searched moves: the tier, the root visits of move 1's
    fresh trees against the sequential-halving schedule, targets summing
    to 65535 within the rounding of their entries, legal moves; sims/s;
    then the descent's CUDA graphs against the eager descent, with the
    Gumbel root pick, on move 1's searched tree."""
    import torch

    from tak_tpu_torch.kernels import build as kb
    from tak_tpu_torch.types import ONGOING

    actor = make_actor(engine, eval_fn, dev, GUMBEL_MOVES, gumbel_m=16)
    if actor.mcts.tier != "xla":
        fail(f"gumbel self-play took tier {actor.mcts.tier}")
    mcts = actor.mcts
    implied = sequential_halving_visits(mcts._considered_seq)
    if implied is None or sum(implied) != mcts.config.num_waves * WAVE:
        fail("the gumbel schedule is not a sequential halving")
    orig_run, orig_sel = mcts.run_sims_gumbel, mcts.select_moves_gumbel
    checked, times = [], []

    def run(p, t, gen, mesh=None):
        fresh = not checked
        sync()
        t0 = time.perf_counter()
        out, g = orig_run(p, t, gen, mesh)
        sync()
        times.append(time.perf_counter() - t0)
        if fresh:
            for i in range(GAMES):
                got = sorted(out.root_n[i][out.root_n[i] > 0].tolist(),
                             reverse=True)
                if got != implied:
                    fail(f"gumbel game {i}: root visits {got[:20]} do not "
                         f"follow the schedule {implied[:20]}")
            checked.append((out.clone(), g))
        return out, g

    def select(t, g):
        a = orig_sel(t, g)
        roots = t.state[:, 0]
        ok = engine.legal_mask(roots)[torch.arange(GAMES, device=dev),
                                      a.long()]
        if not bool((ok | (roots.result != ONGOING)).all()):
            fail(f"gumbel self-play chose an illegal move: {a.tolist()}")
        return a

    mcts.run_sims_gumbel, mcts.select_moves_gumbel = run, select
    mcts.add_noise = None      # gumbel mode draws no Dirichlet noise
    kb.reset_launches()
    examples = actor.run(params, seed=SEED, log=lambda m: log(f"  {m}"))
    launches = dict(kb.LAUNCHES)
    A = engine.num_actions
    searched = [e for e in examples if e.visits.max() != 1000]
    for e in searched:
        if abs(int(e.visits.sum()) - 65535) > len(e.visits) / 2 + 1:
            fail(f"gumbel targets sum to {int(e.visits.sum())} over "
                 f"{len(e.visits)} entries")
    if len(times) != GUMBEL_MOVES or not searched:
        fail(f"gumbel self-play searched {len(times)} moves, "
             f"{len(searched)} examples")
    rates = [GAMES * mcts.config.num_waves * WAVE / s for s in times]
    graph_descent_phase(mcts, checked[0][0], "gumbel move 1's searched tree",
                        card, gumbel=checked[0][1])
    log(f"gumbel self-play (gumbel_m=16, {GAMES} games x {SIMS} sims, wave "
        f"{WAVE}, K={K}, xla path): {GUMBEL_MOVES} moves, "
        + ", ".join(f"move {i + 1} {s:.2f} s ({r:,.0f} sims/s)"
                    for i, (s, r) in enumerate(zip(times, rates)))
        + f"; move 1's {GAMES} fresh roots hold the schedule's visits "
        f"({implied[:4]}...); {len(searched)} examples, targets sum to "
        f"65535 within rounding (A={A}); launches {launches} on {card}")
    return launches, {"sims_per_s": rates[-1], "move_s": times}


def quad_phase(engine, eval_fn, params, dev, card):
    """Sequential quad-rollout self-play (workers=1, quad_rollout_plies=6,
    the reference search config), cut to QUAD_PLIES plies: the #1-#4
    launches of every search call from the config (4 calls a move below
    ply 6), each early move's search adding 4x the root visits of a late
    one (the examples also hold the visits that tree reuse carried in);
    sims/s.  Then #2-#4 at this one-game shape (`captured_pool_phase`),
    on the tree that ply 0's second search call started from."""
    from tak_tpu_torch.kernels import build as kb
    from tak_tpu_torch.mcts.search import SearchConfig
    from tak_tpu_torch.selfplay import SelfPlayActor, SelfPlayConfig

    actor = SelfPlayActor(engine, eval_fn, SelfPlayConfig(
        games=1, workers=1, max_plies=QUAD_PLIES, quad_rollout_plies=6,
        search=SearchConfig(num_sims=SIMS, wave_size=WAVE, max_children=K,
                            recycle=True)), device=dev)
    mcts = actor.mcts
    cfg = mcts.config
    if mcts.tier != "pool" or cfg.max_nodes != POOL:
        fail(f"quad self-play: tier {mcts.tier}, {cfg}")
    chunk = -(-cfg.scan_chunk // WAVE)
    chunks = -(-cfg.num_waves // chunk)
    per_call = {"descend_wave": chunks,
                "backup_descend_wave": chunks * (chunk - 1),
                "expand_backup_wave": chunks,
                "fused_step": chunks * chunk}
    calls, gained, orig = [], collections.Counter(), mcts.run_sims
    captured = []

    def run(p, t):
        if len(calls) == 1:   # ply 0's second search: visits carried in
            captured.append(t.clone())
        before, n0 = dict(kb.LAUNCHES), int(t.n0[0])
        out = orig(p, t)
        got = launches_since(before)
        if got != per_call:
            fail(f"quad self-play: a search call launched {got}, the config "
                 f"gives {per_call}")
        ply = int(out.state.ply[0, 0])
        calls.append(ply)
        gained[ply] += int(out.n0[0]) - n0
        return out

    mcts.run_sims = run
    kb.reset_launches()
    sync()
    t0 = time.perf_counter()
    examples = actor.run(params, seed=SEED, log=lambda m: log(f"  {m}"))
    sync()
    wall = time.perf_counter() - t0
    launches = dict(kb.LAUNCHES)
    per_ply = collections.Counter(calls)
    for ply, n in per_ply.items():
        if n != (4 if ply < 6 else 1):
            fail(f"quad self-play: ply {ply} searched {n} times")
        if gained[ply] != n * cfg.num_waves * WAVE:
            fail(f"quad self-play: ply {ply}'s searches added {gained[ply]} "
                 "root visits")
    early = [int(e.visits.sum()) for e in examples if int(e.state["ply"]) < 6]
    late = [int(e.visits.sum()) for e in examples if int(e.state["ply"]) >= 6]
    if (not early or not late or min(early) < 4 * SIMS
            or len(examples) != len(per_ply)):
        fail(f"quad self-play: example visits early {early}, late {late}")
    sims = sum(s for _, s in actor.move_times)
    rate = sims / sum(t for t, _ in actor.move_times)
    log(f"quad-rollout self-play (workers 1, quad_rollout_plies 6, {SIMS} "
        f"sims, wave {WAVE}, K={K}, {POOL}-node pool; cut: {QUAD_PLIES} "
        f"plies): searches per ply {dict(sorted(per_ply.items()))}, each "
        f"call {per_call}; root visits added per ply "
        f"{dict(sorted(gained.items()))}; example visits (carried ones "
        f"included) early {early}, late {late}; "
        f"{rate:,.0f} sims/s ({wall:.2f} s in all); launches {launches} on "
        f"{card}")
    shape = captured_pool_phase(mcts, params, captured[0],
                                "quad search's shape", card)
    return launches, {"sims_per_s": rate}, shape


def dense_net5_phase(dev, card):
    """The dense Net5 head (5x5, 8 x 128, 1,575 legacy moves, weights from
    a seed): the card's float32 forward against the CPU's (TF32 off), a
    pool-tier self-play search of 2 moves with its kernel counts, one
    `Network.train` pass over the committed 5x5 buffer; examples/s.  Then
    #2-#4 at this 5x5 shape (`captured_pool_phase`), on the tree that
    move 2's search started from."""
    import dataclasses

    import numpy as np
    import torch

    from tak_tpu_torch.engine.core import get_engine
    from tak_tpu_torch.examples import ReplayBuffer
    from tak_tpu_torch.kernels import build as kb
    from tak_tpu_torch.model.network import CHUNK_SIZE, Network
    from tak_tpu_torch.model.resnet import NetConfig

    engine = get_engine(5)
    cfg = NetConfig(n=5, filters=128, blocks=8, policy_head="dense")
    if cfg.policy_size != 1575:
        fail(f"dense head of {cfg.policy_size} moves")
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    variables = Network(engine, cfg, device="cpu").init_variables(SEED)
    rng = np.random.default_rng(SEED)
    states = playout_states(engine, 256, 30, rng, dev)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card_p, card_v = Network(engine, f32, device=dev).policy_eval_states(
            variables, states)
        cpu_p, cpu_v = Network(engine, f32, device="cpu").policy_eval_states(
            variables, states.map(lambda x: x.cpu()))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    legacy = torch.as_tensor(engine.tables.legacy_actions).long()
    off = torch.ones(engine.num_actions, dtype=torch.bool)
    off[legacy] = False
    if bool(card_p.cpu()[:, off].any()):
        fail("the dense head put mass outside the legacy moves")
    err_p = float((card_p.cpu()[:, legacy].log()
                   - cpu_p[:, legacy].log()).abs().max())
    err_v = float((card_v.cpu() - cpu_v).abs().max())
    if not (err_p <= DENSE_TOL and err_v <= DENSE_TOL):
        fail(f"dense Net5 float32 forward: card against CPU log-prob "
             f"{err_p:.2e}, value {err_v:.2e} (tolerance {DENSE_TOL})")
    log(f"check dense Net5 ({describe(f32)}, 1,575 legacy moves, seeded "
        f"weights), 256 playout rows: the card's float32 forward (TF32 off) "
        f"against the CPU's: log-probabilities within {err_p:.2e}, values "
        f"{err_v:.2e} (tolerance {DENSE_TOL}); no mass off the legacy list")

    net = Network(engine, cfg, device=dev)

    def dense_eval(p, s):
        return net.policy_eval_states(p, s)

    actor = make_actor(engine, dense_eval, dev, DENSE_MOVES)
    mcts = actor.mcts
    if mcts.tier != "pool":
        fail(f"dense-head self-play took tier {mcts.tier}")
    captured, orig_run = [], mcts.run_sims

    def run(p, t):   # keep the tree the last search call started from
        captured[:] = [t.clone()]
        return orig_run(p, t)

    mcts.run_sims = run
    kb.reset_launches()
    sync()
    t0 = time.perf_counter()
    actor.run(variables, seed=SEED, log=lambda m: log(f"  {m}"))
    sync()
    wall = time.perf_counter() - t0
    launches = dict(kb.LAUNCHES)
    scfg = actor.search_config
    chunk = -(-scfg.scan_chunk // scfg.wave_size)
    chunks = -(-scfg.num_waves // chunk)
    moves = len(actor.move_times)
    want = {"descend_wave": moves * chunks, "expand_backup_wave":
            moves * chunks, "backup_descend_wave": moves * chunks * (chunk - 1)}
    if moves != DENSE_MOVES or any(launches.get(k) != v
                                   for k, v in want.items()):
        fail(f"dense-head search: {moves} moves, launches {launches}, want "
             f"{want}")
    rate = GAMES * SIMS * moves / sum(t for t, _ in actor.move_times)

    buf = ReplayBuffer()
    buf.load(engine, NET5_BUFFER)
    _, t_warm, _ = train_run(net, variables, buf.examples[:CHUNK_SIZE],
                             np.random.default_rng(0), "dense Net5 warm-up",
                             chunks_in_step=1)
    _, t_train, steps = train_run(net, variables, buf.examples,
                                  np.random.default_rng([0, 5]),
                                  "dense Net5 learner")
    chunks_done = len(buf) // CHUNK_SIZE
    ex_rate = chunks_done * CHUNK_SIZE / t_train
    log(f"dense Net5 ({describe(cfg)}): self-play search (5x5, {GAMES} games "
        f"x {SIMS} sims, wave {WAVE}, K={K}, pool tier) {DENSE_MOVES} moves "
        f"in {wall:.2f} s, {rate:,.0f} sims/s, launches {launches}; one "
        f"`Network.train` pass over {NET5_BUFFER} ({len(buf)} examples, "
        f"{chunks_done} chunks, {len(steps)} steps) in {t_train:.3f} s: "
        f"{ex_rate:,.0f} examples/s (warm-up {t_warm:.2f} s) on {card}")
    shape = captured_pool_phase(mcts, variables, captured[0],
                                "dense Net5 search's shape (5x5)", card)
    return launches, {"examples_per_s": ex_rate, "sims_per_s": rate,
                      "err_logp": err_p, "err_value": err_v}, shape


class ScriptedPlaytakServer:
    """A playtak.com stand-in on 127.0.0.1 for one guest game of BOT_PLIES
    plies: it answers the bot's moves with seeded legal replies (tracked
    on a port `Game` on the CPU), waits BOT_REPLY_S before each reply so
    that the bot's reads time out and it ponders, then ends the game."""

    def __init__(self, n, game_no=5):
        import socket
        import threading

        self.n, self.no = n, game_no
        self.listener = socket.create_server(("127.0.0.1", 0))
        self.port = self.listener.getsockname()[1]
        self.received, self.error = [], None
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        import numpy as np

        from tak_tpu_torch.game import Game
        from tak_tpu_torch.playtak.protocol import move_to_wire, wire_to_move
        from tak_tpu_torch.types import ONGOING

        try:
            conn, _ = self.listener.accept()
            conn.settimeout(120)
            rfile = conn.makefile("r", encoding="utf-8", newline="\n")

            def send(s):
                conn.sendall((s + "\n").encode())

            def expect(prefix):
                line = rfile.readline().strip()
                self.received.append(line)
                if not line.startswith(prefix):
                    raise AssertionError(f"expected {prefix!r}, got {line!r}")
                return line

            expect("Login Guest")
            send("Welcome tester!")
            expect(f"Seek {self.n} 600 10 W 4")
            send(f"Game Start {self.no} {self.n} bot vs foe white 600")
            game = Game.with_komi(self.n, 2, device="cpu")
            rng = np.random.default_rng(SEED)
            while True:
                words = expect(f"Game#{self.no} ").split()[1:]
                game.play(wire_to_move(words))      # raises if illegal
                if game.result != ONGOING or game.ply >= BOT_PLIES:
                    break
                time.sleep(BOT_REPLY_S)
                acts = game.legal_actions()
                reply = int(acts[rng.integers(len(acts))])
                game.play_action(reply)
                send(move_to_wire(self.no, game.engine.tables.action_to_move(
                    reply)))
                if game.result != ONGOING:
                    break
            self.plies = game.ply
            send(f"Game#{self.no} Over 0-R")
            conn.close()
        except Exception as e:  # surfaced by the phase
            self.error = e
        finally:
            self.listener.close()


def bot_phase(engine, net6, params6, dev, card):
    """The playtak bot over a local scripted server (127.0.0.1): the
    trained Net6, the `Player` at its defaults (wave 64, K=128, 131,072
    nodes), time_to_think BOT_THINK_S, pondering while the server waits.
    Checks the lines the server received, at least two ponder ticks, the
    analysis PTN and the examples file read back through the port's codec,
    and that #1, #8 and #9 launched.  Rollouts per think, ms per wave."""
    from tak_tpu_torch.examples import ReplayBuffer
    from tak_tpu_torch.kernels import build as kb
    from tak_tpu_torch.playtak.bot import BotConfig, PlaytakBot
    from tak_tpu_torch.playtak.protocol import TcpTransport

    work = Path(tempfile.mkdtemp(prefix="playtak_"))
    thinks, ponders = [], []

    class Bot(PlaytakBot):
        def _new_game(self):
            player = super()._new_game()
            cfg = player.mcts.config
            if (player.mcts.tier != "hbm" or cfg.wave_size != P_WAVE
                    or cfg.max_children != P_K or cfg.max_nodes != P_POOL):
                fail(f"the bot's Player: tier {player.mcts.tier}, {cfg}")
            inner = player.rollout

            def rollout(waves=1):
                t0 = time.perf_counter()
                sims = inner(waves)
                sync()
                (thinks if self._thinking else ponders).append(
                    (sims, time.perf_counter() - t0))
                return sims

            player.rollout = rollout
            return player

        def _choose_move(self, player, last):
            self._thinking = True
            n0 = len(thinks)
            out = super()._choose_move(player, last)
            self._thinking = False
            if out[1]:
                think_counts.append(sum(s for s, _ in thinks[n0:]))
            return out

    think_counts = []
    bot = Bot(engine, net6.policy_eval_states, params6, BotConfig(
        size=N, komi=2, time_to_think=BOT_THINK_S, workdir=str(work)),
        device=dev)
    bot._thinking = False
    server = ScriptedPlaytakServer(N)
    kb.reset_launches()
    transport = TcpTransport(host="127.0.0.1", port=server.port, timeout=0.2)
    t0 = time.perf_counter()
    try:
        bot.run(transport, max_games=1, log=lambda m: log(f"  bot: {m}"))
    finally:
        transport.close()
    wall = time.perf_counter() - t0
    server.thread.join(timeout=60)
    launches = dict(kb.LAUNCHES)
    if server.thread.is_alive() or server.error is not None:
        fail(f"scripted playtak server: {server.error}")
    moves = server.received[3:]
    if server.received[:3] != ["Login Guest", f"Seek {N} 600 10 W 4",
                               "Game#5 P A1"] or len(moves) < 3:
        fail(f"the server received {server.received}")
    if len(ponders) < 2 or not think_counts:
        fail(f"bot: {len(ponders)} ponder ticks, thinks {think_counts}")
    for name in ("fused_step", "descend_wave_hbm", "expand_backup_wave_hbm"):
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched by the bot")
    games = list((work / "_playtak_games").iterdir())
    data = list((work / "_examples").iterdir())
    if len(games) != 1 or len(data) != 1:
        fail(f"bot artifacts: {games}, {data}")
    text = games[0].read_text()
    if '[Player1 "bot"]' not in text or "a1" not in text:
        fail(f"bot analysis PTN:\n{text}")
    buf = ReplayBuffer()
    buf.load(engine, str(data[0]))
    # an example for each searched move, and for each opponent move made
    # while a (pondered) tree stood
    if len(buf) < len(think_counts) or any(
            e.result != (-1.0 if int(e.state["to_move"]) == 0 else 1.0)
            for e in buf.examples):
        fail(f"bot examples: {len(buf)} for {len(think_counts)} searched "
             "moves, or results not the server's 0-R")
    waves = thinks + ponders
    ms_wave = 1e3 * sum(t for _, t in waves) / len(waves)
    out = {"rollouts_per_think": sum(think_counts) / len(think_counts),
           "ms_per_wave": ms_wave, "ponder_ticks": len(ponders)}
    log(f"playtak bot over a scripted local server ({N}x{N}, the trained "
        f"Net6, Player defaults, time_to_think {BOT_THINK_S} s): "
        f"{server.plies} plies in {wall:.2f} s, lines {server.received}; "
        f"rollouts per think {think_counts} (mean "
        f"{out['rollouts_per_think']:,.0f}), {len(ponders)} ponder ticks, "
        f"{ms_wave:.2f} ms per wave; analysis {len(text)} chars, "
        f"{len(buf)} examples read back; launches {launches} on {card}")
    return launches, out


def native_replay_phase(engine, dev, card):
    """NATIVE_GAMES seeded random playouts on the native C++ engine
    (`tak_tpu_torch.native`), their moves replayed through the port's
    batched step on the card (kernel #1): results, plies, reserves and
    boards (heights, tops, every stack level) must be equal."""
    import numpy as np
    import torch

    from tak_tpu_torch import native
    from tak_tpu_torch.kernels import build as kb

    if not native.available():
        fail("the native takcore library does not load or build here")
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    games, seqs = [], []
    for _ in range(NATIVE_GAMES):
        g = native.NativeGame(N)
        seq = []
        while g.result == 0 and len(seq) < NATIVE_MAX_PLIES:
            acts = g.legal_actions()
            a = int(acts[rng.integers(len(acts))])
            g.play_action(a)
            seq.append(a)
        games.append(g)
        seqs.append(seq)
    t_native = time.perf_counter() - t0
    T = max(len(s) for s in seqs)
    acts = np.zeros((NATIVE_GAMES, T), np.int32)
    for i, s in enumerate(seqs):
        acts[i, :len(s)] = s
    lens = torch.as_tensor([len(s) for s in seqs], device=dev)
    acts = torch.as_tensor(acts, device=dev)
    kb.reset_launches()
    sync()
    t0 = time.perf_counter()
    states = engine.initial_batch(NATIVE_GAMES, 0, dev)
    for p in range(T):
        states = engine.step(states, acts[:, p], p < lens)
    sync()
    t_card = time.perf_counter() - t0
    launches = dict(kb.LAUNCHES)
    if launches != {"fused_step": T}:
        fail(f"native replay launched {launches}, want {T} fused steps")
    host = states.to_numpy()
    for i, g in enumerate(games):
        heights, tops, colors = g.board_arrays()
        ok = (int(host["result"][i]) == g.result
              and int(host["ply"][i]) == g.ply
              and (int(host["stones"][i][0]), int(host["caps"][i][0]),
                   int(host["stones"][i][1]), int(host["caps"][i][1]))
              == g.reserves()
              and np.array_equal(host["heights"][i], heights)
              and np.array_equal(host["tops"][i], tops)
              and all((int(host["stacks"][i][s, h // 32]) >> (h % 32)) & 1
                      == colors[s][h] for s in range(N * N)
                      for h in range(heights[s])))
        if not ok:
            fail(f"native replay: game {i} differs after {len(seqs[i])} "
                 "plies")
    results = collections.Counter(g.result for g in games)
    log(f"check native replay: {NATIVE_GAMES} seeded {N}x{N} playouts on the "
        f"native engine ({native.LIB_PATH.parent.name}/"
        f"{native.LIB_PATH.name}; "
        f"{t_native:.2f} s, up to {T} plies, results {dict(results)}) "
        f"replayed through the batched step on the card ({T} launches of "
        f"#1 in {t_card:.3f} s): results, plies, reserves and boards equal "
        f"on {card}")
    return launches


# ---------------------------------------------------------------------------
# The tenth slice: the data-parallel path (`tak_tpu_torch/parallel/`: two
# ranks on the one card over gloo, NCCL at world size 1), the warm-up
# command line and the profiler's trace.
# ---------------------------------------------------------------------------

def pool_search_launches(scfg, moves: int) -> dict:
    """#2-#4 launches of `moves` searched moves on the pool tier: each
    move's search runs ceil(waves / chunk) chunks of `chunk` waves, each a
    descend, chunk - 1 merged backup+descends and a flush."""
    chunk = (-(-scfg.scan_chunk // scfg.wave_size) if scfg.scan_chunk
             else scfg.num_waves)
    chunks = -(-scfg.num_waves // chunk)
    return {"descend_wave": moves * chunks,
            "expand_backup_wave": moves * chunks,
            "backup_descend_wave": moves * chunks * (chunk - 1)}


def recording_actor(engine, eval_fn, dev, moves, mesh, chosen):
    """`make_actor` (on `mesh`'s rank, or one process with None) whose
    chosen moves, every game's, are appended to `chosen`."""
    from tak_tpu_torch.parallel.mesh import gather_rows

    actor = make_actor(engine, eval_fn, dev, moves, mesh=mesh)
    orig = actor.mcts.select_moves

    def select(gen, tree, exploit, mesh=None):
        acts = orig(gen, tree, exploit, mesh)
        chosen.append(gather_rows(mesh, acts).cpu())
        return acts

    actor.mcts.select_moves = select
    return actor


def same_examples(got, want, what):
    if len(got) != len(want):
        fail(f"{what}: {len(got)} examples against {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        import numpy as np

        same = (np.array_equal(g.actions, w.actions)
                and np.array_equal(g.visits, w.visits)
                and g.result == w.result
                and all(np.array_equal(g.state[k], v)
                        for k, v in w.state.items()))
        if not same:
            fail(f"{what}: example {i} differs")


def sharded_rank(rank, out_path):
    """One of two ranks on cuda:0 (gloo): one searched move at the
    reference config with the exact evaluator, its #2-#4 launches from the
    config, rank 0 then the same move in one process (examples and chosen
    moves must be equal); then two moves of the trained Net6, the second
    timed.  Rank 0 writes the numbers to `out_path`."""
    import torch

    from tak_tpu_torch.engine.core import get_engine
    from tak_tpu_torch.graft_entry import exact_eval
    from tak_tpu_torch.kernels import build as kb
    from tak_tpu_torch.model.network import Network
    from tak_tpu_torch.parallel.mesh import barrier, make_mesh
    from tak_tpu_torch.utils.device import setup_performance_defaults

    dev = torch.device("cuda", 0)
    setup_performance_defaults(dev)
    mesh = make_mesh(device=dev)
    engine = get_engine(N)
    exact = exact_eval(engine.num_actions)
    chosen = []
    actor = recording_actor(engine, exact, dev, 1, mesh, chosen)
    kb.reset_launches()
    examples = actor.run(None, seed=SEED, log=lambda m: None)
    sync()
    launches = dict(kb.LAUNCHES)
    want = pool_search_launches(actor.search_config, 1)
    if any(launches.get(k) != v for k, v in want.items()):
        fail(f"sharded move, rank {rank}: launches {launches}, want {want}")
    if rank == 0:
        ref_chosen = []
        ref = recording_actor(engine, exact, dev, 1, None, ref_chosen)
        same_examples(examples, ref.run(None, seed=SEED, log=lambda m: None),
                      "sharded move (exact evaluator) against one process")
        if not all(torch.equal(a, b) for a, b in zip(chosen, ref_chosen)):
            fail("sharded move: chosen moves differ from one process's")
    net = Network(engine, device=dev)
    variables = net.load(NET6_WEIGHTS)
    real = recording_actor(engine, net.policy_eval_states, dev, 2, mesh, [])
    barrier(mesh)
    real.run(variables, seed=SEED, log=lambda m: None)
    sync()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump({"launches": launches, "examples": len(examples),
                       "net6_move_s": [t for t, _ in real.move_times],
                       "sims": real.move_times[-1][1]}, f)


def sharded_phase(card):
    """6o: two ranks on the one card over an explicit gloo group (NCCL
    refuses two ranks on one device): `dryrun_multichip(2, "cuda")` at
    flagship shapes, then `sharded_rank`.  Returns rank 0's launches of
    the exact-evaluator move and the numbers."""
    import torch

    from tak_tpu_torch.graft_entry import dryrun_multichip
    from tak_tpu_torch.parallel.mesh import spawn_local

    torch.cuda.empty_cache()     # the ranks share the card with this process
    t0 = time.perf_counter()
    try:
        dry = dryrun_multichip(2, "cuda", backend="gloo", timeout_s=300)
    except Exception as e:  # a rank's failure, surfaced here
        fail(f"dryrun_multichip(2, 'cuda'): {e}")
    t_dry = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rank0.json")
        t0 = time.perf_counter()
        try:
            spawn_local(sharded_rank, 2, (path,), backend="gloo",
                        timeout_s=300)
        except Exception as e:  # a rank's failure, surfaced here
            fail(f"two ranks on one card: {e}")
        t_move = time.perf_counter() - t0
        with open(path) as f:
            out = json.load(f)
    first, second = out["net6_move_s"]
    out["s_per_move"] = second
    log(f"6o dry run: flagship Net6 (float32) DPLearner step over 2 gloo "
        f"ranks on one card within 4x the row-permutation control (loss "
        f"dev {dry['dp_loss_dev']:.2e} vs {dry['ctl_loss_dev']:.2e}, param "
        f"dev {dry['dp_param_dev']:.2e} vs {dry['ctl_param_dev']:.2e}), the "
        f"sharded move's visits and actions equal one process's "
        f"({t_dry:.1f} s with process start), on {card}")
    log(f"6o sharded self-play, 2 ranks x {GAMES // 2} games on one card "
        f"(gloo): one move with the exact evaluator bitwise equal to one "
        f"process's ({out['examples']} examples, chosen moves equal), "
        f"launches of rank 0 {out['launches']}; the trained Net6: move 1 "
        f"{first:.3f} s (cuDNN autotuning), move 2 {second:.3f} s, "
        f"{GAMES * out['sims'] / second:,.0f} sims/s on a SHARED card (two "
        f"processes time-slice one H100: not a scaling figure); "
        f"{t_move:.1f} s with process start, on {card}")
    return out["launches"], out


def nccl_rank(rank, out_path):
    """NCCL at world size 1 (the code path of a multi-card run): one
    `Network.train` step of the trained Net6 on one chunk (500 seeded
    examples, 4,000 rows) and one searched move, each with the mesh and
    without; the one-rank all-reduce is the identity, so both must be
    equal bit for bit (cuDNN held to deterministic algorithms here)."""
    import numpy as np
    import torch

    from tak_tpu_torch.engine.core import get_engine
    from tak_tpu_torch.kernels import build as kb
    from tak_tpu_torch.model.network import CHUNK_SIZE, Network
    from tak_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda", 0)
    mesh = make_mesh(device=dev)
    if (mesh.backend, mesh.world) != ("nccl", 1):
        fail(f"6p: mesh {mesh.backend} x {mesh.world}")
    engine = get_engine(N)
    net = Network(engine, device=dev)
    variables = net.load(NET6_WEIGHTS)
    examples = seeded_examples(engine, CHUNK_SIZE, np.random.default_rng(1),
                               dev)
    out = {}

    def train(m):
        sync()
        t0 = time.perf_counter()
        new = net.train(variables, examples, rng=np.random.default_rng(2),
                        chunk_size=CHUNK_SIZE, chunks_in_step=1,
                        log=lambda *_: None, mesh=m)
        sync()
        return new, time.perf_counter() - t0

    train(None)                                    # warm-up
    plain, out["train_s"] = train(None)
    sharded, out["train_mesh_s"] = train(mesh)
    for k, v in plain.items():
        if not torch.equal(v, sharded[k]):
            fail(f"6p: Network.train with the NCCL mesh differs at {k}")
    moves = {}
    for key, m in (("plain", None), ("mesh", mesh)):
        chosen = []
        actor = recording_actor(engine, net.policy_eval_states, dev, 1, m,
                                chosen)
        kb.reset_launches()
        moves[key] = (actor.run(variables, seed=SEED, log=lambda *_: None),
                      chosen, dict(kb.LAUNCHES), actor.move_times[0][0])
    same_examples(moves["mesh"][0], moves["plain"][0],
                  "6p: the move with the NCCL mesh against without")
    if not all(torch.equal(a, b) for a, b in zip(moves["mesh"][1],
                                                 moves["plain"][1])):
        fail("6p: chosen moves differ with the NCCL mesh")
    want = pool_search_launches(actor.search_config, 1)
    if any(moves["mesh"][2].get(k) != v for k, v in want.items()):
        fail(f"6p: launches {moves['mesh'][2]}, want {want}")
    out.update(launches=moves["mesh"][2], move_s=moves["plain"][3],
               move_mesh_s=moves["mesh"][3])
    with open(out_path, "w") as f:
        json.dump(out, f)


def nccl_phase(card):
    """6p: `nccl_rank` in a subprocess of its own (world size 1)."""
    from tak_tpu_torch.parallel.mesh import spawn_local

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rank0.json")
        t0 = time.perf_counter()
        try:
            spawn_local(nccl_rank, 1, (path,), backend="nccl", timeout_s=300)
        except Exception as e:  # the rank's failure, surfaced here
            fail(f"NCCL at world size 1: {e}")
        wall = time.perf_counter() - t0
        with open(path) as f:
            out = json.load(f)
    log(f"6p NCCL at world size 1: Network.train of the trained Net6 on one "
        f"chunk (500 examples, 4,000 rows, one step) "
        f"{1e3 * out['train_s']:.1f} ms without the mesh, {1e3 * out['train_mesh_s']:.1f} ms with it, "
        f"bitwise equal; one searched move {out['move_s']:.3f} s without, "
        f"{out['move_mesh_s']:.3f} s with, examples and chosen moves bitwise "
        f"equal, launches {out['launches']} (cuDNN deterministic; "
        f"{wall:.1f} s with process start), on {card}")
    return out["launches"], out


WARMUP_STAGES = ("build kernels", "masked_step", "wins_in_one", "legal_mask",
                 "init_batch", "prepare_root", "add_noise",
                 "run_sims (the big one)", "select_moves", "move_bundle",
                 "tree_reset", "env_reset", "train chunk (500)",
                 "optimizer step", "pit init (H=64)", "pit prepare_root",
                 "pit run_sims", "pit select_moves", "pit step", "total")


def warmup_trace_phase(here, engine, eval_fn, params, dev, card):
    """6q: `python -m tak_tpu_torch.cli.warmup` at the reference self-play
    config, Net6 and the pit at its defaults, every stage name printed;
    then `utils.profiling.trace` around one self-play move, whose Chrome
    trace must name the pool-tier kernels (#2 and #4 share
    `backup_descend_kernel`, #3 is `expand_backup_kernel`).  Returns the
    stage times and the trace's kernel counts."""
    import re

    from tak_tpu_torch.kernels import build as kb
    from tak_tpu_torch.utils.profiling import trace

    t0 = time.perf_counter()
    out = run_entry(["-m", "tak_tpu_torch.cli.warmup", "--size", str(N),
                     "--workers", str(GAMES), "--rollouts", str(SIMS),
                     "--wave", str(WAVE), "--k", str(K)], here, timeout=400)
    wall = time.perf_counter() - t0
    stages = {}
    for line in out.splitlines():
        m = re.match(r"\[warmup\] (.+?):? ([0-9.]+)s$", line)
        if m:
            stages[m.group(1)] = float(m.group(2))
    missing = [s for s in WARMUP_STAGES if s not in stages]
    if missing:
        fail(f"cli.warmup printed no {missing}:\n{out[-3000:]}")
    log(f"6q cli.warmup at the reference config (Net6, pit at its "
        f"defaults): " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
        + f"; {wall:.1f} s with process start, on {card}")

    actor = make_actor(engine, eval_fn, dev, 1)
    kb.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp, log=lambda *_: None):
            actor.run(params, seed=SEED, log=lambda m: None)
        with open(os.path.join(tmp, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    kernels = collections.Counter()
    for e in events:
        if e.get("cat") == "kernel":
            for sym in ("backup_descend_kernel", "expand_backup_kernel",
                        "fused_step_kernel"):
                if e.get("name", "").startswith(sym):
                    kernels[sym] += 1
    launched = dict(kb.LAUNCHES)
    want = {"backup_descend_kernel": launched.get("backup_descend_wave", 0)
            + launched.get("descend_wave", 0),
            "expand_backup_kernel": launched.get("expand_backup_wave", 0)}
    if any(kernels[k] == 0 or v == 0 for k, v in want.items()):
        fail(f"6q trace: kernel events {dict(kernels)}, launches {launched}")
    log(f"6q trace of one self-play move: {len(events)} events, kernel "
        f"events {dict(kernels)} against launches {want} of #2/#4 and #3, "
        f"on {card}")
    return stages, dict(kernels)


# ---------------------------------------------------------------------------
# The eleventh slice: the search-strength guardrails (`tak_tpu_torch/tools/`):
# the root-policy quality probe and the paired-opening strength A/B.
# ---------------------------------------------------------------------------

def probe_policy_checks(engine, mcts, tree, states, policy, what):
    """A probe side's searched roots: each row of `policy` sums to 1 within
    1e-9 (all zero for a game the random opening finished), is zero off
    `Engine.legal_mask`, and the root's edge visits add up to what the root
    holds (`n0` less `prepare_root`'s own visit: every wave the search ran,
    whole chunks included)."""
    import numpy as np

    from tak_tpu_torch.mcts.tree import root_visit_counts
    from tak_tpu_torch.types import ONGOING

    cfg = mcts.config
    chunk = cfg.num_waves
    if cfg.scan_chunk:
        chunk = min(chunk, -(-cfg.scan_chunk // cfg.wave_size))
    sims = -(-cfg.num_waves // chunk) * chunk * cfg.wave_size
    ongoing = (states.result == ONGOING).cpu().numpy()
    legal = engine.legal_mask(states).cpu().numpy()
    sums = policy.sum(-1)
    if not np.all(np.where(ongoing, np.abs(sums - 1.0) <= 1e-9,
                           sums == 0.0)):
        fail(f"{what}: policy sums {sums.tolist()}")
    if np.any(policy[~legal] != 0.0):
        fail(f"{what}: visits off the legal mask")
    visits = root_visit_counts(tree).sum(-1)
    if not (bool((visits == tree.root_n.sum(-1)).all())
            and bool((visits == tree.n0 - 1).all())
            and np.all((tree.n0 - 1).cpu().numpy()[ongoing] == sims)):
        fail(f"{what}: root visits {visits.tolist()}, root holds "
             f"{tree.n0.tolist()}, {sims} sims searched")
    return sims


def quality_phase(here, dev, card):
    """6r: `tools.quality_recycle`'s computation at its defaults: 8 random
    6x6 positions 24 plies deep, Net6 on seed-0 weights in bf16, 10,000
    sims at wave 16 on each side: the recycled 1,280-node pool at K=32 in
    chunks of 512 sims (#1, #2-#4) against the large-tree tier at K=128
    with a 20,002-node budget (#1, #8/#9).  Checks each side's policies
    (`probe_policy_checks`) and launch counts, then holds #2-#4
    (`captured_pool_phase`) and #8/#9 (`check_hbm_on_tree`) bitwise and
    times them on each side's searched tree; then `python -m
    tak_tpu_torch.tools.quality_k` at its defaults on the card.  Returns
    (the path's launches, the pool-tier shape of `captured_pool_phase`,
    the large-tier times, numbers)."""
    import torch

    from tak_tpu_torch.engine.core import get_engine
    from tak_tpu_torch.kernels import build as kb
    from tak_tpu_torch.model.network import Network
    from tak_tpu_torch.tools import quality

    engine = get_engine(N)
    net = Network(engine, device=dev)
    params = net.init_variables(0)
    states = quality.random_midgame_states(
        engine, Q_GAMES, Q_PLIES,
        torch.Generator().manual_seed(quality.POSITIONS_SEED), dev)
    sides = {
        "pool": dict(k=Q_K, budget=Q_POOL, recycle=True, backend="pallas",
                     chunk=Q_CHUNK),
        "hbm": dict(k=Q_REF_K, budget=2 * Q_SIMS + 2, backend="pallas_hbm"),
    }
    kb.reset_launches()
    searched, policies, seconds, launches = {}, {}, {}, {}
    for side, kw in sides.items():
        before = dict(kb.LAUNCHES)
        sync()
        t0 = time.perf_counter()
        mcts, tree = quality.search(engine, net.policy_eval_states, params,
                                    states, Q_SIMS, Q_WAVE, **kw)
        policies[side] = quality.normalized_visits(tree)
        seconds[side] = time.perf_counter() - t0
        launches[side] = launches_since(before)
        sims = probe_policy_checks(engine, mcts, tree, states,
                                   policies[side], f"6r {side} side")
        searched[side] = (mcts, tree, sims)
    path_launches = dict(kb.LAUNCHES)
    for side, on, off in (("pool", POOL_TIER, HBM_TIER),
                          ("hbm", HBM_TIER, POOL_TIER)):
        got = launches[side]
        if (any(got.get(k, 0) <= 0 for k in on + ("fused_step",))
                or any(got.get(k, 0) != 0 for k in off)):
            fail(f"6r {side} side launches {got}")
    tv_mean, tv_max, top1 = quality.tv_top1(policies["hbm"],
                                            policies["pool"])
    out = {"tv_mean": tv_mean, "tv_max": tv_max, "top1": top1,
           "pool_s": seconds["pool"], "hbm_s": seconds["hbm"]}
    log(f"6r quality probe (quality_recycle at its defaults: {Q_GAMES} "
        f"positions at ply {Q_PLIES}, Net6 seed-0 weights): recycled pool "
        f"{Q_POOL} K={Q_K} wave {Q_WAVE} ({searched['pool'][2]} sims run) "
        f"{seconds['pool']:.2f} s vs pallas_hbm K={Q_REF_K} "
        f"({searched['hbm'][2]} sims) {seconds['hbm']:.2f} s: TV mean "
        f"{tv_mean:.4f} max {tv_max:.4f}, top-1 agreement {top1:.3f}; "
        f"launches pool side {launches['pool']}, large-tree side "
        f"{launches['hbm']}; policies sum to 1, legal, root visits "
        f"conserved, on {card}")

    mcts, tree, _ = searched["pool"]
    shape = captured_pool_phase(mcts, params, tree,
                                "quality probe's pool side", card)
    mcts, tree, _ = searched["hbm"]
    hbm = check_hbm_on_tree(mcts, params, tree,
                            "the quality probe's large-tree side", card)
    del searched

    t0 = time.perf_counter()
    text = run_entry(["-m", "tak_tpu_torch.tools.quality_k"], here,
                     timeout=400)
    out["quality_k_s"] = time.perf_counter() - t0
    lines = text.splitlines()
    if not (len(lines) == 3 and lines[1].startswith("  TV distance: mean")
            and lines[2].startswith("  top-1 agreement: ")):
        fail(f"quality_k printed:\n{text[-3000:]}")
    log(f"6r quality_k at its defaults on the card ({out['quality_k_s']:.1f}"
        f" s with process start): " + " | ".join(x.strip() for x in lines))
    return path_launches, shape, hbm, out


def peak_rss_mib(who) -> float:
    import resource

    return resource.getrusage(who).ru_maxrss / 1024.0


def strength_phase(here, card):
    """6s: `tools.strength_ab` on the trained Net6: in process, preset
    `recycle` (the recycled 1,280-node pool at K=32 against the large-tree
    tier at K=128), AB_GAMES games, AB_SIMS sims, cut to AB_PLIES plies;
    checks the record against the reference's keys, the game count and
    `wilson_ci`, and both tiers' launches.  Then `--subprocess-rounds`
    over two rounds of AB_SUB_GAMES games cut to AB_SUB_PLIES plies as a
    subprocess: two lines, the printed total their sum.  Prints the peak
    RSS of this process before and after, and of the children.  Returns
    (the in-process run's launches, numbers)."""
    import re
    import resource

    from tak_tpu_torch.kernels import build as kb
    from tak_tpu_torch.tools import strength_ab

    keys = {"preset", "size", "sims", "sims_b", "games", "seed", "model",
            "max_plies", "wins", "losses", "draws", "unfinished",
            "win_rate", "ci95", "seconds"}
    rss_before = peak_rss_mib(resource.RUSAGE_SELF)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ab.jsonl")
        kb.reset_launches()
        sync()
        t0 = time.perf_counter()
        record = strength_ab.main([
            "--preset", "recycle", "--games", str(AB_GAMES), "--sims",
            str(AB_SIMS), "--max-plies", str(AB_PLIES), "--model",
            NET6_WEIGHTS, "--json-out", path])
        sync()
        wall = time.perf_counter() - t0
        launches = dict(kb.LAUNCHES)
        with open(path) as f:
            written = [json.loads(x) for x in f]
        W, L, D, U = (record[k] for k in ("wins", "losses", "draws",
                                           "unfinished"))
        lo, hi = strength_ab.wilson_ci(W, W + L)
        if not (written == [record] and set(record) == keys
                and W + L + D + U == AB_GAMES
                and record["ci95"] == [round(lo, 4), round(hi, 4)]):
            fail(f"6s record {written} against {record}")
        if any(launches.get(k, 0) <= 0
               for k in POOL_TIER + HBM_TIER + ("fused_step",)):
            fail(f"6s launches {launches}")
        rss_mid = peak_rss_mib(resource.RUSAGE_SELF)

        sub = os.path.join(tmp, "rounds.jsonl")
        t1 = time.perf_counter()
        text = run_entry(["-m", "tak_tpu_torch.tools.strength_ab",
                          "--subprocess-rounds", "--games", str(AB_SUB_GAMES),
                          "--max-games", str(2 * AB_SUB_GAMES),
                          "--max-plies", str(AB_SUB_PLIES), "--sims",
                          str(AB_SIMS), "--model", NET6_WEIGHTS,
                          "--json-out", sub], here, timeout=400)
        sub_wall = time.perf_counter() - t1
        with open(sub) as f:
            rounds = [json.loads(x) for x in f]
    m = re.search(r"subprocess-SPRT total: (\d+)-(\d+)-(\d+)(?:-(\d+)u)?"
                  r"  decision=", text)
    child_rss = [float(x.replace(",", "")) for x in
                 re.findall(r"child peak RSS ([0-9,]+) MiB", text)]
    if not (m and len(rounds) == 2 and len(child_rss) == 2
            and [int(x or 0) for x in m.groups()] == [
                sum(r[k] for r in rounds)
                for k in ("wins", "losses", "draws", "unfinished")]):
        fail(f"6s subprocess rounds: {rounds} against\n{text[-3000:]}")
    plies = AB_PLIES - 4
    out = {"wall_s": wall, "plies_per_s": plies / wall,
           "sub_wall_s": sub_wall, "rss_before_mib": rss_before,
           "rss_after_mib": peak_rss_mib(resource.RUSAGE_SELF),
           "rss_mid_mib": rss_mid, "child_rss_mib": child_rss,
           "children_rss_mib": peak_rss_mib(resource.RUSAGE_CHILDREN)}
    log(f"6s strength A/B in process (preset recycle, trained Net6, "
        f"{AB_GAMES} games, {AB_SIMS} sims, cut: max_plies {AB_PLIES}): "
        f"{W}-{L}-{D}{f'-{U}u' if U else ''}, CI95 {record['ci95']}; "
        f"{plies} searched plies in {wall:.2f} s ({out['plies_per_s']:.2f} "
        f"lockstep plies/s); launches {launches}; then --subprocess-rounds, "
        f"2 rounds of {AB_SUB_GAMES} games cut to {AB_SUB_PLIES} plies: "
        f"{[(r['wins'], r['losses'], r['draws']) for r in rounds]}, "
        f"{sub_wall:.1f} s; peak RSS of this process {rss_before:,.0f} MiB "
        f"before, {rss_mid:,.0f} after the in-process run, "
        f"{out['rss_after_mib']:,.0f} after; the A/B's children "
        f"{', '.join(f'{x:,.0f}' for x in child_rss)} MiB; all children "
        f"of this process {out['children_rss_mib']:,.0f} MiB, on {card}")
    return launches, out


# ---------------------------------------------------------------------------
# The twelfth slice: the port's benchmark program (`tak_tpu_torch/bench.py`)
# and the kernels at its MCTS tier's shape.
# ---------------------------------------------------------------------------

# the repository's bench.py:248-259
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "env_steps_per_s",
              "env_vs_baseline", "device", "config", "selfplay_sims_per_s",
              "selfplay_config"}


def bench_program(here, card):
    """`python -m tak_tpu_torch.bench` at its defaults, as a subprocess:
    its one stdout line has `bench.py`'s keys, names this card and echoes
    the default sizes, and every rate is positive.  Returns (the line as
    printed, parsed)."""
    import torch

    from tak_tpu_torch.bench import BenchConfig

    cfg = BenchConfig()
    t0 = time.perf_counter()
    text = run_entry(["-m", "tak_tpu_torch.bench"], here, timeout=600)
    wall = time.perf_counter() - t0
    lines = text.splitlines()
    if len(lines) != 1:
        fail(f"6t bench printed {len(lines)} lines:\n{text[-3000:]}")
    line = json.loads(lines[0])
    want_config = {"env_batch": cfg.env_batch, "mcts_batch": cfg.mcts_batch,
                   "mcts_sims": cfg.mcts_sims, "wave": cfg.mcts_wave,
                   "k": cfg.mcts_k}
    want_sp = {"workers": cfg.sp_workers, "rollouts": cfg.sp_sims,
               "recycle": True, "wave": cfg.sp_wave}
    rates = [line.get(k) for k in ("value", "env_steps_per_s",
                                   "selfplay_sims_per_s")]
    if not (set(line) == BENCH_KEYS
            and line["device"] == torch.cuda.get_device_name(0)
            and line["metric"] == f"mcts_sims_per_s_{N}x{N}"
            and line["config"] == want_config
            and line["selfplay_config"] == want_sp
            and all(isinstance(r, int) and r > 0 for r in rates)):
        fail(f"6t bench line malformed: {lines[0]}")
    log(f"6t bench program at its defaults ({wall:.1f} s with process "
        f"start) on {card}: {lines[0]}")
    return lines[0], line


def bench_phase(here, engine, eval_fn, params, dev, card):
    """6t: the port's benchmark program, then its MCTS tier's kernels at
    full width.  The program at its defaults (`bench_program`); the MCTS
    tier in process from launch counts of 0, its #1-#4 launches those of
    its 4 searches, every tree holding its sims; then the tier's tree
    (512 games, V=32, K=32, M=514, no recycling) grown by 8 of its 16
    pipelined waves: #2, #4 and #3 bitwise against their plain versions
    and timed beside bound and chain floor, and #1 bitwise and timed on
    that wave's 16,384 leaf rows, gathered as the search gathers them.
    Returns (the tier's launches, its shape label, {kernel: (ms, plain
    ms, bound ms, bound by)} with #1's, {kernel: chain floor ms}, numbers,
    (the MCTS, its roots) for `--profile`)."""
    from tak_tpu_torch import bench
    from tak_tpu_torch.kernels import build as kb
    from tak_tpu_torch.mcts.search import MCTS

    printed, line = bench_program(here, card)
    cfg = bench.BenchConfig()
    scfg = bench.mcts_config(cfg.mcts_sims, cfg.mcts_wave, cfg.mcts_k)
    searches = bench.MCTS_REPS + 1
    sync()
    kb.reset_launches()
    rate, trees = bench.mcts_tier(engine, eval_fn, params, dev,
                                  cfg.mcts_batch, cfg.mcts_sims,
                                  cfg.mcts_wave, cfg.mcts_k)
    sync()
    launches = dict(kb.LAUNCHES)
    # a fused step a wave, and the two that make the roots
    want = {**pool_search_launches(scfg, searches),
            "fused_step": searches * scfg.num_waves + 2}
    if launches != want:
        fail(f"6t MCTS tier launches {launches}, expected {want}")
    sims = scfg.num_waves * scfg.wave_size
    for i, tree in enumerate(trees):
        if not (bool((tree.n0 == sims + 1).all())
                and bool((tree.root_n.sum(1) == sims).all())
                and bool((tree.next_free <= scfg.max_nodes).all())):
            fail(f"6t MCTS tier tree {i}: n0 {tree.n0.unique().tolist()}, "
                 f"root visits {tree.root_n.sum(1).unique().tolist()}")
    nodes = int(trees[0].next_free.float().mean())
    del trees
    log(f"6t MCTS tier in process: {rate:,.0f} sims/s over "
        f"{bench.MCTS_REPS} searches of {cfg.mcts_batch} games x {sims} "
        f"sims; every root holds {sims + 1} visits, {nodes} nodes a tree "
        f"on average; launches {launches} on {card}")

    mcts = MCTS(engine, eval_fn, scfg)
    if mcts.tier != "pool" or scfg.recycle or scfg.max_nodes != 514:
        fail(f"6t MCTS tier: tier {mcts.tier}, config {scfg}")
    roots = bench.mcts_roots(engine, cfg.mcts_batch, dev)
    tree = mcts.prepare_root(params, mcts.init_batch(roots))
    waves = scfg.num_waves // 2
    pending = grow_pipelined(mcts, params, tree, waves)
    B, M, Kk = tree.edge_n.shape
    label = (f"bench MCTS tier, B={B} K={Kk} M={M} V={scfg.wave_size} "
             f"A={engine.num_actions}")
    times, floors, rows = check_pool_at(
        "6t", mcts, params, tree, pending,
        f"{label} (no recycling; {waves} of {scfg.num_waves} pipelined "
        f"waves, {int(tree.next_free.float().mean())} nodes a tree on "
        "average)", card)
    if rows != B * scfg.wave_size:
        fail(f"6t fused_step: {rows} rows, expected {B * scfg.wave_size}")
    out = {"line": printed, "rows": rows, "mcts_rate": rate, "env_rate":
           line["env_steps_per_s"], "bench_mcts_rate": line["value"],
           "sp_rate": line["selfplay_sims_per_s"]}
    return launches, label, times, floors, out, (mcts, roots)


# ---------------------------------------------------------------------------
# The thirteenth slice: the profiling harnesses (`tak_tpu_torch/tools/
# profile_*.py`, `diag_bn_mismatch.py`) and the kernels at their shapes.
# ---------------------------------------------------------------------------

# the harnesses run in process with these knobs (the environment each
# `main` reads); {} is the defaults
U_RUNS = (
    ("profile_kernels", [], {}),
    ("profile_wave", [], {}),
    ("profile_wave", [], {"BENCH_RECYCLE": "1"}),
    ("profile_ab", [], {"BENCH_AB": "topk"}),
    ("profile_ab", [], {"BENCH_AB": "fused-legal"}),
    ("profile_hbm", [], {}),
    ("profile_micro", [], {}),
    ("profile_topk", [], {}),
    ("profile_topk2", [], {}),
    ("profile_topk3", [], {}),
    ("profile_nn", [], {}),
    ("profile_selfplay", [], {"SP_SIMS": "2048", "SP_MOVES": "2"}),
    ("profile_move_phases", [], {"REPS": "1"}),
    ("profile_recycle_grid", [], {"GRID": "[(1280,16,512)]",
                                  "SP_SIMS": "2048"}),
)
# diag_bn_mismatch runs through its `run`, the function its `main` calls
# after parsing flags, at `--games 2 --sims 64` with its pits cut from
# 200 plies to U_DIAG["max_plies"] (its only cut: a drawn pit plays all
# of them)
U_DIAG = {"games": 2, "sims": 64, "max_plies": 24}
U_EXAMPLES = 1000              # the diag workdir's seeded 6x6 examples
# profile_nn: the 9-shift and im2col towers against cuDNN's, as a share of
# the cuDNN policy's largest magnitude.  Each of the 34 layers rounds to
# bf16 (2^-8 relative) after float32 sums taken in another order, and a
# flipped rounding grows through the residual stack: on the H100 at the
# default 4,096 rows the shares are 1.55% (9 shifts) and 1.29% (im2col),
# on the CPU at 8 and 64 rows 1.1-1.2%.  The bound is twice the largest;
# a wrong layout or shift gives shares near 1.
NN_REL_BOUND = 2.0 ** -5


def run_tool(name, call):
    """call(the module `tak_tpu_torch.tools.<name>`) in this process on the
    card, its output captured; fatal if it raises.  Returns (its return
    value, its printed lines, wall seconds)."""
    import importlib
    import io

    tool = importlib.import_module(f"tak_tpu_torch.tools.{name}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = call(tool)
    except Exception as e:  # surfaced with the tool's own lines
        fail(f"6u {name} raised {type(e).__name__}: {e}\n"
             f"{buf.getvalue()[-3000:]}")
    sync()
    return out, buf.getvalue().splitlines(), time.perf_counter() - t0


def timing_values(name, lines):
    """Every time and rate on the tool's lines; fatal unless there is one
    and each parses to a finite positive number."""
    import re

    found = []
    for line in lines:
        for m in re.finditer(r"(-?[\d,]+(?:\.\d+)?)(k?) (ms|sims/s)\b", line):
            x = float(m.group(1).replace(",", ""))
            if not (math.isfinite(x) and x > 0):
                fail(f"6u {name}: {m.group(0)!r} is not a finite positive "
                     f"time or rate in {line!r}")
            found.append(x)
    if not found:
        fail(f"6u {name} printed no timing line:\n" + "\n".join(lines))
    return found


def check_topk_strategies(dev):
    """The exact top-K strategies of the harnesses equal `torch.topk` on
    the card, at the harnesses' inputs: profile_topk's exact and compact
    top-K on its 4,096 masked rows, profile_topk3's two-stage (c = 2, 4,
    8, 18) and sorted-block top-K on its uniform rows."""
    import numpy as np
    import torch

    from tak_tpu_torch.tools import profile_topk, profile_topk3

    policy, legal = profile_topk.inputs(np.random.default_rng(0))
    p = torch.as_tensor(policy, device=dev)
    m = torch.as_tensor(legal, device=dev)
    want = torch.topk(torch.where(m, p, torch.full_like(p, -1.0)),
                      profile_topk.K)
    x = torch.as_tensor(np.random.default_rng(0).random(
        (4096, profile_topk3.A), np.float32), device=dev)
    want3 = torch.topk(x, 64)
    runs = [("profile_topk exact f32", profile_topk.exact_topk(m, p), want),
            ("profile_topk compact+small topk",
             profile_topk.compact_topk(m, p), want)]
    runs += [(f"profile_topk3 two-stage c={c}",
              profile_topk3.two_stage(x, c, 64), want3) for c in (2, 4, 8, 18)]
    runs.append(("profile_topk3 sort128 blocks",
                 profile_topk3.sorted_blocks(x, 64), want3))
    for what, (v, i), (wv, wi) in runs:
        if not (bool((v == wv).all()) and bool((i.long() == wi).all())):
            fail(f"6u {what}: values or ids differ from torch.topk in "
                 f"{int((v != wv).sum())} / {int((i.long() != wi).sum())} "
                 "entries")
    return len(runs)


def diag_workdir(engine, rng, dev, root):
    """A 6x6 checkpoint for `diag_bn_mismatch`, as a training run leaves
    one: the trained Net6 and U_EXAMPLES seeded examples, written by the
    port's `save_training_run` as generation 1."""
    from tak_tpu_torch.examples import ReplayBuffer
    from tak_tpu_torch.model.network import Network
    from tak_tpu_torch.train_loop import save_training_run

    buffer = ReplayBuffer()
    buffer.extend(seeded_examples(engine, U_EXAMPLES, rng, dev))
    variables = Network(engine, device=dev).load(NET6_WEIGHTS)
    save_training_run(engine, variables, buffer, root, 1)
    return root


def check_pool_at(phase, mcts, params, tree, pending, label, card):
    """#2, #4 and #3 bitwise against their plain versions on `tree` and its
    pending wave, timed beside bound and chain floor; then #1 on the
    merged wave's leaf rows, as `_leaf_states_of` gathers them, bitwise
    and timed.  Returns ({kernel: (ms, plain ms, bound ms, bound by)} with
    #1's, {kernel: chain floor ms}, the leaf rows)."""
    from tak_tpu_torch.engine.fused_env import fused_step, step_plain

    checks = hold_pool_kernels(mcts, tree, pending, f"at the {label}")
    times, floors, chase = time_pool_kernels(mcts, tree, pending, checks)
    pool_line = pool_times_line(times, floors)
    after, _, _, leaves = checks["backup_descend_wave"]
    parents, acts, live = mcts._leaf_step_inputs(after, leaves)
    parents = parents.map(lambda x: x.contiguous())
    acts, live = acts.contiguous(), live.contiguous()
    rows = acts.shape[0]
    got = fused_step(mcts.engine, parents, acts, live)
    want = step_plain(mcts.engine, parents, acts, live)
    sync()
    compare_states(got, want,
                   f"{phase} fused_step on {rows} leaf rows ({label})")
    stepped = int((got.ply != parents.ply).sum())
    if stepped == 0:
        fail(f"{phase} fused_step ({label}): no leaf row was stepped")
    del got, want
    times["fused_step"] = (
        launch_ms(lambda: fused_step(mcts.engine, parents, acts, live)),
        cuda_ms(lambda _: step_plain(mcts.engine, parents, acts, live), 2),
        *bound(*fused_step_work(parents, rows)))
    log(f"{phase} check and time pool tier at the {label}: #2, #4 and #3 "
        f"bitwise equal to the plain versions; {pool_line}; {chase}; #1 on "
        f"the merged wave's {rows} leaf rows bitwise equal ({stepped} "
        f"stepped), {times['fused_step'][0]:.4f} ms (plain "
        f"{times['fused_step'][1]:.3f} ms, bound "
        f"{times['fused_step'][2]:.6f} ms by {times['fused_step'][3]}) on "
        f"{card}")
    return times, floors, rows


def profiling_kernels_phase(engine, eval_fn, params, dev, card):
    """The kernels at the harnesses' shapes, bitwise against their plain
    versions and timed: #2-#4 and #1 at profile_kernels' and profile_wave's
    B=256, V=16, K=64 on 514 nodes (no recycling) after 16 of the search's
    32 waves, and on a recycled 1,280-node pool filled by three searches
    (BENCH_RECYCLE=1's pool, full); #8/#9 (with #1, #5 and the pool-tier kernels on the
    same tree) at profile_hbm's B=32, V=8, K=96, M=20,002 after its 8
    waves, and at profile_selfplay's default tree (B=32, V=16, K=128,
    M=20,002: the large-tree tier) after 40 waves.  Returns {shape label:
    times} for `other_shapes`."""
    from tak_tpu_torch.mcts.search import MCTS, SearchConfig
    from tak_tpu_torch.selfplay import SelfPlayActor, SelfPlayConfig
    from tak_tpu_torch.bench import mcts_roots

    pool_shapes, hbm_shapes = {}, {}
    start = mcts_roots(engine, 256, dev)
    for recycle in (False, True):
        cfg = SearchConfig(num_sims=512, wave_size=16, max_children=64,
                           recycle=recycle,
                           node_budget=1280 if recycle else None)
        mcts = MCTS(engine, eval_fn, cfg)
        tree = mcts.prepare_root(params, mcts.init_batch(start))
        if recycle:
            # one search of 512 sims fills 513 nodes: search until full
            for _ in range(3):
                mcts.run_sims(params, tree)
            pending = grow_pipelined(mcts, params, tree, 2)
            if not bool((tree.next_free == cfg.max_nodes).all()):
                fail(f"6u recycled pool not full: {tree.next_free.max()}")
            label = (f"profile_wave BENCH_RECYCLE=1, B=256 K=64 M=1280 "
                     f"V=16 (full, recycling) A={engine.num_actions}")
        else:
            pending = grow_pipelined(mcts, params, tree, cfg.num_waves // 2)
            label = (f"profile_kernels/profile_wave, B=256 K=64 "
                     f"M={cfg.max_nodes} V=16 A={engine.num_actions}, "
                     f"{cfg.num_waves // 2} of {cfg.num_waves} waves")
        if mcts.tier != "pool":
            fail(f"6u {label}: tier {mcts.tier}")
        pool_shapes[label] = check_pool_at("6u", mcts, params, tree,
                                           pending, label, card)[:2]
        del tree, pending

    hbm_cfg = SearchConfig(num_sims=64, wave_size=8, max_children=96,
                           node_budget=20002, backend="pallas_hbm")
    sp = SelfPlayActor(engine, eval_fn, SelfPlayConfig(
        workers=32, search=SearchConfig(num_sims=10000, wave_size=16,
                                        max_children=128)), device=dev)
    start = mcts_roots(engine, 32, dev)
    for mcts, waves, label in (
            (MCTS(engine, eval_fn, hbm_cfg), hbm_cfg.num_waves,
             "profile_hbm, B=32 K=96 M=20002 V=8"),
            (sp.mcts, 40, "profile_selfplay's default tree, B=32 K=128 "
             "M=20002 V=16, 40 waves")):
        if mcts.tier != "hbm" or mcts.config.max_nodes != 20002:
            fail(f"6u {label}: tier {mcts.tier}, {mcts.config}")
        tree = mcts.prepare_root(params, mcts.init_batch(start))
        for _ in range(waves):
            mcts._wave_hbm(params, tree)
        hbm_shapes[label] = check_hbm_on_tree(mcts, params, tree,
                                              f"6u {label}", card)
        del tree
    return pool_shapes, hbm_shapes


def profiling_phase(engine, eval_fn, params, dev, card, rng):
    """6u: the profiling harnesses on the card.  Each tool's `main` runs in
    this process (U_RUNS: the defaults, or smaller knobs where the default
    run takes minutes), then `diag_bn_mismatch.run` (U_DIAG) on a
    checkpoint written here, their lines captured: every time and rate of a profiling tool must parse
    finite and positive, profile_nn's matmul towers must agree with the
    cuDNN tower within NN_REL_BOUND of its largest policy magnitude,
    profile_topk3's spot check must hold, and the exact top-K strategies
    must equal `torch.topk` here.  The tools run from launch counts of 0:
    #1-#5, #8 and #9 must each have launched.  Then the kernels at the
    harnesses' shapes (`profiling_kernels_phase`).  Returns (the tools'
    launches, {tool run: (wall s, lines)}, the shapes' times)."""
    import torch

    from tak_tpu_torch.kernels import build as kb
    from tak_tpu_torch.model.network import Network

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        workdir = diag_workdir(engine, rng, dev, root)
        net = Network(engine, device=dev)
        sync()
        kb.reset_launches()
        summary = {}
        runs = [(name, name + "".join(f" {k}={v}" for k, v in env.items()),
                 lambda tool, argv=argv, env=env: tool.main(argv, env))
                for name, argv, env in U_RUNS]
        runs.append(("diag_bn_mismatch", "diag_bn_mismatch " + " ".join(
            f"{k}={v}" for k, v in U_DIAG.items()),
            lambda tool: tool.run(engine, net, workdir, device=dev,
                                  log=lambda m: print(m, flush=True),
                                  **U_DIAG)))
        for name, key, call in runs:
            out, lines, wall = run_tool(name, call)
            # diag_bn_mismatch prints no timing line, as the JAX script
            values = ([] if name == "diag_bn_mismatch"
                      else timing_values(name, lines))
            summary[key] = (wall, lines)
            note = ""
            if name == "profile_nn":
                shares = {d: out[d] / out["max_abs_policy"]
                          for d in ("d_mm", "d_im2col")}
                note = (f"; of the cuDNN policy's largest magnitude "
                        f"{out['max_abs_policy']:.4f}: d_mm "
                        f"{shares['d_mm']:.6f}, d_im2col "
                        f"{shares['d_im2col']:.6f} (bound {NN_REL_BOUND})")
                summary[key] = (wall, lines + [note[2:]])
                for d, share in shares.items():
                    if not share <= NN_REL_BOUND:
                        fail(f"6u profile_nn: {d} {out[d]} is {share:.6f} "
                             f"of {out['max_abs_policy']}, above "
                             f"{NN_REL_BOUND}")
            if name == "profile_topk3" and out["match"] is not True:
                fail("6u profile_topk3: two-stage c=8 values differ")
            if name == "diag_bn_mismatch" and not (
                    out["examples"] == U_EXAMPLES and out["generation"] == 1
                    and len(out["results"]) == 3):
                fail(f"6u diag_bn_mismatch: {lines}")
            log(f"6u {key}: {len(lines)} lines, {len(values)} times and "
                f"rates, {wall:.1f} s; last: {lines[-1].strip()}{note} on "
                f"{card}")
        sync()
        launches = dict(kb.LAUNCHES)
    tools_s = time.perf_counter() - t0
    for kernel in POOL_TIER + HBM_TIER + ("fused_step", "fused_step_legal"):
        if launches.get(kernel, 0) <= 0:
            fail(f"6u: kernel {kernel} was not launched by the harnesses: "
                 f"{launches}")
    for kernel in ("legal_sampler", "env_rollout"):
        if launches.get(kernel, 0) != 0:
            fail(f"6u: kernel {kernel} launched by the harnesses")
    checked = check_topk_strategies(dev)
    log(f"6u the {len(runs)} harness runs in {tools_s:.1f} s on {card}; "
        f"launches {launches}; {checked} exact top-K strategies equal "
        "torch.topk")
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    shapes = profiling_kernels_phase(engine, eval_fn, params, dev, card)
    log(f"6u kernel checks at the harnesses' shapes in "
        f"{time.perf_counter() - t1:.1f} s")
    return launches, summary, shapes


# ---------------------------------------------------------------------------
# The SE-ResNet at 8x8 (`NetConfig.se_channels`, `csrc/squeeze_excite.cu`;
# the benchmark's `lc0se-20x256-8x8`) and the data-parallel learner over
# four cards.
# ---------------------------------------------------------------------------

SE_N = 8
SE_FILTERS, SE_BLOCKS, SE_CHANNELS = 256, 20, 32
SE_POOL_PLIES = 20             # random plies before the 8x8 pool-tier check
DP_WORLD = 4
DP_EXAMPLES = 4_000            # 8 chunks of 500: two steps of 4 chunks


def se_kernel_phase(dev, card):
    """6v: `tak_se_epilogue` against its plain version (torch ops on the
    card, the same float32 arithmetic in another summation order) at a
    wave's shape (8,192 rows, 8x8 x 256, 32 SE channels) and at odd ones
    (1 and 33 rows; 6x6 x 128 with 16 SE channels, a row that leaves
    threads idle): every output within one bf16 step after a float32
    slack of 2^-14 of its terms |sigmoid(γ) y| + |β| + |x| (`bf16_steps`:
    where they cancel to near 0, the two gates' last bits move the sum by
    many steps of its own small magnitude), at most 0.1% of them off.
    Then timed (`launch_ms`) beside the plain version and the
    byte floor (3 x 2 B x 64 x 256 a row at 3.35 TB/s).  Returns the
    numbers."""
    import numpy as np
    import torch

    from tak_tpu_torch.model.squeeze_excite import (
        se_epilogue_kernel,
        se_epilogue_plain,
    )

    rng = np.random.default_rng(SEED + 6)

    def inputs(rows, n, C, S):
        def t(shape, scale=1.0):
            return torch.as_tensor(scale * rng.standard_normal(shape),
                                   dtype=torch.float32, device=dev)

        y = t((rows, C, n, n)).to(torch.bfloat16)
        x = torch.relu(t((rows, C, n, n))).to(torch.bfloat16)
        y = y.contiguous(memory_format=torch.channels_last)
        x = x.contiguous(memory_format=torch.channels_last)
        return (y, x, t((S, C), C ** -0.5), t((S,), 0.1),
                t((2 * C, S), S ** -0.5), t((2 * C,), 0.1))

    out = {}
    for rows, n, C, S in ((ROWS, SE_N, SE_FILTERS, SE_CHANNELS),
                          (1, SE_N, SE_FILTERS, SE_CHANNELS),
                          (33, SE_N, SE_FILTERS, SE_CHANNELS),
                          (40, 6, 128, 16)):
        args = inputs(rows, n, C, S)
        got = se_epilogue_kernel(*args)
        want = se_epilogue_plain(*args)
        y, x, w1, b1, w2, b2 = args
        yf = y.float()
        e = torch.relu(yf.mean((2, 3)) @ w1.t() + b1) @ w2.t() + b2
        terms = (torch.sigmoid(e[:, :C])[:, :, None, None] * yf.abs()
                 + e[:, C:].abs()[:, :, None, None] + x.float().abs())
        sync()
        steps = bf16_steps(got, want, terms)
        share = float((got != want).float().mean())
        worst = float(steps.max())
        if worst > 1.0 or share > 1e-3:
            fail(f"6v tak_se_epilogue at {rows} rows, {n}x{n} x {C}, S={S}: "
                 f"{share:.2%} of outputs differ, at most {worst:.2f} bf16 "
                 "steps")
        out[(rows, n, C, S)] = (share, worst)
    args = inputs(ROWS, SE_N, SE_FILTERS, SE_CHANNELS)
    ms = launch_ms(lambda: se_epilogue_kernel(*args))
    plain = cuda_ms(lambda _: se_epilogue_plain(*args), 3)
    bound_ms = 1e3 * ROWS * 3 * 2 * SE_N ** 2 * SE_FILTERS / HBM_BYTES_PER_S
    share, worst = out[(ROWS, SE_N, SE_FILTERS, SE_CHANNELS)]
    log(f"6v check tak_se_epilogue against its plain version: {ROWS} rows "
        f"{SE_N}x{SE_N} x {SE_FILTERS}, S={SE_CHANNELS}: {share:.4%} of "
        f"outputs differ, at most {worst:.2f} bf16 steps; also 1, 33 rows and "
        f"6x6 x 128, S=16 ({', '.join(f'{v[0]:.4%}' for v in out.values())})"
        f"; time {ms:.4f} ms, plain {plain:.3f} ms, bound {bound_ms:.4f} ms "
        f"(bytes; {100 * bound_ms / ms:.1f}% of it), on {card}")
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
            "share_differing": share, "max_bf16_steps": worst}


def se8_phase(dev, card):
    """6v: the SE net of `lc0se-20x256-8x8` (seeded random weights) on the
    self-play path: one searched move of 32 games at the reference search
    (10,240 sims, wave 256, K=32, a recycled 1,280-node pool) through
    `SelfPlayActor.run` on the pool tier, every network call launching
    `tak_se_epilogue` once a block; then #2, #4, #3 and #1 bitwise against
    their plain versions at 8x8 (A=65,216) on a tree of 32 random
    mid-game roots grown until the pool is full, timed beside their bound
    and chain floor.  Returns (launches, the kernels' times, numbers)."""
    import numpy as np
    import torch

    from tak_tpu_torch.engine.core import get_engine
    from tak_tpu_torch.kernels import build as kb
    from tak_tpu_torch.mcts.search import MCTS
    from tak_tpu_torch.mcts.tree_kernels import Pending
    from tak_tpu_torch.model.network import Network
    from tak_tpu_torch.model.resnet import NetConfig

    engine = get_engine(SE_N)
    net = Network(engine, NetConfig(n=SE_N, filters=SE_FILTERS,
                                    blocks=SE_BLOCKS,
                                    se_channels=SE_CHANNELS), device=dev)
    params = {k: v.to(dev) for k, v in net.init_variables(SEED).items()}
    eval_fn = net.policy_eval_states
    torch.cuda.reset_peak_memory_stats(dev)
    kb.reset_launches()
    actor = make_actor(engine, eval_fn, dev, 1)
    if actor.mcts.tier != "pool":
        fail(f"6v: the 8x8 search takes the {actor.mcts.tier} tier")
    sync()
    t0 = time.perf_counter()
    examples = actor.run(params, seed=SEED, log=lambda *a, **k: None)
    sync()
    move_s = time.perf_counter() - t0
    launches = dict(kb.LAUNCHES)
    se = launches.get("tak_se_epilogue", 0)
    if se == 0 or se % SE_BLOCKS:
        fail(f"6v: tak_se_epilogue launched {se} times, not a multiple of "
             f"{SE_BLOCKS} blocks")
    for name in POOL_TIER:
        if launches.get(name, 0) <= 0:
            fail(f"6v: kernel {name} was not launched at 8x8")
    if len(examples) != GAMES or any(int(e.visits.sum()) != SIMS
                                     for e in examples):
        fail(f"6v: {len(examples)} examples, visits "
             f"{sorted({int(e.visits.sum()) for e in examples})}")
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"6v one searched 8x8 move of {GAMES} games with the SE net "
        f"({SE_BLOCKS} x {SE_FILTERS}, SE {SE_CHANNELS}; set-up and cuDNN's "
        f"autotuning included) in {move_s:.2f} s, {GAMES * SIMS / move_s:,.0f}"
        f" sims/s, peak memory {peak / 1e9:.2f} GB, launches {launches}, on "
        f"{card}")

    rng = np.random.default_rng(SEED + 8)
    roots = playout_states(engine, GAMES, SE_POOL_PLIES, rng, dev)
    mcts = MCTS(engine, eval_fn, actor.search_config)
    tree = mcts.prepare_root(params, mcts.init_batch(roots))
    M = mcts.config.max_nodes
    pending, waves = Pending.zeros(GAMES, WAVE, K, dev), 0
    while waves < 12 and not (waves >= 2
                              and bool((tree.next_free == M).all())):
        pending = mcts._wave_pipelined(params, tree, pending)
        waves += 1
    sync()
    if not bool((tree.next_free == M).all()):
        fail(f"6v: the 8x8 pool is not full after {waves} waves")
    label = (f"8x8 SE self-play shape, B={GAMES} K={K} M={M} V={WAVE} "
             f"A={engine.num_actions}, {waves} waves")
    times, floors, _ = check_pool_at("6v", mcts, params, tree, pending, label,
                                     card)
    return launches, (label, times, floors), {"move_s": move_s,
                                              "peak_bytes": peak}


def dp4_rank(rank, out_path):
    """One of DP_WORLD ranks over NCCL, on card `rank`: `Network.train` of
    the trained Net6 on DP_EXAMPLES seeded examples (two steps of 4
    chunks of 500) with the mesh; every rank must end with the same
    variables bit for bit.  Rank 0 also trains alone (no mesh) and
    compares the change of every leaf: the same step's math, summed in
    another order."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tak_tpu_torch.engine.core import get_engine
    from tak_tpu_torch.model.network import CHUNK_SIZE, Network
    from tak_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda", rank)
    mesh = make_mesh(device=dev)
    if (mesh.backend, mesh.world) != ("nccl", DP_WORLD):
        fail(f"6w: mesh {mesh.backend} x {mesh.world}")
    engine = get_engine(N)
    net = Network(engine, device=dev)
    variables = {k: v.to(dev) for k, v in net.load(NET6_WEIGHTS).items()}
    examples = seeded_examples(engine, DP_EXAMPLES,
                               np.random.default_rng(1), dev)

    def train(m):
        sync()
        t0 = time.perf_counter()
        new = net.train(variables, examples, rng=np.random.default_rng(2),
                        chunk_size=CHUNK_SIZE, chunks_in_step=4,
                        log=lambda *_: None, mesh=m)
        sync()
        return new, time.perf_counter() - t0

    train(mesh)                                    # cuDNN's autotuning
    sharded, t_mesh = train(mesh)
    digest = torch.tensor([float(sum(v.double().sum() for v in
                                     sharded.values()))], device=dev)
    every = [torch.zeros_like(digest) for _ in range(DP_WORLD)]
    dist.all_gather(every, digest)
    if len({float(d) for d in every}) != 1:
        fail(f"6w: the ranks' variables differ: {[float(d) for d in every]}")
    if rank:
        return
    train(None)
    single, t_one = train(None)
    gaps = []
    for k, v in single.items():
        if not v.is_floating_point() or "running" in k:
            continue
        want = float((v - variables[k]).norm())
        got = float((sharded[k] - variables[k]).norm())
        gaps.append((abs(got - want), want))
    median = float(np.median([w for _, w in gaps]))
    rel = [g / max(w, median) for g, w in gaps]
    with open(out_path, "w") as f:
        json.dump({"train_s": t_one, "train_mesh_s": t_mesh,
                   "worst": max(rel), "median": float(np.median(rel))}, f)


def dp4_phase(card):
    """6w: `dp4_rank` on DP_WORLD cards (skipped, and said so, with fewer):
    the change of every leaf within the benchmark learner's limits of the
    one-process step (worst 0.2, median 0.0042 of the larger of its norm
    and the median leaf's).  Returns the numbers, or None."""
    import torch

    from tak_tpu_torch.parallel.mesh import spawn_local

    cards = torch.cuda.device_count()
    if cards < DP_WORLD:
        log(f"6w skipped: {cards} CUDA device(s), the four-card NCCL step "
            f"needs {DP_WORLD}")
        return None
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rank0.json")
        t0 = time.perf_counter()
        try:
            spawn_local(dp4_rank, DP_WORLD, (path,), backend="nccl",
                        timeout_s=600)
        except Exception as e:  # a rank's failure, surfaced here
            fail(f"6w: {DP_WORLD} NCCL ranks: {e}")
        wall = time.perf_counter() - t0
        with open(path) as f:
            out = json.load(f)
    if out["worst"] > 0.2 or out["median"] > 0.0042:
        fail(f"6w: the {DP_WORLD}-rank step against one process: {out}")
    log(f"6w {DP_WORLD} NCCL ranks, one a card: Network.train of the trained "
        f"Net6 on {DP_EXAMPLES} examples (two steps of 4 chunks of 500) "
        f"{1e3 * out['train_mesh_s']:.1f} ms, one process "
        f"{1e3 * out['train_s']:.1f} ms; every rank's variables bitwise equal;"
        f" the change of each leaf against one process's: worst gap "
        f"{out['worst']:.2e}, median {out['median']:.2e} ({wall:.1f} s with "
        f"process start), on {card}")
    return out


def se_entry(se_times, se_launches, se_shape) -> dict:
    """The `{"kernels": [...]}` entry of the SE epilogue (no TPU kernel),
    and the pool-tier kernels' times at the 8x8 shape."""
    label, times, floors = se_shape
    return {
        "name": "squeeze_excite", "route": "cuda",
        "source": "tak_tpu_torch/csrc/squeeze_excite.cu", "replaces": None,
        "launches": se_launches.get("tak_se_epilogue", 0),
        "launches_by_path": {"selfplay_se8": se_launches.get(
            "tak_se_epilogue", 0)},
        "max_bf16_steps": se_times["max_bf16_steps"],
        "share_differing": se_times["share_differing"],
        "ms": se_times["ms"], "plain_ms": se_times["plain_ms"],
        "bound_ms": se_times["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "other_shapes": {label: {name: dict(zip(
            ("ms", "plain_ms", "bound_ms", "bound_by"), t),
            **({"chain_floor_ms": floors[name]} if name in floors else {}))
            for name, t in times.items()}},
    }


def se_phases(dev, card) -> tuple:
    """6v and 6w: (the SE epilogue's `{"kernels"}` entry, a summary)."""
    se_times = se_kernel_phase(dev, card)
    se_launches, se_shape, se_out = se8_phase(dev, card)
    dp = dp4_phase(card)
    line = (f"8x8 SE net: one 32-game move {se_out['move_s']:.2f} s, peak "
            f"{se_out['peak_bytes'] / 1e9:.2f} GB; tak_se_epilogue "
            f"{se_times['ms']:.4f} ms at {ROWS} rows (bound "
            f"{se_times['bound_ms']:.4f}); four cards: "
            + ("skipped" if dp is None else
               f"median leaf gap {dp['median']:.2e}"))
    return se_entry(se_times, se_launches, se_shape), line


def make_actor(engine, eval_fn, dev, moves, mesh=None, **search_options):
    from tak_tpu_torch.mcts.search import SearchConfig
    from tak_tpu_torch.selfplay import SelfPlayActor, SelfPlayConfig

    cfg = SelfPlayConfig(
        games=GAMES, workers=GAMES, max_plies=2 + moves,
        search=SearchConfig(num_sims=SIMS, wave_size=WAVE, max_children=K,
                            recycle=True, **search_options))
    return SelfPlayActor(engine, eval_fn, cfg, device=dev, mesh=mesh)


def main(do_profile: bool = False, only_se8: bool = False):
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
    if only_se8:
        se_kernel, se_line = se_phases(dev, card)
        log(f"summary on {card}: build {t_build:.1f} s; {se_line}")
        print(json.dumps({"kernels": [se_kernel]}), flush=True)
        print(json.dumps({"se8_ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return

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
        MCTS(engine, eval_fn, p_cfg), params, one_root, 30,
        "the Player's shape: one game, Net6", card)
    peaked = peaked_eval(engine.num_actions)
    hbm_times_8 = check_hbm_kernels(
        MCTS(engine, peaked, p_cfg), None,
        roots[:8].map(lambda x: x.contiguous()), 20,
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
    bn_times = batch_norm_phase(dev, card)
    pit_launches, pit_out, captured = pit_phase(engine, net6, vars6, cand6,
                                                dev, card)
    pit_times, pit_floors = pit_kernels_phase(captured, card)
    t_cli = train_cli_phase(here, card)

    # ---- 6h-6n. the xla and Gumbel search paths, quad rollouts, the dense
    # head, the playtak bot, the native engine -------------------------------
    x1_launches = xla_v1_phase(engine, net6.policy_eval_states, vars6, roots,
                               card)
    x_launches, x_out = xla_selfplay_phase(engine, eval_fn, params, dev, card,
                                           rate)
    g_launches, g_out = gumbel_phase(engine, eval_fn, params, dev, card)
    qd_launches, qd_out, qd_shape = quad_phase(engine, eval_fn, params, dev,
                                               card)
    d_launches, d_out, d_shape = dense_net5_phase(dev, card)
    b_launches, b_out = bot_phase(engine, net6, vars6, dev, card)
    n_launches = native_replay_phase(engine, dev, card)

    # ---- 6o-6q. the data-parallel path, the warm-up, the trace -------------
    s_launches, s_out = sharded_phase(card)
    p_out_launches, nccl_out = nccl_phase(card)
    w_stages, w_kernels = warmup_trace_phase(here, engine, eval_fn, params,
                                             dev, card)

    # ---- 6r-6s. the search-strength guardrails ------------------------------
    q_launches, q_shape, q_hbm, q_out = quality_phase(here, dev, card)
    ab_launches, ab_out = strength_phase(here, card)

    # ---- 6t. the port's benchmark program ----------------------------------
    (bm_launches, bm_label, bm_times, bm_floors, bm_out,
     (bm_mcts, bm_roots)) = bench_phase(here, engine, eval_fn, params, dev,
                                        card)

    # ---- 6u. the profiling harnesses ---------------------------------------
    u_launches, u_summary, (u_pool, u_hbm) = profiling_phase(
        engine, eval_fn, params, dev, card, rng)
    slice13_line = "harnesses: " + "; ".join(
        f"{key} {wall:.1f} s ({lines[-1].strip()})"
        for key, (wall, lines) in u_summary.items())

    # ---- 6v-6w. the SE net at 8x8, the four-card learner -------------------
    se_kernel, se_line = se_phases(dev, card)
    slice12_line = (
        f"bench program: MCTS tier {bm_out['bench_mcts_rate']:,} sims/s, env "
        f"tier {bm_out['env_rate']:,} env steps/s, self-play tier "
        f"{bm_out['sp_rate']:,} sims/s; the MCTS tier in process "
        f"{bm_out['mcts_rate']:,.0f} sims/s")
    slice11_line = (
        f"quality probe at 10,000 sims: pool side {q_out['pool_s']:.2f} s, "
        f"large-tree side {q_out['hbm_s']:.2f} s, TV mean "
        f"{q_out['tv_mean']:.4f}, top-1 {q_out['top1']:.3f}; quality_k "
        f"{q_out['quality_k_s']:.1f} s; strength A/B (8 games, 800 sims, "
        f"{AB_PLIES - 4} plies) {ab_out['wall_s']:.2f} s, {ab_out['plies_per_s']:.2f} "
        f"plies/s; two child rounds {ab_out['sub_wall_s']:.1f} s, their peak "
        f"RSS {', '.join(f'{x:,.0f}' for x in ab_out['child_rss_mib'])} MiB")
    slice10_line = (
        f"2 ranks on one card: Net6 {s_out['s_per_move']:.3f} s a move (a "
        f"shared card, not a scaling figure); NCCL world 1: a Net6 chunk "
        f"step {1e3 * nccl_out['train_mesh_s']:.1f} ms "
        f"({1e3 * nccl_out['train_s']:.1f} without the mesh), a move "
        f"{nccl_out['move_mesh_s']:.3f} s ({nccl_out['move_s']:.3f}); "
        f"cli.warmup total {w_stages['total']:.1f} s (build "
        f"{w_stages['build kernels']:.1f}, run_sims "
        f"{w_stages['run_sims (the big one)']:.2f}, train chunk "
        f"{w_stages['train chunk (500)']:.2f}, pit run_sims "
        f"{w_stages['pit run_sims']:.2f})")
    slice9_line = (
        f"xla path {x_out['sims_per_s']:,.0f} sims/s "
        f"({x_out['ms_per_wave']:.1f} ms per wave, a wave's descents "
        f"{x_out['descent_graph_ms']:.1f} ms as CUDA graphs and "
        f"{x_out['descent_eager_ms']:.1f} ms eager; pool tier "
        f"{x_out['pool_sims_per_s']:,.0f}); gumbel self-play "
        f"{g_out['sims_per_s']:,.0f} sims/s; quad-rollout self-play "
        f"{qd_out['sims_per_s']:,.0f} sims/s; dense Net5 "
        f"{d_out['examples_per_s']:,.0f} examples/s (self-play "
        f"{d_out['sims_per_s']:,.0f} sims/s); bot "
        f"{b_out['rollouts_per_think']:,.0f} rollouts per think, "
        f"{b_out['ms_per_wave']:.2f} ms per wave")
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
        launches, p_launches, f_launches, r_launches, pit_launches,
        x1_launches, x_launches, g_launches, qd_launches, d_launches,
        b_launches, n_launches, s_launches, p_out_launches, q_launches,
        ab_launches, bm_launches, u_launches))))
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
        profile_search(bm_mcts, params, bm_roots, card,
                       f"one bench MCTS-tier search ({bm_label}, 512 sims, "
                       "fresh trees)")
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
                       f"bench MCTS wave, {bm_out['rows']} rows":
                       times(bm_times["fused_step"]),
                       **{f"{label}, leaf rows": times(t["fused_step"])
                          for label, (t, _) in u_pool.items()},
                       **{f"{label}, leaf rows": times(out["fused_step"])
                          for label, out in u_hbm.items()},
                       "launch_floor_ms": floor},
        "fused_step_legal": {f"player wave, {P_WAVE} rows":
                             times(player_times["fused_step_legal"]),
                             **{f"{label}, leaf rows":
                                times(out["fused_step_legal"])
                                for label, out in u_hbm.items()}},
        "legal_sampler": {"given words":
                          times(rollout_times["legal_sampler, given words"])},
        **{name: {"check tree": hbm_times(hbm_check, name),
                  f"player wave {P_WIDE}": hbm_times(wide_times, name),
                  f"quality probe, B={Q_GAMES} K={Q_REF_K} M="
                  f"{2 * Q_SIMS + 2} V={Q_WAVE}": hbm_times(q_hbm, name),
                  **{label: hbm_times(out, name)
                     for label, out in u_hbm.items()}}
           for name in HBM_TIER},
        **{name: {label: {**times(shape_times[name]),
                          "chain_floor_ms": shape_floors[name]}
                  for label, shape_times, shape_floors in (
                      ("pit, B=64 K=128 M=1602 V=16", pit_times, pit_floors),
                      qd_shape, d_shape, q_shape,
                      (bm_label, bm_times, bm_floors),
                      *((label, t, f) for label, (t, f) in u_pool.items()))}
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
    # train-mode BatchNorm: no TPU kernel (flax's nn.BatchNorm is XLA's);
    # one forward and backward at a Net6 chunk's shape, the Net6 learner's
    # launches
    (k_f, k_b), (p_f, p_b) = bn_times["kernel"], bn_times["plain"]
    log(f"time batch_norm: kernels {k_f + k_b:.4f} ms (forward {k_f:.4f}, "
        f"backward {k_b:.4f}), plain {p_f + p_b:.3f} ms, bound "
        f"{sum(bn_times['bound']):.4f} ms (bytes); launches "
        f"{l6['bn_launches']}, on {card}")
    kernels.append({
        "name": "batch_norm", "route": "cuda",
        "source": "tak_tpu_torch/csrc/batch_norm.cu", "replaces": None,
        "launches": sum(l6["bn_launches"].values()),
        "launches_by_path": {"learner_net6": l6["bn_launches"]},
        "max_bf16_steps": max(bn_times["err"]["y_steps"],
                              bn_times["err"]["dx_steps"]),
        "ms": k_f + k_b, "plain_ms": p_f + p_b,
        "bound_ms": sum(bn_times["bound"]), "bound_by": "bytes",
        "library_ms": None,
        "other_shapes": {"forward": {"ms": k_f, "plain_ms": p_f,
                                     "bound_ms": bn_times["bound"][0]},
                         "backward": {"ms": k_b, "plain_ms": p_b,
                                      "bound_ms": bn_times["bound"][1]}},
    })
    # the end-to-end numbers again, next to the result lines
    log(f"summary on {card}: build {t_build:.1f} s; "
        + "; ".join(move_lines)
        + f"; moves 2-{moves}: {rate:,.0f} self-play sims/s; {wins_line}; "
        + f"{options_line}; {r_line}; "
        + "; ".join(p_lines)
        + f"; Player: {p_rate:,.0f} rollouts/s over {P_MOVES} moves; "
        + train_line + "; " + slice9_line + "; " + slice10_line + "; "
        + slice11_line + "; " + slice12_line + "; " + slice13_line + "; "
        + se_line)
    kernels.append(se_kernel)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


if __name__ == "__main__":
    main(do_profile="--profile" in sys.argv[1:],
         only_se8="--se8" in sys.argv[1:])
