#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`tak_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from `tak_tpu_torch/csrc/` (nvcc, in parallel);
  3. hold each kernel against its plain PyTorch version on the card, at the
     main path's shapes, bitwise:
       * fused step on 8,192 rows of varied 6x6 positions (seeded random
         playouts), with disabled rows and finished games;
       * one backup+descend wave (valid=1), one descend wave (valid=0) and
         one expand+backup flush on 32 trees mid-search, with the 1280-node
         pool full so every create recycles a node;
       * the large-tree descend and expand+backup waves at the Player's
         shape (one game, V=64, K=128, a 131,072-node pool, 9,036 actions)
         on a tree of several thousand nodes grown by the plain versions,
         again on 8 deep trees, and on a small pool that runs out inside
         the wave; the pool-tier kernels run on the same trees with
         recycling off, for comparison;
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
     `Game.play` steps);
  6. the entry points as subprocesses: a TEI dialogue over pipes and the
     analysis command line on a short PTN file;
  7. time each kernel (CUDA events) and its plain version at the main
     paths' shapes, with the least time the card could take (bound);
  8. print one `{"kernels": [...]}` line, then the `{"ok": true, ...}` line.
     A kernel's `ms`, `plain_ms` and `bound_ms` are those of its main-path
     shape (the large-tree waves: the Player's own tree); `other_shapes`
     holds its times elsewhere, `launches_by_path` the count of each path.

`--profile` adds, before the last two lines, where one self-play move's
search and one Player wave spend their time (per-stage host timers, then
torch.profiler device time).

Exits non-zero, printing no result, without a CUDA device or without the
`tak_tpu_torch` package beside this file.
"""

from __future__ import annotations

import collections
import contextlib
import json
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

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_OPS_PER_S = 67e12          # H100 SXM, outside the tensor cores

REPLACES = {
    "fused_step": "tak_tpu/engine/pallas_env.py:704",
    "backup_descend_wave": "tak_tpu/mcts/pallas_ops.py:1118",
    "descend_wave": "tak_tpu/mcts/pallas_ops.py:1284",
    "expand_backup_wave": "tak_tpu/mcts/pallas_ops.py:637",
    "descend_wave_hbm": "tak_tpu/mcts/pallas_hbm.py:324",
    "expand_backup_wave_hbm": "tak_tpu/mcts/pallas_hbm.py:648",
}
POOL_TIER = ("backup_descend_wave", "descend_wave", "expand_backup_wave")
HBM_TIER = ("descend_wave_hbm", "expand_backup_wave_hbm")
SOURCES = {
    "fused_step": "tak_tpu_torch/csrc/fused_step.cu",
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


def cuda_ms(fn, reps: int, setup=None) -> float:
    """Mean device milliseconds of fn(setup()) over `reps` runs (CUDA
    events around each launch; `setup` runs outside the timed span)."""
    import torch

    total = 0.0
    for _ in range(reps):
        arg = setup() if setup is not None else None
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


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


def tree_ops(B, V, A, M, descend: bool):
    """Float/int operations of a wave's descents: the root PUCT score
    (about 10 operations per action) and the victim scans (about 5 per
    node, twice) per descent; the walk and backups are negligible."""
    if not descend:
        return B * V * 64
    return B * V * (10 * A + 10 * M)


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
    step's under "fused_step"."""
    from tak_tpu_torch.engine.fused_env import fused_step, step_plain
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
    step_reps = 20
    out["fused_step"] = (
        cuda_ms(lambda _: [fused_step(mcts.engine, parents, acts, live)
                           for _ in range(step_reps)], 1) / step_reps,
        cuda_ms(lambda _: step_plain(mcts.engine, parents, acts, live), 2),
        *bound(*fused_step_work(parents, B * V)))
    log(f"time large tier ({what}) on {card}: "
        + "; ".join(
            f"{n} {v[0]:.4f} ms"
            + (f" (plain {v[1]:.3f} ms, bound {v[2]:.6f} ms by {v[3]})"
               if v[1] is not None else " (pool-tier kernel, recycling off)")
            for n, v in out.items()))
    return out


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
    reps = 20
    t_kernel = cuda_ms(lambda _: [fused_step(engine, root, act)
                                  for _ in range(reps)], 1) / reps
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


def profile_search(mcts, params, root_states, card):
    """Where one self-play move's search (10,240 sims on 32 games) spends
    its time: once with a synchronized host timer around each stage of
    every wave, once under torch.profiler."""
    from tak_tpu_torch.mcts import search as search_mod

    patches = [(search_mod, "backup_descend_wave", "tree kernel (merged)"),
               (search_mod, "expand_backup_wave", "tree kernel (flush)"),
               (search_mod, "masked_topk", "masked top-K"),
               (mcts, "_leaf_states_of", "leaf gather + fused step"),
               (mcts, "eval_fn", "observe + network"),
               (mcts.engine, "legal_mask", "legal mask"),
               (mcts, "_write_nodes", "write nodes")]
    tree = mcts.prepare_root(params, mcts.init_batch(root_states))
    with timed_stages(patches) as stages:
        sync()
        t0 = time.perf_counter()
        mcts.run_sims(params, tree)
        sync()
        wall = time.perf_counter() - t0
    log_stages(stages, wall, "one self-play move's search", card)
    tree = mcts.prepare_root(params, mcts.init_batch(root_states))
    device_profile(lambda: mcts.run_sims(params, tree),
                   "one self-play move's search", card)


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


def fused_step_work(state, rows: int):
    """(bytes, operations) of one fused step over `rows` rows: each state
    column read once and written once, plus the action and enabled
    inputs; per row the per-square decode and insert (~40 ops x n^2), and
    the result with the road flood fill (~12 ops x n^2 iterations x 2
    colors)."""
    in_bytes = sum(getattr(state, f).numel() * getattr(state, f).element_size()
                   for f in ("stacks", "heights", "tops", "to_move", "ply",
                             "stones", "caps", "half_komi", "reversible",
                             "result"))
    return 2 * in_bytes + rows * (4 + 1), rows * (40 * N * N + 24 * N * N)


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
    ROWS = GAMES * WAVE            # fused-step rows per wave
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    from tak_tpu_torch.engine.core import get_engine
    from tak_tpu_torch.engine.fused_env import fused_step, step_plain
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
    from tak_tpu_torch.selfplay import SelfPlayActor, SelfPlayConfig
    from tak_tpu_torch.types import ONGOING

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
    states = playout_states(engine, ROWS, 50, rng, dev)
    result = states.result.clone()
    result[::37] = 3  # some rows count as finished games: they must freeze
    states = states.replace(result=result)
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

    # the per-move instant-win scan: every (game, action) probe row of 32
    # mid-game roots, illegal pairs on the freeze path
    live_rows = torch.nonzero(states.result == ONGOING).flatten()[:GAMES]
    roots = states[live_rows]
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

    # ---- 3b. tree waves against their plain versions -----------------------
    t0 = time.perf_counter()
    net = Network(engine, NetConfig.for_size(N), device=dev)
    params = net.init_variables(SEED)

    def eval_fn(p, s):
        return net.policy_eval_states(p, s)

    sp_cfg = SelfPlayConfig(
        games=GAMES, workers=GAMES, max_plies=2 + MOVES,
        search=SearchConfig(num_sims=SIMS, wave_size=WAVE, max_children=K,
                            recycle=True))
    actor = SelfPlayActor(engine, eval_fn, sp_cfg, device=dev)
    scfg = actor.search_config
    if scfg.max_nodes != POOL or scfg.scan_chunk != 512:
        fail(f"unexpected default search config {scfg}")
    M = scfg.max_nodes
    kargs = dict(base=scfg.exploration_base, init=scfg.exploration_init,
                 recycle=True)
    mcts = MCTS(engine, eval_fn, scfg)
    tree = mcts.prepare_root(params, mcts.init_batch(roots))
    pending = Pending.zeros(GAMES, WAVE, K, dev)
    waves = 0
    while waves < 12 and not (waves >= 2 and
                              bool((tree.next_free == M).all())):
        pending = mcts._wave_pipelined(params, tree, pending)
        waves += 1
    sync()
    if not bool((tree.next_free == M).all()):
        fail(f"pool not full after {waves} waves: {tree.next_free.tolist()}")
    log(f"tree: {waves} waves, pool full ({M} nodes) in all {GAMES} games")

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
    checks["backup_descend_wave"] = (tk, True, True)
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
    checks["descend_wave"] = (tk, True, False)
    log("check descend_wave: bitwise equal")

    # expand + backup flush
    tk, tp = tree.clone(), tree.clone()
    expand_backup_wave(tk, pending, recycle=True)
    expand_backup_plain(tp, pending, recycle=True)
    sync()
    compare_trees(tk, tp, "expand_backup_wave")
    checks["expand_backup_wave"] = (tk, False, True)
    log(f"check expand_backup_wave: bitwise equal "
        f"(tree checks {time.perf_counter() - t0:.1f} s)")

    # ---- 3c. large-tier waves against their plain versions -------------------
    p_cfg = SearchConfig(num_sims=P_WAVE, wave_size=P_WAVE,
                         max_children=P_K, node_budget=P_POOL)
    one_root = roots[:1].map(lambda x: x.contiguous())
    hbm_times = check_hbm_kernels(
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

    # ---- 4. the self-play slice ------------------------------------------------
    per_move = []
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
            fail(f"root visits did not grow by {want_sims}: n0 "
                 f"{gained.tolist()} root_n {visits.tolist()}")
        return out

    def select_moves(gen, t, exploit):
        a = orig_select(gen, t, exploit)
        roots = t.state[:, 0]
        legal = engine.legal_mask(roots)
        ok = legal[torch.arange(a.shape[0], device=dev), a.long()]
        ongoing = roots.result == ONGOING
        if not bool((ok | ~ongoing).all()):
            fail(f"illegal action chosen: {a.tolist()}")
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
    moves = len(actor.move_times)
    if moves != MOVES:
        fail(f"the slice searched {moves} moves, expected {MOVES}")
    move_lines = []
    for i, ((sec, sims), games) in enumerate(zip(actor.move_times, per_move)):
        move_lines.append(f"move {i + 1}: {sec:.3f} s, {GAMES} trees x "
                          f"{sims} sims ({games} live games), "
                          f"{GAMES * sims / sec:,.0f} sims/s")
        log(move_lines[-1] + f" on {card}")
    steady = actor.move_times[1:]
    rate = GAMES * sum(s for _, s in steady) / sum(t for t, _ in steady)
    log(f"slice: {moves} moves in {wall:.2f} s, {len(examples)} examples; "
        f"moves 2-{moves}: {rate:,.0f} self-play sims/s on {card}")
    log(f"launches in the slice: {launches}")
    for name in POOL_TIER + ("fused_step",):
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the self-play path")
    for name in HBM_TIER:
        if launches.get(name, 0) != 0:
            fail(f"large-tier kernel {name} launched on the self-play path")

    # ---- 5. the Player slice, 6. the entry points --------------------------
    p_launches, p_lines, p_rate, player, searched = player_phase(
        engine, eval_fn, params, dev, card)
    by_path = {name: {"selfplay": launches.get(name, 0),
                      "player": p_launches.get(name, 0)}
               for name in REPLACES}
    # the kernels of the Player path again, at the shapes that path gave
    # them: move 1's searched tree (a 64-leaf wave) and a one-row step
    player_times = check_hbm_on_tree(
        player.mcts, params, searched,
        "the Player's own tree after move 1's search", card)
    one_row = check_single_step(engine, searched, card)
    del searched
    entry_points_phase(here, card)

    # ---- 7. timing ---------------------------------------------------------
    rows = []
    reps = 20
    st = states.clone()
    t_kernel = cuda_ms(lambda _: [fused_step(engine, st, acts, enabled)
                                  for _ in range(reps)], 1) / reps
    t_plain = cuda_ms(lambda _: step_plain(engine, st, acts, enabled), 3)
    t_bound, by = bound(*fused_step_work(st, ROWS))
    rows.append(("fused_step", t_kernel, t_plain, t_bound, by))

    t_wins = cuda_ms(lambda _: fused_step(engine, wst, wacts, wen), 5)
    t_wins_plain = cuda_ms(lambda _: step_plain(engine, wst, wacts, wen), 2)
    wins_bound, wins_by = bound(*fused_step_work(wst, wins_rows))
    wins_line = (f"fused_step at the win-scan shape ({wins_rows} rows): "
                 f"kernel {t_wins:.4f} ms, plain {t_wins_plain:.3f} ms, "
                 f"bound {wins_bound:.5f} ms ({wins_by})")
    log(f"time {wins_line} on {card}")

    for name, (after, descend, backup) in checks.items():
        def setup():
            return tree.clone()

        if name == "backup_descend_wave":
            run_k = lambda t: backup_descend_wave(t, pending, **kargs)
            run_p = lambda t: backup_descend_plain(t, pending, **kargs)
        elif name == "descend_wave":
            run_k = lambda t: descend_wave(t, WAVE, **kargs)
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

    for name in HBM_TIER:
        rows.append((name, *player_times[name]))
    for what, times in (("the Player's own tree", player_times),
                        ("one game, check tree", hbm_times),
                        ("8 games", hbm_times_8)):
        log(f"comparison at V={P_WAVE} K={P_K} M={P_POOL}, {what}, on {card}: "
            f"descend_wave_hbm {times['descend_wave_hbm'][0]:.4f} ms vs the "
            f"pool-tier descend_wave {times['descend_wave'][0]:.4f} ms; "
            f"expand_backup_wave_hbm "
            f"{times['expand_backup_wave_hbm'][0]:.4f} ms vs the pool-tier "
            f"expand_backup_wave {times['expand_backup_wave'][0]:.4f} ms "
            "(recycling off, same trees)")

    if do_profile:
        profile_search(mcts, params, roots, card)
        profile_player(player, card)

    def times(t):
        return dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"), t))

    # a kernel's times at its other shapes, beside the headline ones: the
    # large-tier waves on the check tree grown by the plain versions, the
    # fused step on the Player path's 64 leaf rows and on one row
    other_shapes = {
        "fused_step": {f"player wave, {P_WAVE} rows":
                       times(player_times["fused_step"]),
                       "one row": times(one_row)},
        **{name: {"check tree": times(hbm_times[name])} for name in HBM_TIER},
    }
    kernels = []
    for name, t_kernel, t_plain, t_bound, by in rows:
        paths = by_path[name]
        log(f"time {name}: kernel {t_kernel:.4f} ms, plain {t_plain:.3f} ms, "
            f"bound {t_bound:.6f} ms ({by}); launches: {paths['selfplay']} on "
            f"the self-play path, {paths['player']} on the Player path, "
            f"on {card}")
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            # each path was driven from counts of 0; a kernel of both paths
            # reports their sum, and the split beside it
            "launches": paths["selfplay"] + paths["player"],
            "launches_by_path": paths,
            # every kernel was held bitwise against its plain version above
            # (any differing entry fails the run), so the error is 0
            "max_abs_err": 0.0,
            "ms": t_kernel, "plain_ms": t_plain, "bound_ms": t_bound,
            "bound_by": by, "library_ms": None,
        }
        if name in other_shapes:
            entry["other_shapes"] = other_shapes[name]
        kernels.append(entry)
    # the end-to-end numbers again, next to the result lines
    log(f"summary on {card}: build {t_build:.1f} s; "
        + "; ".join(move_lines)
        + f"; moves 2-{moves}: {rate:,.0f} self-play sims/s; {wins_line}; "
        + "; ".join(p_lines)
        + f"; Player: {p_rate:,.0f} rollouts/s over {P_MOVES} moves")
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
