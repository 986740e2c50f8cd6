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
  4. the slice: SelfPlayActor at 6x6, 32 lockstep games, 10,240 sims per
     move, wave 256, K=32, recycling in the default 1280-node pool, tree
     reuse (reroot_keep unset, as bench.py leaves it), instant-win scan on,
     Net6 (16 blocks x 128 filters, random weights from a seeded
     torch.Generator) in bf16, for 4 searched moves.  Checks: every chosen
     action is legal, every root gains exactly the searched sims, every
     kernel launched during the slice;
  5. time each kernel (CUDA events) and its plain version at the main
     path's shapes, with the least time the card could take (bound);
  6. print one `{"kernels": [...]}` line, then the `{"ok": true, ...}` line.

`--profile` adds, before the last two lines, where one move's search
spends its time (per-stage host timers, then torch.profiler device time).

Exits non-zero, printing no result, without a CUDA device or without the
`tak_tpu_torch` package beside this file.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

N = 6
GAMES = 32
SIMS = 10_240
WAVE = 256
K = 32
POOL = 1280
MOVES = 4
SEED = 0

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_OPS_PER_S = 67e12          # H100 SXM, outside the tensor cores

REPLACES = {
    "fused_step": "tak_tpu/engine/pallas_env.py:704",
    "backup_descend_wave": "tak_tpu/mcts/pallas_ops.py:1118",
    "descend_wave": "tak_tpu/mcts/pallas_ops.py:1284",
    "expand_backup_wave": "tak_tpu/mcts/pallas_ops.py:637",
}
SOURCES = {
    "fused_step": "tak_tpu_torch/csrc/fused_step.cu",
    "backup_descend_wave": "tak_tpu_torch/csrc/tree_wave.cu",
    "descend_wave": "tak_tpu_torch/csrc/tree_wave.cu",
    "expand_backup_wave": "tak_tpu_torch/csrc/tree_wave.cu",
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


def profile_search(mcts, params, root_states, card):
    """Where one move's search (10,240 sims on 32 games) spends its time:
    once with a synchronized host timer around each stage of every wave,
    once under torch.profiler for device time per kernel and the device's
    busy share of the wall time."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tak_tpu_torch.mcts import search as search_mod

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

    patches = [(search_mod, "backup_descend_wave", "tree kernel (merged)"),
               (search_mod, "expand_backup_wave", "tree kernel (flush)"),
               (search_mod, "masked_topk", "masked top-K"),
               (mcts, "_leaf_states_of", "leaf gather + fused step"),
               (mcts, "eval_fn", "observe + network"),
               (mcts.engine, "legal_mask", "legal mask"),
               (mcts, "_write_nodes", "write nodes")]
    saved = [(obj, attr, obj.__dict__.get(attr)) for obj, attr, _ in patches]
    for obj, attr, name in patches:
        setattr(obj, attr, timed(name, getattr(obj, attr)))
    tree = mcts.prepare_root(params, mcts.init_batch(root_states))
    sync()
    stages.clear()
    t0 = time.perf_counter()
    mcts.run_sims(params, tree)
    sync()
    wall = time.perf_counter() - t0
    for obj, attr, old in saved:
        if old is None:
            delattr(obj, attr)
        else:
            setattr(obj, attr, old)
    log(f"profile stages (synchronized host timers, one move's search, "
        f"{wall * 1e3:.1f} ms wall on {card}):")
    for name, sec in sorted(stages.items(), key=lambda kv: -kv[1]):
        log(f"  {name}: {sec * 1e3:.1f} ms ({100 * sec / wall:.1f}%)")
    rest = wall - sum(stages.values())
    log(f"  other host work: {rest * 1e3:.1f} ms ({100 * rest / wall:.1f}%)")

    tree = mcts.prepare_root(params, mcts.init_batch(root_states))
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mcts.run_sims(params, tree)
        sync()
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only (kernels, copies): an operator's own entry
    # repeats the time of the kernels it launched
    events = [e for e in events
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(dev_us(e) for e in events) / 1e3
    log(f"profile device (torch.profiler, one move's search): wall "
        f"{wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / (wall * 1e3):.1f}%), idle "
        f"{100 - 100 * busy / (wall * 1e3):.1f}% on {card}")
    top = sorted(events, key=lambda e: -dev_us(e))[:15]
    for e in top:
        log(f"  {dev_us(e) / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:90]}")


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

    from tak_tpu_torch.engine.core import Engine
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
    kb.library("fused_step")
    kb.library("tree_wave")

    engine = Engine(N)
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

    # ---- 4. the slice ------------------------------------------------------
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
    for name in REPLACES:
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the main path")

    # ---- 5. timing ---------------------------------------------------------
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

    if do_profile:
        profile_search(mcts, params, roots, card)

    kernels = []
    for name, t_kernel, t_plain, t_bound, by in rows:
        log(f"time {name}: kernel {t_kernel:.4f} ms, plain {t_plain:.3f} ms, "
            f"bound {t_bound:.5f} ms ({by}), {launches.get(name, 0)} launches "
            f"in the slice, on {card}")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches.get(name, 0),
            # every kernel was held bitwise against its plain version above
            # (any differing entry fails the run), so the error is 0
            "max_abs_err": 0.0,
            "ms": t_kernel, "plain_ms": t_plain, "bound_ms": t_bound,
            "bound_by": by, "library_ms": None,
        })
    # the end-to-end numbers again, next to the result lines
    log(f"summary on {card}: build {t_build:.1f} s; "
        + "; ".join(move_lines)
        + f"; moves 2-{moves}: {rate:,.0f} self-play sims/s; {wins_line}")
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
