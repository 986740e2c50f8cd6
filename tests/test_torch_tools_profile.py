"""The port's profiling harnesses (`tak_tpu_torch/tools/profile_*.py`)
against the JAX package, on the CPU at small sizes.

  (a) `profile_wave`: its chain of components leaves the same tree as its
      full wave, and both equal the JAX package's `mcts._wave` on the same
      roots (4x4, 2 games, wave 4, K=8; `backend="pallas"`, the JAX side's
      Pallas kernels in interpret mode), fresh and, as `BENCH_RECYCLE=1`
      runs it, on a recycled pool filled by one search first;
  (b) `profile_kernels`: descend -> `_eval_and_topk` -> expand_backup and
      the merged backup+descend equal the JAX `_descend`,
      `_expand_backup` and `_backup_descend` on the same tree;
  (c) `profile_nn`: the four towers on numpy-seeded weights at B=8 and 2
      blocks against the JAX script's `tower_xla`, `tower_mm`,
      `tower_im2col` and `tower_i8`, rebuilt here: the int8 policy exactly,
      the bf16 ones within 2^-6 of the largest policy magnitude;
  (d) the top-K strategies: the exact ones equal `torch.topk` and
      `jax.lax.top_k` on distinct values; the packed key's ids, priors,
      recall and largest prior error equal the JAX formula's on the same
      inputs; the bisection's output equals the JAX script's;
  (e) each tool's `main` with `--cpu` at tiny knobs, its lines parsing to
      finite positive times.

Every tree comparison feeds both packages the exact fake network of
`tests/test_torch_search.exact_eval_pair`.  The JAX scripts read their
knobs when imported, so the JAX side is built here as they build it.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tak_tpu.engine.core import Engine as JaxEngine
from tak_tpu.mcts.search import MCTS as JaxMCTS
from tak_tpu.mcts.search import SearchConfig as JaxSearchConfig
from tak_tpu_torch.engine.core import Engine
from tak_tpu_torch.mcts.search import MCTS, SearchConfig
from tak_tpu_torch.tools import (
    diag_bn_mismatch,
    profile_ab,
    profile_hbm,
    profile_kernels,
    profile_micro,
    profile_move_phases,
    profile_nn,
    profile_recycle_grid,
    profile_selfplay,
    profile_topk,
    profile_topk2,
    profile_topk3,
    profile_wave,
)
from tak_tpu_torch.types import GameState

from tests.test_torch_search import (
    assert_node_states_equal,
    assert_trees_equal,
    exact_eval_pair,
)

N, B, V, K, SIMS, POOL = 4, 2, 4, 8, 16, 16


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the tier-1 run
    shares the host's cores among its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_roots(engine, batch):
    """The JAX scripts' roots: half komi 4, a1, then the far corner."""
    states = engine.initial_batch(batch, 4)
    states = engine.batched_step(states, jnp.zeros(batch, jnp.int32))
    return engine.batched_step(
        states, jnp.full(batch, engine.num_squares - 1, jnp.int32))


JAX_SEARCHES = {}   # one JAX MCTS a configuration: its kernels compile once


def both_searches(recycle: bool, sustain: bool):
    """(JAX MCTS, JAX tree, port MCTS, port tree, port eval): the prepared
    trees of profile_wave's configuration at a small size, each filled by
    one search first with `sustain`."""
    jax_eval, torch_eval = exact_eval_pair(Engine(N).num_actions)
    common = dict(num_sims=SIMS, wave_size=V, max_children=K,
                  recycle=recycle, node_budget=POOL if recycle else None)
    if recycle not in JAX_SEARCHES:
        JAX_SEARCHES[recycle] = JaxMCTS(
            JaxEngine(N), jax_eval, JaxSearchConfig(backend="pallas",
                                                    **common))
    jm = JAX_SEARCHES[recycle]
    roots = jax_roots(JaxEngine(N), B)
    jt = jm.prepare_root(None, jm.init_batch(roots))
    tm = MCTS(Engine(N), torch_eval, SearchConfig(**common))
    assert tm.tier == "pool"
    tt = tm.prepare_root(None, tm.init_batch(GameState.from_numpy(roots)))
    if sustain:
        jt = jm.run_sims(None, jt)
        tm.run_sims(None, tt)
        assert (np.asarray(jt.next_free) == POOL).all()
    assert_trees_equal(jt, tt, "start")
    return jm, jt, tm, tt, torch_eval


@pytest.mark.parametrize("recycle", [False, True])
def test_wave_components_equal_the_full_wave_and_jax(recycle):
    jm, jt, tm, tt, torch_eval = both_searches(recycle, sustain=recycle)
    want = jm._wave(None, jt)
    wave = profile_wave.Wave(tm, lambda s: s,
                             lambda s: torch_eval(None, s))
    chained = wave.chain(tt.clone())
    full = wave.full(None, tt.clone())
    for got, what in ((chained, "chain"), (full, "full wave")):
        assert_trees_equal(want, got, what)
        assert_node_states_equal(want, got, what)
    assert int(np.asarray(want.n0)[0]) > int(tt.n0[0])
    if recycle:   # the wave evicted: a used slot changed its parent
        assert ((np.asarray(want.parent) != np.asarray(jt.parent))
                & (np.asarray(jt.parent) >= 0)).any()


def test_kernel_calls_equal_jax():
    jm, jt, tm, tt, _ = both_searches(False, sustain=False)
    calls = profile_kernels.kernel_calls(tm, None, tt)
    assert [c[0] for c in calls] == ["descend", "expand_backup",
                                     "merged backup+descend"]
    jt_d, jl, jc = jm._descend(jt)
    jt_e, jpending = jm._eval_and_topk(None, jt_d, jl, jc)
    want = {
        "descend": (jt_d, jl, jc),
        "expand_backup": (jm._expand_backup(jt_e, *jpending), None, None),
        "merged backup+descend": jm._backup_descend(
            jt_e, jpending + (jnp.int32(1),)),
    }
    assert_trees_equal(jt_e, calls[1][2], "tree after _eval_and_topk")
    assert_node_states_equal(jt_e, calls[1][2], "tree after _eval_and_topk")
    for label, call, src in calls:
        tree = src.clone()
        out = call(tree)
        w_tree, w_leaves, w_created = want[label]
        assert_trees_equal(w_tree, tree, label)
        if w_leaves is not None:
            np.testing.assert_array_equal(out[0].numpy(), np.asarray(w_leaves))
            np.testing.assert_array_equal(out[1].numpy(),
                                          np.asarray(w_created))
    assert_trees_equal(jt, tt, "the source tree is left alone")


# -- (c) the network formulations --------------------------------------------

def jax_towers(w, batch):
    """`tools/profile_nn.py`'s four towers over the weights `w` (float32
    numpy, rounded to bf16 as the script rounds them)."""
    bf16 = jnp.bfloat16
    blocks = w["ws"].shape[0] // 2
    w_stem, ws, w_pol, w_val = (jnp.asarray(w[k], bf16)
                                for k in ("w_stem", "ws", "w_pol", "w_val"))

    def conv_xla(x, k):
        return jax.lax.conv_general_dilated(
            x, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.float32).astype(bf16)

    def conv_mm(x, k):
        Bx, n, _, cin = x.shape
        xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
        acc = jnp.zeros((Bx, n, n, k.shape[-1]), jnp.float32)
        for dy in range(3):
            for dx in range(3):
                acc = acc + jax.lax.dot_general(
                    xp[:, dy:dy + n, dx:dx + n, :].reshape(-1, cin),
                    k[dy, dx], (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32).reshape(Bx, n, n, -1)
        return acc.astype(bf16)

    def conv_im2col(x, k):
        Bx, n, _, cin = x.shape
        xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
        cols = jnp.concatenate([xp[:, dy:dy + n, dx:dx + n, :]
                                for dy in range(3) for dx in range(3)], -1)
        out = jax.lax.dot_general(
            cols.reshape(-1, 9 * cin), k.reshape(9 * cin, -1),
            (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32)
        return out.reshape(Bx, n, n, -1).astype(bf16)

    def conv_mm_i8(x, k):
        Bx, n, _, cin = x.shape
        xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
        acc = jnp.zeros((Bx, n, n, k.shape[-1]), jnp.int32)
        for dy in range(3):
            for dx in range(3):
                acc = acc + jax.lax.dot_general(
                    xp[:, dy:dy + n, dx:dx + n, :].reshape(-1, cin),
                    k[dy, dx], (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.int32).reshape(Bx, n, n, -1)
        return acc

    def tower(conv):
        def run(x):
            x = jax.nn.relu(conv(x, w_stem))
            for i in range(blocks):
                y = jax.nn.relu(conv(x, ws[2 * i]))
                y = conv(y, ws[2 * i + 1])
                x = jax.nn.relu(x + y)
            p = conv(x, w_pol)
            v = jnp.tanh((x.reshape(batch, -1) @ w_val).astype(jnp.float32))
            return p, v
        return run

    def tower_i8(x):
        def q(v):
            return jnp.clip(jnp.round(v * 16.0), -127, 127).astype(jnp.int8)

        xq = q(x.astype(jnp.float32))
        wq_stem = q(w_stem.astype(jnp.float32) * 8)
        wqs = q(ws.astype(jnp.float32) * 8)
        xi = conv_mm_i8(xq, wq_stem)
        xq = jnp.clip(xi >> 7, -127, 127).astype(jnp.int8)
        for i in range(blocks):
            yi = conv_mm_i8(xq, wqs[2 * i])
            yq = jnp.clip(yi >> 7, -127, 127).astype(jnp.int8)
            yi = conv_mm_i8(yq, wqs[2 * i + 1])
            xq = jnp.clip((yi >> 7) + xq, -127, 127).astype(jnp.int8)
        p = conv_mm_i8(xq, q(w_pol.astype(jnp.float32) * 8))
        v = jnp.tanh((xq.reshape(batch, -1).astype(bf16) @ w_val)
                     .astype(jnp.float32))
        return p, v

    return {"conv": tower(conv_xla), "mm": tower(conv_mm),
            "im2col": tower(conv_im2col), "i8": tower_i8}


def test_network_formulations_match_the_jax_script():
    """B=8, 2 blocks.  bf16 towers: the policy within 2^-6 of its largest
    magnitude (each layer rounds to bf16, 2^-8 relative, after float32 sums
    taken in another order, and a flipped rounding grows through the
    layers), the value within 2^-6; the int8 tower's policy exactly (integer
    arithmetic) and its value within 2^-6."""
    batch = 8
    w = profile_nn.draw_weights(np.random.default_rng(0), batch, blocks=2)
    towers = profile_nn.Towers(w, "cpu")
    assert towers.blocks == 2 and towers.x0.dtype == torch.bfloat16
    x0 = jnp.asarray(w["x0"], jnp.bfloat16)
    np.testing.assert_array_equal(
        towers.x0.float().numpy(), np.asarray(x0.astype(jnp.float32)))
    want = jax_towers(w, batch)
    with torch.no_grad():
        got = {"conv": towers.conv(towers.x0), "mm": towers.mm(towers.x0),
               "im2col": towers.im2col(towers.x0), "i8": towers.i8(towers.x0)}
    tol = 2.0 ** -6
    for name in ("conv", "mm", "im2col", "i8"):
        wp, wv = (np.asarray(a.astype(jnp.float32)) for a in want[name](x0))
        gp, gv = got[name][0].float().numpy(), got[name][1].numpy()
        assert gp.shape == wp.shape == (batch, 6, 6, profile_nn.A_OUT), name
        if name == "i8":
            assert got[name][0].dtype == torch.int32
            np.testing.assert_array_equal(gp, wp)
        else:
            scale = np.abs(wp).max()
            assert np.abs(gp - wp).max() <= tol * scale, (name, scale)
        np.testing.assert_allclose(gv, wv.reshape(-1), atol=tol, rtol=0,
                                   err_msg=name)
    # the three bf16 formulations compute one function
    for name in ("mm", "im2col"):
        d = profile_nn.max_diff(got["conv"][0], got[name][0])
        assert d <= tol * float(got["conv"][0].float().abs().max()), name


# -- (d) the top-K strategies ------------------------------------------------

def topk_inputs(rows=64):
    """profile_topk's inputs at `rows` rows: every row's legal values are
    distinct, and it has more than 64 legal moves."""
    policy, legal = profile_topk.inputs(np.random.default_rng(0), rows)
    for r in range(rows):
        vals = policy[r][legal[r]]
        assert len(np.unique(vals)) == len(vals) > profile_topk.K
    return policy, legal


def test_exact_topk_strategies_equal_topk():
    policy, legal = topk_inputs()
    k = profile_topk.K
    masked = np.where(legal, policy, np.float32(-1.0))
    jv, ji = jax.lax.top_k(jnp.asarray(masked), k)
    tv, ti = torch.topk(torch.as_tensor(masked), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    p, m = torch.as_tensor(policy), torch.as_tensor(legal)
    for name, (v, i) in (("exact f32", profile_topk.exact_topk(m, p)),
                         ("compact", profile_topk.compact_topk(m, p))):
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv), name)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji), name)
    # bf16 rounding makes ties: the values equal the JAX bf16 top-K's
    bv, _ = profile_topk.exact_topk_bf16(m, p)
    np.testing.assert_array_equal(
        bv.float().numpy(), np.asarray(jax.lax.top_k(
            jnp.asarray(masked).astype(jnp.bfloat16), k)[0]
            .astype(jnp.float32)))
    # profile_topk3's strategies, on the dense uniform rows
    x = np.random.default_rng(1).random((16, profile_topk3.A), np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    xt = torch.as_tensor(x)
    for name, (v, i) in [(f"two-stage c={c}", profile_topk3.two_stage(xt, c, k))
                         for c in (2, 4, 8, 18)] + [
            ("sorted blocks", profile_topk3.sorted_blocks(xt, k))]:
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv), name)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji), name)


def test_bisect_topk_equals_the_jax_script():
    policy, legal = topk_inputs(16)
    k, rows, width = profile_topk.K, 16, profile_topk.A
    x = jnp.where(jnp.asarray(legal), jnp.asarray(policy), -1.0)
    lo, hi = jnp.zeros((rows,), jnp.float32), jnp.ones((rows,), jnp.float32)
    for _ in range(14):
        mid = 0.5 * (lo + hi)
        too_many = jnp.sum(x >= mid[:, None], -1) > k
        lo = jnp.where(too_many, mid, lo)
        hi = jnp.where(too_many, hi, mid)
    sel = x >= hi[:, None]
    pos = jnp.cumsum(sel.astype(jnp.int32), -1) - 1
    pos = jnp.where(sel & (pos < k), pos, k)
    r = jnp.broadcast_to(jnp.arange(rows)[:, None], (rows, width))
    wv = jnp.full((rows, k + 1), -1.0).at[r, pos].max(x, mode="drop")
    wi = jnp.full((rows, k + 1), 0, jnp.int32).at[r, pos].max(
        jnp.broadcast_to(jnp.arange(width)[None, :], (rows, width)),
        mode="drop")
    gv, gi = profile_topk.bisect_topk(torch.as_tensor(legal),
                                      torch.as_tensor(policy))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv[:, :k]))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi[:, :k]))


def test_packed_topk_recall_and_error_match_the_jax_formula():
    """`tools/profile_topk2.py`'s packed key and its recall and error
    expressions on one softmax policy (numpy logits) and legal mask."""
    rows, k = 64, 64
    _, legal = profile_topk.inputs(np.random.default_rng(2), rows)
    logits = np.random.default_rng(0).standard_normal(
        (rows, profile_topk.A)).astype(np.float32)
    jpol = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    tpol = torch.softmax(torch.as_tensor(logits), -1)
    np.testing.assert_allclose(tpol.numpy(), np.asarray(jpol), rtol=1e-6,
                               atol=0)
    pol = np.array(jpol)    # one policy for both formulas
    lg = jnp.asarray(legal)

    q = jnp.round(jnp.asarray(pol) * 131071.0).astype(jnp.int32)
    key = jnp.where(lg, (q << 14) | jax.lax.broadcasted_iota(
        jnp.int32, pol.shape, 1), jnp.int32(-(1 << 31)))
    top, _ = jax.lax.top_k(key, k)
    w_idx = np.asarray(top & 16383)
    w_vals = np.asarray(jnp.where(top >= 0, (top >> 14).astype(jnp.float32)
                                  / 131071.0, -1.0))
    w_ev, w_ei = (np.asarray(a) for a in
                  jax.lax.top_k(jnp.where(lg, jnp.asarray(pol), -1.0), k))
    w_rec = np.mean([len(set(w_ei[b]) & set(w_idx[b])) / k
                     for b in range(min(rows, 256))])
    w_err = np.abs(np.sort(w_vals, 1) - np.sort(w_ev, 1)).max()

    tl, tp = torch.as_tensor(legal), torch.as_tensor(pol)
    g_vals, g_idx = profile_topk2.packed_topk(tl, tp, k)
    g_ev, g_ei = profile_topk2.exact_topk(tl, tp, k)
    np.testing.assert_array_equal(g_idx.numpy(), w_idx)
    np.testing.assert_array_equal(g_vals.numpy(), w_vals)
    np.testing.assert_array_equal(g_ei.numpy(), w_ei)
    rec = profile_topk2.recall(g_ei.numpy(), g_idx.numpy(), k)
    err = profile_topk2.prior_error(g_vals.numpy(), g_ev.numpy())
    assert rec == w_rec and err == w_err
    assert 0.9 < rec <= 1.0 and 0 < err < 2.0 ** -17


# -- (e) every tool's main on the CPU ------------------------------------------

TINY_SEARCH = dict(BENCH_SIZE="3", BENCH_MCTS_BATCH="2", BENCH_MCTS_WAVE="4",
                   BENCH_MCTS_K="8", BENCH_MCTS_SIMS="16")
TINY_SP = dict(BENCH_SIZE="3", SP_WORKERS="2", SP_SIMS="16", SP_WAVE="4",
               SP_K="8")
MAINS = {
    "profile_selfplay": (profile_selfplay, dict(TINY_SP, SP_MOVES="2"), 1),
    "profile_move_phases": (profile_move_phases, dict(TINY_SP, REPS="1"), 7),
    "profile_ab topk": (profile_ab, TINY_SEARCH, 2),
    "profile_ab fused-legal": (profile_ab, dict(TINY_SEARCH,
                                                BENCH_AB="fused-legal"), 2),
    "profile_recycle_grid": (profile_recycle_grid, dict(
        BENCH_SIZE="3", SP_WORKERS="2", SP_SIMS="32",
        GRID="[(16,4,8),(20,4,0,0)]"), 2),
    "profile_wave": (profile_wave, TINY_SEARCH, 10),
    "profile_wave recycled": (profile_wave, dict(
        TINY_SEARCH, BENCH_RECYCLE="1", BENCH_BUDGET="16"), 10),
    "profile_kernels": (profile_kernels, TINY_SEARCH, 3),
    "profile_hbm": (profile_hbm, dict(HBM_SIZE="3", HBM_BATCH="2",
                                      HBM_WAVE="4", HBM_K="8", HBM_SIMS="8",
                                      HBM_BUDGET="40"), 2),
    "profile_micro": (profile_micro, {}, 6),
    "profile_topk": (profile_topk, {}, 4),
    "profile_topk2": (profile_topk2, dict(BENCH_SIZE="3", BENCH_FLAT="16",
                                          BENCH_MCTS_K="8"), 5),
    "profile_topk3": (profile_topk3, dict(BENCH_FLAT="8", BENCH_MCTS_K="16"),
                      8),
    "profile_nn": (profile_nn, dict(BENCH_FLAT="4"), 4),
}
# a timing line: a label, then milliseconds as the JAX scripts print them
MS = re.compile(r"([\d,]+(?:\.\d+)?) ms(/search|/move)?\b")
RATE = re.compile(r"([\d,]+(?:\.\d+)?k?) sims/s")


def numbers(out):
    """Every number in a main's return value (dicts, tuples, lists)."""
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [x for item in out for x in numbers(item)]
    return [out] if isinstance(out, float) else []


def timed_values(text):
    ms = [float(m.group(1).replace(",", "")) for m in MS.finditer(text)]
    rates = [float(m.group(1).rstrip("k").replace(",", ""))
             for m in RATE.finditer(text)]
    return ms, rates


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_runs_on_the_cpu(name, capsys, monkeypatch):
    """Each tool's `main(argv, env)` with `--cpu` at tiny knobs (the three
    tools without knobs at module sizes cut for the test): at least the
    expected count of timing lines, each a finite time (printed rounded,
    as the JAX scripts print them), and every time it returns finite and
    positive."""
    mod, env, lines = MAINS[name]
    if mod is profile_micro:
        monkeypatch.setattr(profile_micro, "BV", 16)
        monkeypatch.setattr(profile_micro, "N", 3)
    if mod is profile_topk:
        monkeypatch.setattr(profile_topk, "BV", 16)
    if mod is profile_nn:
        monkeypatch.setattr(profile_nn, "BLOCKS", 1)
    out = mod.main(["--cpu"], env)
    text = capsys.readouterr().out
    ms, rates = timed_values(text)
    assert len(ms) >= lines, text
    assert all(math.isfinite(x) and x >= 0 for x in ms + rates), text
    values = numbers(out)
    assert values and all(math.isfinite(x) and x >= 0 for x in values), out
    assert sum(x > 0 for x in values) >= lines, out
    if mod is profile_topk3:
        assert out["match"] is True and "match exact: True" in text
    if mod is profile_topk2:
        assert "packed topk recall vs exact:" in text
        assert 0 < out["recall"] <= 1
    if mod is profile_nn:
        assert re.search(r"max\|cudnn - mm\| = [\d.]+  "
                         r"max\|cudnn - im2col\| = [\d.]+", text)
    if mod in (profile_selfplay, profile_move_phases, profile_hbm,
               profile_ab, profile_wave, profile_kernels):
        assert re.search(r"(backend=|kind[=:] ?|use_pallas: )(pool|hbm|xla)",
                         text), text


def test_profile_ab_rejects_an_unknown_pair():
    with pytest.raises(SystemExit, match="valid pairs: fused-legal, topk, "
                                         "topkq"):
        profile_ab.main(["--cpu"], {"BENCH_AB": "nope"})


def test_diag_main_runs_on_the_cpu(tmp_path, capsys, monkeypatch):
    """`diag_bn_mismatch.main --cpu` on a 3x3 checkpoint of a 1-block,
    16-filter net written by the port (the tool's engine and network cut to
    that size): the checkpoint line and the three variants' results."""
    from tak_tpu_torch.examples import ReplayBuffer
    from tak_tpu_torch.engine.core import get_engine
    from tak_tpu_torch.model.network import Network
    from tak_tpu_torch.model.resnet import NetConfig
    from tak_tpu_torch.train_loop import save_training_run

    config = NetConfig(n=3, filters=16, blocks=1)
    monkeypatch.setattr(diag_bn_mismatch, "get_engine",
                        lambda n: get_engine(3))
    monkeypatch.setattr(diag_bn_mismatch, "Network",
                        lambda engine, device: Network(engine, config,
                                                       device=device))
    net = Network(get_engine(3), config, device="cpu")
    save_training_run(get_engine(3), net.init_variables(1), ReplayBuffer(),
                      str(tmp_path), 3)
    out = diag_bn_mismatch.main(["--cpu", "--workdir", str(tmp_path),
                                 "--games", "2", "--sims", "16"])
    text = capsys.readouterr().out
    assert "checkpoint: generation 3, buffer 0 examples" in text
    for name in out["variants"]:
        assert re.search(re.escape(name) + r": PitResult \{ wins: \d+, "
                         r"losses: \d+, draws: \d+ \}  win_rate=[\d.]+", text)
    assert out["candidate"] is out["champion"]
