"""The port's spans and counters (`tak_tpu_torch/utils/profiling.py`) on
the CPU: nothing is recorded without a profiler; under one, a tiny
pool-tier self-play run and a tiny `Network.train` record their stages
with the nesting, counts and blocking readbacks the benchmark's readers
rely on; the Chrome trace holds the same ranges; the self-time
arithmetic; and the benchmark's five readers of the record on its tiny
self-play and learner cells."""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tak_tpu_torch.engine.core import get_engine
from tak_tpu_torch.mcts.search import SearchConfig
from tak_tpu_torch.model.network import Network
from tak_tpu_torch.model.resnet import NetConfig, TakResNet
from tak_tpu_torch.selfplay import SelfPlayActor, SelfPlayConfig
from tak_tpu_torch.types import FIELDS
from tak_tpu_torch.utils import profiling
from tak_tpu_torch.utils.profiling import Span

REPO = Path(__file__).resolve().parents[1]
NET = NetConfig(n=3, filters=8, blocks=1)
SIMS, WAVE = 32, 8
CHUNK, IN_STEP = 8, 3

# the blocking readbacks and pageable uploads: (span, its parent, readbacks)
SYNC_SITES = {
    ("search.nonzero", "search.write_nodes"): 1,
    ("search.root_need", "search.prepare_root"): 1,
    ("search.exploit_all", "selfplay.select"): 1,
    ("selfplay.upload", "selfplay.select"): 1,
    ("selfplay.readback", "selfplay.tail"): 5 + len(FIELDS),
    ("selfplay.instant_win", "selfplay.move"): 2 + len(FIELDS),
    ("env.upload", "selfplay.openings"): 1,
    ("env.upload", "selfplay.noise"): 1,
    ("env.upload", "selfplay.tail"): 1,
    ("env.upload", "selfplay.tree"): 1,
    ("env.upload", "selfplay.examples"): 1,
    ("env.upload", "selfplay.move"): 1,
    ("train.readback", "train.step"): 1,
    ("train.upload", "train.assemble"): len(FIELDS) + 3,
    ("train.upload_model", "train"): len(TakResNet(NET).state_dict()),
}
WAVE_STAGES = ("search.tree_kernel", "search.leaf_step", "search.eval",
               "search.legal_topk", "search.write_nodes")


def _network():
    engine = get_engine(3)
    nw = Network(engine, NET, device="cpu")
    return engine, nw, nw.init_variables(0)


def _selfplay(engine, nw, variables, games=6):
    cfg = SelfPlayConfig(games=games, workers=4, search=SearchConfig(
        num_sims=SIMS, wave_size=WAVE, max_children=8, recycle=True))
    actor = SelfPlayActor(engine, nw.policy_eval_states, cfg, device="cpu")
    return actor.run(variables, seed=3, log=lambda *a, **k: None)


def _train(nw, variables, examples):
    return nw.train(variables, examples, rng=np.random.default_rng(0),
                    log=lambda *a, **k: None, chunk_size=CHUNK,
                    chunks_in_step=IN_STEP)


@pytest.fixture(scope="module")
def recorded():
    """The record of one self-play run and one training call under a CPU
    profiler: (spans, counts, examples)."""
    engine, nw, variables = _network()
    examples = _selfplay(engine, nw, variables)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        examples = _selfplay(engine, nw, variables)
        _train(nw, variables, examples)
    out = profiling.spans(), profiling.counts(), examples
    profiling.clear()
    return out


def _ancestors(items, s):
    by_id = {x.id: x for x in items}
    while s.parent in by_id:
        s = by_id[s.parent]
        yield s.name


def _named(items, name):
    return [s for s in items if s.name == name]


def test_off_records_nothing():
    engine, nw, variables = _network()
    profiling.clear()
    examples = _selfplay(engine, nw, variables, games=4)
    _train(nw, variables, examples)
    assert profiling.spans() == [] and profiling.counts() == {}
    assert profiling.span("a") is profiling.span("b", sync=True)


def test_selfplay_nesting(recorded):
    items, _, _ = recorded
    parents = {s.id: s for s in items}
    searches = _named(items, "search")
    assert searches
    for s in searches:
        assert "selfplay.move" in set(_ancestors(items, s))
    for w in _named(items, "search.wave"):
        assert "search" in set(_ancestors(items, w))
    moves = _named(items, "selfplay.move")
    # one a searched move, and the last iteration may end in instant wins
    assert len(searches) <= len(moves) <= len(searches) + 1
    for name in ("selfplay.tree", "selfplay.noise", "selfplay.select",
                 "selfplay.tail", "selfplay.examples"):
        got = _named(items, name)
        assert len(got) == len(searches), name
        assert all(parents[s.parent].name == "selfplay.move" for s in got)
    for s in _named(items, "search.prepare_root"):
        assert parents[s.parent].name == "selfplay.tree"


def test_waves_counted(recorded):
    items, counts, _ = recorded
    waves = _named(items, "search.wave")
    per_search = SIMS // WAVE
    assert counts["search.waves"] == len(waves) \
        == per_search * len(_named(items, "search"))
    ids = {w.id for w in waves}
    for stage in WAVE_STAGES:
        got = _named(items, stage)
        assert len(got) == len(waves), stage
        assert {s.parent for s in got} == ids, stage
    # the pool tier flushes once a search
    flushes = _named(items, "search.flush")
    assert len(flushes) == len(_named(items, "search"))
    assert all(next(_ancestors(items, s)) == "search" for s in flushes)


def test_training_stages(recorded):
    items, counts, examples = recorded
    chunks = len(examples) // CHUNK
    assert len(_named(items, "train")) == 1
    assert len(_named(items, "train.prestack")) == 1
    assert len(_named(items, "train.chunk")) == chunks \
        == counts["train.chunks"]
    assert len(_named(items, "train.step")) == math.ceil(chunks / IN_STEP)
    parents = {s.id: s.name for s in items}
    for name, parent in (("train.assemble", "train.chunk"),
                         ("train.forward_backward", "train.chunk"),
                         ("train.upload", "train.assemble"),
                         ("train.readback", "train.step"),
                         ("train.chunk", "train"), ("train.step", "train"),
                         ("train.prestack", "train"),
                         ("train.upload_model", "train")):
        got = _named(items, name)
        assert got and {parents[s.parent] for s in got} == {parent}, name


def test_sync_sites(recorded):
    items, counts, _ = recorded
    parents = {s.id: s.name for s in items}
    syncs = [s for s in items if s.sync]
    for s in syncs:
        assert SYNC_SITES[(s.name, parents[s.parent])] == s.sync, s
    assert not {s.name for s in items if not s.sync} & {
        name for name, _ in SYNC_SITES}
    assert counts["sync"] == sum(s.sync for s in syncs)
    # one readback a wave, in the node writes
    assert len(_named(items, "search.nonzero")) == counts["search.waves"]
    assert _named(items, "selfplay.instant_win")


def test_chrome_trace_holds_the_spans(tmp_path):
    engine, nw, variables = _network()
    with profiling.trace(str(tmp_path), log=lambda *_: None):
        examples = _selfplay(engine, nw, variables, games=4)
        _train(nw, variables, examples[:4 * CHUNK])
    stored = [s["name"] for s in sorted(json.loads(
        (tmp_path / "spans.json").read_text())["spans"],
        key=lambda s: s["start"])]
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ranges = sorted((e for e in events if e.get("cat") == "user_annotation"
                     and e.get("name", "").startswith("tak.")),
                    key=lambda e: float(e["ts"]))
    assert stored and [e["name"][4:] for e in ranges] == stored
    saved = json.loads((tmp_path / "spans.json").read_text())
    assert saved["counts"]["search.waves"] > 0
    assert set(saved) == {"spans", "counts", "launches"}
    table = profiling.table()
    assert "search.wave" in table and "train.chunk" in table


def test_self_time_arithmetic():
    items = [Span(0, "a", 0.0, 10.0, None, 0),
             Span(1, "a.b", 1.0, 3.0, 0, 0),
             Span(2, "a.b.c", 1.5, 2.0, 1, 2),
             Span(3, "a.d", 5.0, 6.0, 0, 1),
             Span(4, "e", 11.0, 12.0, None, 1)]
    assert profiling.self_times(items) == {0: 7.0, 1: 1.5, 2: 0.5, 3: 1.0,
                                           4: 1.0}
    assert profiling.sync_seconds(items, "a") == 1.5
    assert profiling.sync_seconds(items, "a.b") == 0.5
    # a sync span inside another counts once, as its outermost
    nested = items + [Span(5, "a.d.x", 5.2, 5.4, 3, 1)]
    assert profiling.sync_seconds(nested, "a") == 1.5


def test_device_ms_by_range(tmp_path):
    """Device time goes to every range whose span holds the kernel's
    launch, whatever thread launched it."""
    def ev(cat, name, ts, dur, tid=1, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
             "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [ev("user_annotation", "tak.a", 0, 100),
              ev("user_annotation", "tak.a.b", 10, 20),
              ev("user_annotation", "tak.a", 200, 10),
              ev("user_annotation", "bench.x", 0, 300),
              ev("cuda_runtime", "cudaLaunchKernel", 15, 1, corr=1),
              ev("cuda_runtime", "cudaLaunchKernel", 50, 1, tid=2, corr=2),
              ev("cuda_runtime", "cudaMemcpyAsync", 205, 1, corr=3),
              ev("cuda_runtime", "cudaLaunchKernel", 150, 1, corr=4),
              ev("kernel", "k1", 400, 3000, corr=1),
              ev("kernel", "k2", 500, 500, corr=2),
              ev("gpu_memcpy", "m", 600, 250, corr=3),
              ev("kernel", "k4", 700, 7000, corr=4)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert profiling._device_ms(str(path)) == {"a": 3.75, "a.b": 3.0}


def test_window_of_the_record():
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("first"):
            profiling.count("n", 2)
        t0 = time.perf_counter()
        with profiling.span("second", sync=3):
            profiling.count("n", 5)
        t1 = time.perf_counter()
        with profiling.span("third"):
            pass
    assert [s.name for s in profiling.spans(t0, t1)] == ["second"]
    assert profiling.counts(t0, t1) == {"n": 5, "sync": 3}
    assert profiling.counts() == {"n": 7, "sync": 3}
    profiling.clear()
    assert profiling.spans() == []


@pytest.mark.parametrize("cell, names", [
    ("tiny.selfplay", ("wave_enqueue_ms.selfplay",
                       "sync_wait_ms_per_wave.selfplay",
                       "syncs_per_wave.selfplay")),
    ("tiny.learner", ("prestack_ms.learner", "chunk_assembly_ms.learner")),
])
def test_benchmark_readers(tmp_path, cell, names):
    """A traced run of the benchmark's tiny cell reads each new metric
    from the program's record, as a positive number (in a process of its
    own: the benchmark refuses to run beside JAX, which these tests
    load)."""
    code = f"""
import json, sys, time, torch
sys.path[:0] = [{str(REPO)!r}]
from pathlib import Path
from benchmark import harness, run
tiny = harness.load_module(Path({str(REPO / "benchmark" / "tests")!r})
                           / "conftest.py", "benchmark_tiny_layout")
layout, manifest = tiny.write_layout(Path({str(tmp_path)!r}) / "bench",
                                     tiny.tiny_workloads())
res, _ = run.run_cell(layout, manifest, {cell!r}, 2 ** 31 + 5, 1.0, True,
                      torch.device("cpu"), t_start=time.perf_counter())
print(json.dumps(res))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    for name in names:
        assert result["metrics"][name]["value"] > 0, name
    if cell == "tiny.selfplay":
        m = {k: v["value"] for k, v in result["metrics"].items()}
        total = m["wave_enqueue_ms.selfplay"] \
            + m["sync_wait_ms_per_wave.selfplay"]
        assert total <= m["search_ms_per_wave.selfplay"]
