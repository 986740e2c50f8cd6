"""Each driver at a tiny size on the CPU, through the kernels' plain
versions: the result line has the contract's keys, the comparison holds,
a traced run reads its per-layer metrics, a new traffic mix is a new file
and nothing else, and no module of JAX or the JAX package is loaded."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch

from conftest import REPO, tiny_workloads, write_layout

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
SEED = 2 ** 31 + 77


def run(layout, manifest, cell, trace=False, seed=SEED, seconds=1.0):
    from benchmark import run as bench_run

    result, checks = bench_run.run_cell(
        layout, manifest, cell, seed, seconds, trace, torch.device("cpu"),
        t_start=time.perf_counter())
    return result, checks


@pytest.mark.parametrize("cell", sorted(tiny_workloads()))
def test_driver_line(tiny, cell):
    layout, manifest = tiny
    result, checks = run(layout, manifest, cell)
    assert list(result) == KEYS + ["checks"]
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    e2e = {m["name"] for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == e2e
    assert all(m["value"] > 0 for m in result["metrics"].values())
    json.dumps(result)


@pytest.mark.parametrize("cell", ["tiny.selfplay", "tiny.learner"])
def test_traced_line(tiny, cell):
    layout, manifest = tiny
    result, _ = run(layout, manifest, cell, trace=True)
    assert list(result) == KEYS + ["breakdown", "checks"]
    assert result["correct"] is True
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    layer = {m["name"] for m in manifest["per_layer"]}
    assert set(result["metrics"]) <= layer


def test_new_mix_is_a_new_file(tmp_path):
    """A traffic mix that the benchmark does not have, added as one file
    and one manifest entry, runs without any other change."""
    mixes = tiny_workloads()
    extra = dict(mixes["tiny.selfplay"], workers=2, sims=16, wave=4)
    layout, manifest = write_layout(tmp_path / "bench",
                                    {"tiny.selfplay.narrow": extra})
    result, _ = run(layout, manifest, "tiny.selfplay.narrow")
    assert result["correct"] is True
    assert result["attempted"] % 2 == 0


def test_no_jax_loaded(tmp_path):
    layout_root = tmp_path / "bench"
    write_layout(layout_root, {"tiny.selfplay": tiny_workloads()[
        "tiny.selfplay"]})
    code = f"""
import sys, time, torch
sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'benchmark' / 'tests')!r}]
from pathlib import Path
from benchmark import harness, run
lay = harness.Layout(root=Path({str(layout_root)!r}),
                     manifest=Path({str(layout_root / 'manifest.json')!r}))
res, _ = run.run_cell(lay, harness.load_json(lay.manifest), 'tiny.selfplay',
                      5, 0.5, False, torch.device('cpu'),
                      t_start=time.perf_counter())
print(res['correct'], run.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_refuses_without_a_card(tmp_path):
    """The command line prints no result and exits non-zero without a
    CUDA card (here, with none visible)."""
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "net6.selfplay.ref", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark, the
    command exits non-zero and prints no result."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "net6.selfplay.ref", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.card
def test_cell_on_the_card():
    """One short run of every cell on a card (skips itself without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    for cell in manifest["workloads"]:
        out = subprocess.run(
            [sys.executable, "-m", "benchmark.run", "--workload",
             cell["name"], "--seed", str(SEED), "--seconds", "3"],
            capture_output=True, text=True, timeout=900, cwd=REPO)
        assert out.returncode == 0, out.stderr[-3000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
