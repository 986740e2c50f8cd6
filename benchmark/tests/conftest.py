"""Fixtures of the benchmark's own tests: a throwaway layout of tiny
configurations and traffic mixes, next to the benchmark's real drivers
and metric readers."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

BENCH = REPO / "benchmark"

TINY_CONFIG = {"name": "tiny3", "board_size": 3, "blocks": 1, "filters": 16,
               "policy_head": "conv", "compute_dtype": "float32",
               "forward_flops_per_row": 1_000_000, "weights": None}


def real_limits(cell: str) -> dict:
    return json.loads((BENCH / "workloads" / f"{cell}.json").read_text())[
        "limits"]


def tiny_workloads() -> dict:
    """Each driver at a tiny size on the CPU, held to the limits of the
    benchmark's cell of the same driver."""
    selfplay = {"driver": "selfplay", "workers": 4, "sims": 32, "wave": 8,
                "k": 8, "recycle": True, "komi": 2, "noise_alpha": 0.2,
                "noise_ratio": 0.3, "noise_plies": 80, "exploit_plies": 40,
                "instant_win_scan": True, "tree_reuse": True,
                "warm_moves": 2, "limits": real_limits("net6.selfplay.ref")}
    return {
        "tiny.selfplay": selfplay,
        "tiny.selfplay.fresh": dict(selfplay, recycle=False),
        "tiny.learner": {"driver": "learner", "pool": 240, "chunk_size": 20,
                         "chunks_in_step": 4, "setup_calls": 3,
                         "limits": real_limits("net6.learner")},
    }


def write_layout(root: Path, workloads: dict):
    """A benchmark layout under `root` holding the tiny configuration, the
    given workload files and a manifest naming them; the drivers and the
    metric readers are the benchmark's own."""
    from benchmark import harness

    real = harness.load_json(harness.MANIFEST)
    (root / "configs").mkdir(parents=True, exist_ok=True)
    (root / "workloads").mkdir(exist_ok=True)
    for sub in ("drivers", "metrics"):
        if not (root / sub).exists():
            (root / sub).symlink_to(BENCH / sub)
    (root / "configs" / "tiny3.json").write_text(json.dumps(TINY_CONFIG))
    cells = []
    for name, wl in workloads.items():
        (root / "workloads" / f"{name}.json").write_text(json.dumps(wl))
        cells.append({"name": name, "config": "tiny3", "chips": 1,
                      "driver": wl["driver"]})
    manifest = dict(real)
    manifest["workloads"] = [{k: v for k, v in c.items() if k != "driver"}
                             for c in cells]

    def retarget(metric):
        m = dict(metric)
        if "workloads" in m:
            drivers = {real_driver(w) for w in m["workloads"]}
            m["workloads"] = [c["name"] for c in cells
                              if c["driver"] in drivers]
        return m

    manifest["end_to_end"] = [retarget(m) for m in real["end_to_end"]]
    manifest["per_layer"] = [retarget(m) for m in real["per_layer"]]
    path = root / "manifest.json"
    path.write_text(json.dumps(manifest))
    return harness.Layout(root=root, manifest=path), manifest


def real_driver(cell: str) -> str:
    return json.loads((BENCH / "workloads" / f"{cell}.json").read_text())[
        "driver"]


@pytest.fixture
def tiny(tmp_path):
    return write_layout(tmp_path / "bench", tiny_workloads())


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips itself on the CPU)")
