"""BENCHMARK.json and the files it names: every configuration, traffic
mix and per-layer metric parses and agrees with the manifest, and nothing
the benchmark runs imports JAX or the JAX package."""

from __future__ import annotations

import ast
import json
import re

import pytest

from conftest import BENCH, REPO

MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "tak_tpu"}


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in MANIFEST[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.parametrize("config", MANIFEST["configs"],
                         ids=lambda c: c["name"])
def test_config_file(config):
    from benchmark.reference import counts, tak, weights

    data = json.loads((REPO / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert data["reduced"] == config["reduced"] == []
    n = data["board_size"]
    assert data["input_channels"] == tak.input_channels(n)
    assert data["num_actions"] == tak.num_actions(n)
    assert data["move_channels"] == 3 + 4 * tak.num_patterns(n)
    assert data["forward_flops_per_row"] == counts.forward_flops_per_row(
        n, data["filters"], data["blocks"], data["input_channels"],
        data["move_channels"])
    assert weights.sha256(REPO / data["weights"]) == data["weights_sha256"]


@pytest.mark.parametrize("cell", MANIFEST["workloads"],
                         ids=lambda c: c["name"])
def test_workload_file(cell):
    data = json.loads((BENCH / "workloads" / f"{cell['name']}.json")
                      .read_text())
    assert (BENCH / "drivers" / f"{data['driver']}.py").exists()
    assert cell["config"] in {c["name"] for c in MANIFEST["configs"]}
    assert cell["chips"] == 1
    assert data["limits"]
    from benchmark import harness

    e2e, layer = harness.cell_metrics(MANIFEST, cell["name"])
    assert "setup_s" in e2e and len(e2e) >= 2 and layer


@pytest.mark.parametrize("metric", MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader(metric):
    from benchmark import harness

    mod = harness.Layout().metric(metric["name"])
    assert callable(mod.read)
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert set(metric["workloads"]) <= cells
    moved = next(m for m in MANIFEST["end_to_end"]
                 if m["name"] == metric["moves"])
    assert moved["name"] != "setup_s"
    for cell in metric["workloads"]:
        assert cell in moved.get("workloads", [cell])


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_imports(path):
    tops = {m.split(".")[0] for m in imports(path)}
    assert not tops & FORBIDDEN
    if "reference" in path.parts:
        assert "tak_tpu_torch" not in tops
