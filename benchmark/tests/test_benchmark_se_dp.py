"""The SE-ResNet configuration and the data-parallel learner: the new
configuration file against the SE reference's arithmetic, and both new
drivers at tiny CPU sizes through the harness (`drivers/selfplay_se.py`
at 8x8 with a one-block SE net, `drivers/learner_dp.py` over two gloo
ranks), held to the limits of their benchmark cells."""

from __future__ import annotations

import json
import time

import pytest
import torch

from conftest import BENCH, REPO, real_limits, write_layout

MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
SEED = 2 ** 31 + 91

TINY_SE = {"name": "tiny8se", "board_size": 8, "blocks": 1, "filters": 16,
           "se_channels": 4, "policy_head": "conv",
           "compute_dtype": "float32", "forward_flops_per_row": 1_000_000}


def se_layout(root):
    """The tiny layout with an 8x8 SE configuration and one self-play cell
    on it (the SE cell's traffic cut to 2 games x 16 sims)."""
    selfplay = json.loads((BENCH / "workloads" / "se8.selfplay.ref.json")
                          .read_text())
    selfplay.update(workers=2, sims=16, wave=4, k=8)
    layout, manifest = write_layout(root, {"tiny8.selfplay_se": selfplay})
    (root / "configs" / "tiny8se.json").write_text(json.dumps(TINY_SE))
    manifest["workloads"][0]["config"] = "tiny8se"
    layout.manifest.write_text(json.dumps(manifest))
    return layout, manifest


def dp_layout(root):
    """The tiny layout with the data-parallel learner over two gloo ranks,
    listed as the parked `net6.learner.dp4` would be: under
    `learner_examples_per_s` and the NCCL reader."""
    cell = "tiny.learner_dp"
    layout, manifest = write_layout(root, {cell: {
        "driver": "learner_dp", "world": 2, "backend": "gloo", "pool": 240,
        "chunk_size": 20, "chunks_in_step": 4, "setup_calls": 3,
        "limits": real_limits("net6.learner.dp4")}})
    for m in manifest["end_to_end"]:
        if m["name"] == "learner_examples_per_s":
            m["workloads"].append(cell)
    manifest["per_layer"].append({
        "name": "nccl_device_ms_per_chunk.learner", "unit": "ms",
        "better": "lower", "source": "device_trace", "layer": "mesh",
        "moves": "learner_examples_per_s", "workloads": [cell]})
    layout.manifest.write_text(json.dumps(manifest))
    return layout, manifest


def run(layout, manifest, cell, trace=False, seconds=1.0):
    from benchmark import run as bench_run

    return bench_run.run_cell(layout, manifest, cell, SEED, seconds, trace,
                              torch.device("cpu"),
                              t_start=time.perf_counter())


def test_se_config_file():
    """The configuration's widths, parameter count and forward operations
    a row from the SE reference's layout; nothing cut, no weights file."""
    from benchmark.reference import counts, tak

    entry = next(c for c in MANIFEST["configs"]
                 if c["name"] == "lc0se-20x256-8x8")
    data = json.loads((REPO / entry["file"]).read_text())
    assert data["reduced"] == entry["reduced"] == []
    assert "weights" not in data
    n, f, blocks, se = (data["board_size"], data["filters"], data["blocks"],
                        data["se_channels"])
    assert (n, f, blocks, se) == (8, 256, 20, 32)
    assert data["input_channels"] == tak.input_channels(n)
    assert data["num_actions"] == tak.num_actions(n)
    assert data["move_channels"] == 3 + 4 * tak.num_patterns(n)
    se_flops = 2 * (f * se + se * 2 * f)
    assert data["forward_flops_per_row"] == counts.forward_flops_per_row(
        n, f, blocks, data["input_channels"], data["move_channels"]) \
        + blocks * se_flops
    I, M = data["input_channels"], data["move_channels"]
    C = f        # convolutions with biases, BatchNorm scales and biases
    params = (9 * I * C + C + 2 * C + blocks * (2 * (9 * C * C + C + 2 * C))
              + 9 * C * M + M + n * n * C + 1
              + blocks * (C * se + se + se * 2 * C + 2 * C))
    assert data["parameters"] == params == 26_809_980


def test_new_cells_in_the_manifest():
    """`se8.selfplay.ref` is a one-card cell with its metrics; the four-card
    `net6.learner.dp4` is parked: its workload file and metric reader are
    kept for the cell, which the manifest does not list (the harness
    reports one card and card 0's memory)."""
    cells = {w["name"]: w for w in MANIFEST["workloads"]}
    assert cells["se8.selfplay.ref"]["chips"] == 1
    assert "net6.learner.dp4" not in cells
    names = {m["name"] for m in MANIFEST["per_layer"]}
    assert "nccl_device_ms_per_chunk.learner" not in names
    for name, driver in (("se8.selfplay.ref", "selfplay_se"),
                         ("net6.learner.dp4", "learner_dp")):
        data = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
        assert data["driver"] == driver and data["limits"]
    assert real_limits("net6.learner.dp4") == real_limits("net6.learner")
    from benchmark import harness

    e2e, layer = harness.cell_metrics(MANIFEST, "se8.selfplay.ref")
    assert {"selfplay_sims_per_s", "setup_s"} <= set(e2e)
    assert {"se_device_ms_per_wave.selfplay", "se_roofline",
            "move_tail_ms.selfplay", "wave_enqueue_ms.selfplay",
            "sync_wait_ms_per_wave.selfplay",
            "syncs_per_wave.selfplay"} <= set(layer)
    for m in ("se_device_ms_per_wave.selfplay", "se_roofline",
              "nccl_device_ms_per_chunk.learner"):
        assert callable(harness.Layout().metric(m).read)


def test_se_counts():
    from benchmark.reference import se_counts

    assert se_counts.se_bytes(1, 8, 256) == 98_304
    least = se_counts.least_seconds(8192 * 20, 8, 256, 32)
    assert least == pytest.approx(8192 * 20 * 98_304 / 3.35e12)


@pytest.mark.parametrize("trace", [False, True])
def test_selfplay_se_driver(tmp_path, trace):
    layout, manifest = se_layout(tmp_path / "bench")
    result, checks = run(layout, manifest, "tiny8.selfplay_se", trace=trace)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0
    names = {c.name for c in checks}
    assert {"policy_tv", "value_logit_gap", "engine_wrong", "search_wrong",
            "tree_wrong"} <= names
    if not trace:
        assert result["metrics"]["selfplay_sims_per_s"]["value"] > 0
    else:
        # the move loop's and the search's host readers find their spans
        # and counts through the SE driver as through `selfplay.py`
        assert {"move_tail_ms.selfplay", "wave_enqueue_ms.selfplay",
                "sync_wait_ms_per_wave.selfplay",
                "syncs_per_wave.selfplay"} <= set(result["metrics"])


def test_se_reference_matches_test_reference():
    """The benchmark's frozen SE reference and the tests' reference give
    the same logits and values on one tree (both float32)."""
    import numpy as np

    from benchmark import inputs
    from benchmark.reference import se_net, tak
    from tests import se_resnet_reference as ref

    n = 8
    tree = se_net.random_se_flax(n, 16, 2, 4, 5, "cpu")
    pool = inputs.learner_pool(n, 20, 6)
    planes = tak.observe({k: pool[k] for k in tak.FIELDS}, n, "cpu")
    pol, v, logit = se_net.policy_value(
        se_net.to_torch(se_net.leaves(tree, 2), "cpu"), planes)
    with torch.no_grad():
        want_logits, want_v = ref.forward(ref.to_torch(tree), planes)
    torch.testing.assert_close(pol, torch.softmax(want_logits, -1),
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(v, want_v, rtol=0, atol=1e-6)
    # the value head was scaled to spread 1 on the calibration batch
    assert 0.2 < float(np.std(logit.numpy())) < 5


@pytest.mark.parametrize("trace", [False, True])
def test_learner_dp_driver_two_gloo_ranks(tmp_path, trace):
    layout, manifest = dp_layout(tmp_path / "bench")
    result, checks = run(layout, manifest, "tiny.learner_dp", trace=trace)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0
    if not trace:
        assert result["metrics"]["learner_examples_per_s"]["value"] > 0
    assert {c.name for c in checks} >= {"loss_gap", "change_norm_gap"}
