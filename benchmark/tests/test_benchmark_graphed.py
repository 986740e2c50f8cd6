"""`graphed_chunk_pct.learner` on fabricated records of the program's
counts."""

from __future__ import annotations

import importlib.util

import pytest

from conftest import BENCH


def _read(monkeypatch, counted):
    from benchmark import harness
    from tak_tpu_torch.utils import profiling

    reader = harness.load_module(
        BENCH / "metrics" / "graphed_chunk_pct.learner.py",
        "graphed_chunk_pct_learner")
    seen = []

    def counts(t0, t1):
        seen.append((t0, t1))
        return counted

    monkeypatch.setattr(profiling, "counts", counts)
    trace = harness.Trace(
        window_s=10.0, busy_s=1.0, rec=None, window=(2.0, 12.0), config={},
        workload={}, extras={}, counts={}, kernels=[], gaps=[])
    got = reader.read(trace)
    assert seen in ([], [(2.0, 12.0)])
    return got


@pytest.mark.parametrize("counted, want", [
    ({"train.chunks": 40, "train.graph_replays": 40,
      "train.graph_captures": 1}, 100.0),
    ({"train.chunks": 40, "train.graph_replays": 30, "sync": 9}, 75.0),
    ({"train.chunks": 4, "sync": 9}, 0.0),
    ({"sync": 9}, None),
    ({"train.graph_replays": 3}, None),
    ({}, None),
])
def test_graphed_chunk_pct_reader(monkeypatch, counted, want):
    """100 x `train.graph_replays` over `train.chunks` in the window;
    None without `train.chunks`."""
    assert _read(monkeypatch, counted) == want


def test_graphed_chunk_pct_reader_without_graphs(monkeypatch):
    """None from a program that has no graphed chunk (no
    `tak_tpu_torch.model.train_graph`), whatever it counts."""
    real = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name.endswith(".train_graph")
        else real(name, *a))
    assert _read(monkeypatch, {"train.chunks": 40}) is None
