"""The legal top-K's frozen counts and its two readers,
`legal_topk_roofline` and `legal_topk_kernel_pct.selfplay`, on fabricated
traces and records of the program's counts."""

from __future__ import annotations

import pytest

from conftest import BENCH


def _read(monkeypatch, metric, counted, kernels, rows=8192 * 40, n=8):
    from benchmark import harness
    from tak_tpu_torch.utils import profiling

    reader = harness.load_module(BENCH / "metrics" / f"{metric}.py",
                                 metric.replace(".", "_"))
    seen = []

    def counts(t0, t1):
        seen.append((t0, t1))
        return counted

    monkeypatch.setattr(profiling, "counts", counts)
    trace = harness.Trace(
        window_s=10.0, busy_s=9.0, rec=None, window=(2.0, 12.0),
        config={"board_size": n}, workload={"k": 32}, extras={},
        counts={"rows": rows, "waves": 40}, kernels=kernels, gaps=[])
    got = reader.read(trace)
    assert seen in ([], [(2.0, 12.0)])
    return got


def test_topk_counts():
    from benchmark.reference import topk_counts

    assert topk_counts.row_bytes(6, 32) == 37_696
    assert topk_counts.row_bytes(8, 32) == 269_568
    assert topk_counts.row_bytes(8, 128) == 269_568 + 96 * 8
    assert topk_counts.least_seconds(8192, 8, 32) == pytest.approx(
        8192 * 269_568 / 3.35e12)
    assert topk_counts.least_seconds(8192, 6, 32) == pytest.approx(
        0.0922e-3, rel=1e-3)


KERNELS = [
    ("void tak_legal_topk_kernel<8, 4>(float const*, int const*)", 1.0,
     1.0 + 0.9e-3, frozenset()),
    ("void tak_legal_topk_kernel<8, 4>(float const*, int const*)", 2.0,
     2.0 + 0.9e-3, frozenset()),
    ("tak_se_epilogue_kernel", 3.0, 3.1, frozenset()),
]


@pytest.mark.parametrize("counted, kernels, want", [
    ({"search.legal_topk_rows": 2 * 8192, "sync": 3}, KERNELS,
     100.0 * 8192 * 269_568 / 3.35e12 / 0.9e-3),
    ({"sync": 3}, KERNELS, None),
    ({"search.legal_topk_rows": 8192}, KERNELS[2:], None),
    ({}, [], None),
])
def test_legal_topk_roofline_reader(monkeypatch, counted, kernels, want):
    """The rows' least time over the `tak_legal_topk` kernels' device
    time; None without the count or without the kernel."""
    got = _read(monkeypatch, "legal_topk_roofline", counted, kernels)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)
        assert 0 < got < 100


@pytest.mark.parametrize("counted, rows, want", [
    ({"search.legal_topk_rows": 8192 * 40}, 8192 * 40 + 32, 100.0 * 8192
     * 40 / (8192 * 40 + 32)),
    ({"search.legal_topk_rows": 8192, "sync": 4}, 8192 * 2, 50.0),
    ({"sync": 4}, 8192 * 2, None),
    ({"search.legal_topk_rows": 8192}, 0, None),
])
def test_legal_topk_kernel_pct_reader(monkeypatch, counted, rows, want):
    """100 x `search.legal_topk_rows` over the rows evaluated; None
    without the count or without rows."""
    got = _read(monkeypatch, "legal_topk_kernel_pct.selfplay", counted, [],
                rows=rows)
    assert got == (None if want is None else pytest.approx(want))
