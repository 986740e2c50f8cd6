"""The SE epilogue's least work, frozen for `metrics/se_roofline.py`: what
one row of one block must move and compute, whatever the kernel does
(`tak_tpu_torch/csrc/squeeze_excite.cu`, its plain version in
`model/squeeze_excite.py`).

A row of a block reads y and x and writes the output, each n^2 x C bf16
values: 3 * 2 * n^2 * C bytes (98,304 at 8x8 x 256); the dense weights
are read once per launch, not per row, and are left out.  Its
operations: the channel sums (n^2 C adds) and the means (C), the two
dense layers (2 C S and 2 S 2C multiply-adds, S + 2C biases, S ReLUs),
the sigmoids (4 a channel: negate, exp, add, divide) and the epilogue
(4 an element: multiply, add, add, max).
"""

from __future__ import annotations

from .counts import F32_OPS_PER_S, HBM_BYTES_PER_S


def se_bytes(rows: int, n: int, channels: int) -> int:
    """Bytes `rows` rows x blocks of the epilogue must move."""
    return rows * 3 * 2 * n * n * channels


def se_ops(rows: int, n: int, channels: int, se: int) -> int:
    """Operations of `rows` rows x blocks of the epilogue."""
    C, S, hw = channels, se, n * n
    return rows * (hw * C + C + 2 * C * S + 2 * S * 2 * C + S + 2 * C + S
                   + 4 * C + 4 * hw * C)


def least_seconds(rows: int, n: int, channels: int, se: int) -> float:
    """max(bytes / 3.35 TB/s, operations / 67 TOP/s) of `rows` rows x
    blocks."""
    return max(se_bytes(rows, n, channels) / HBM_BYTES_PER_S,
               se_ops(rows, n, channels, se) / F32_OPS_PER_S)
