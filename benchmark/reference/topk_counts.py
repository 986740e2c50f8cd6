"""The legal top-K's least work, frozen for `metrics/legal_topk_roofline.py`:
what one leaf row of a search wave must move, whatever the kernel does
(`tak_tpu_torch/csrc/legal_topk.cu`, its plain version `masked_topk_packed`
in `engine/legal_bits.py`).

A row reads its float32 policy once (A = n^2 (3 + 4 P) entries, P = 2^n - 2
drop patterns) and its packed legal words (n^2 placement words and
4 wp n^2 spread words, wp = ceil(P / 32), int32), and writes K priors and
K ids (float32 and int32): A x 4 + (n^2 + 4 wp n^2) x 4 + K x 8 bytes,
37,696 at 6x6 and 269,568 at 8x8 with K = 32.  Its comparisons are a few
an entry, far below the card's integer rate, and are left out.
"""

from __future__ import annotations

from .counts import HBM_BYTES_PER_S


def row_bytes(n: int, k: int) -> int:
    """Bytes one row of the stage must move at size n with K = k."""
    n2, patterns = n * n, 2 ** n - 2
    wp = -(-patterns // 32)
    actions = n2 * (3 + 4 * patterns)
    return actions * 4 + (n2 + 4 * wp * n2) * 4 + k * 8


def least_seconds(rows: int, n: int, k: int) -> float:
    """`rows` rows' bytes over 3.35 TB/s."""
    return rows * row_bytes(n, k) / HBM_BYTES_PER_S
