"""Compare top-k strategies for [4096, 9036] -> top-64 on the card
(counterpart of `tools/profile_topk.py`).

    python -m tak_tpu_torch.tools.profile_topk [--cpu]

The same numpy inputs as the JAX script (seed 0: a uniform policy, about
200 legal moves a row), no knobs.  The strategies: the exact top-K
(`torch.topk`, the counterpart of `jax.lax.top_k`) in float32 and in
bf16; a bisection threshold with one scatter (`bisect_topk`, not exact:
the entries above the threshold in index order); compaction of the legal
ids, then a small exact top-K (`compact_topk`, exact while a row has at
most 512 legal moves).  The JAX script's three `jax.lax.approx_max_k`
lines ("approx default", "approx r=0.9", "approx no-agg") time an
operation of the TPU with no PyTorch counterpart: they are left out.
Runs on the CUDA device unless `--cpu` is given.
"""

from __future__ import annotations

import numpy as np
import torch

from .timing import open_device, parser, timeit

BV = 4096
A = 9036
K = 64


def inputs(rng, rows: int = BV, width: int = A):
    """(policy float32, legal bool) as numpy, drawn as the JAX script draws
    them."""
    policy = rng.random((rows, width), np.float32)
    legal = rng.random((rows, width)) < 0.025   # realistic legality
    return policy, legal


def masked(m, p):
    return torch.where(m, p, torch.full_like(p, -1.0))


def exact_topk(m, p, k: int = K):
    return torch.topk(masked(m, p), k)


def exact_topk_bf16(m, p, k: int = K):
    return torch.topk(masked(m, p).to(torch.bfloat16), k)


def bisect_topk(m, p, k: int = K):
    """Bisection threshold + compaction via one scatter: (vals, ids) of the
    entries at or above the threshold, in index order, padded with -1 and
    0 (`tools/profile_topk.py`'s `bisect_topk`)."""
    x = masked(m, p)
    rows, width = x.shape
    lo = torch.zeros(rows, dtype=torch.float32, device=x.device)
    hi = torch.ones(rows, dtype=torch.float32, device=x.device)
    for _ in range(14):
        mid = 0.5 * (lo + hi)
        cnt = (x >= mid[:, None]).sum(-1)
        too_many = cnt > k
        lo = torch.where(too_many, mid, lo)
        hi = torch.where(too_many, hi, mid)
    sel = x >= hi[:, None]
    pos = torch.cumsum(sel.int(), -1) - 1
    pos = torch.where(sel & (pos < k), pos, k).long()
    ids = torch.arange(width, device=x.device).expand(rows, width)
    vals = torch.full((rows, k + 1), -1.0, device=x.device).scatter_reduce(
        1, pos, x, "amax")
    aidx = torch.zeros((rows, k + 1), dtype=torch.long,
                       device=x.device).scatter_reduce(1, pos, ids, "amax")
    return vals[:, :k], aidx[:, :k].to(torch.int32)


def compact_topk(m, p, k: int = K, L: int = 512):
    """Compact the legal ids (the first L of each row), then a small exact
    top-K over their priors."""
    rows, width = m.shape
    pos = torch.cumsum(m.int(), -1) - 1
    pos = torch.where(m & (pos < L), pos, L).long()
    ids = torch.arange(width, device=m.device).expand(rows, width)
    ids = torch.zeros((rows, L + 1), dtype=torch.long,
                      device=m.device).scatter_reduce(1, pos, ids,
                                                      "amax")[:, :L]
    vals = p.gather(-1, ids)
    valid = (torch.arange(L, device=m.device)[None, :]
             < m.sum(-1)[:, None])
    v, i = torch.topk(torch.where(valid, vals, torch.full_like(vals, -1.0)),
                      k)
    return v, ids.gather(-1, i)


def main(argv=None, env=None):
    """Returns {label: seconds}.  `env` is unused: the JAX script has no
    knobs."""
    device = open_device(parser("profile_topk", __doc__).parse_args(argv).cpu)
    policy, legal = inputs(np.random.default_rng(0), BV)
    policy = torch.as_tensor(policy, device=device)
    legal = torch.as_tensor(legal, device=device)
    t = {}
    for label, fn in (("exact f32", exact_topk),
                      ("exact bf16", exact_topk_bf16),
                      ("bisect+scatter", bisect_topk),
                      ("compact+small topk", compact_topk)):
        _, t[label] = timeit(label, fn, device, legal, policy, reps=30,
                             width=38)
    return t


if __name__ == "__main__":
    main()
