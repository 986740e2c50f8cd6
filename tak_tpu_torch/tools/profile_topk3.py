"""Exact top-K strategy shootout for the wave's [R, A] -> top-64 stage
(counterpart of `tools/profile_topk3.py`).

All variants are EXACT (any global top-K element is inside its block's
local top-K): `torch.topk` (the counterpart of `jax.lax.top_k`) at k=64,
32 and 16; two stages, a top-K in each of c blocks then a top-K of their
winners, c in {2, 4, 8, 18}; sorted 128-wide blocks, their first 64 each,
then a top-K.  The input is the JAX script's: uniform float32, numpy seed
0.  The JAX script names `jax.lax.approx_max_k` only to set these apart
from it: no line of it times that operation of the TPU, which has no
PyTorch counterpart.

    python -m tak_tpu_torch.tools.profile_topk3 [--cpu]

Knobs (environment variables, the JAX script's names and defaults):
BENCH_FLAT (4096: R), BENCH_MCTS_K (64).  Runs on the CUDA device unless
`--cpu` is given.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .timing import knob, open_device, parser, timeit

A = 9036


def two_stage(x, c: int, k: int):
    """Exact: block top-K then merge.  Pads the row to a multiple of c."""
    r, a = x.shape
    pad = (-a) % c
    xp = torch.nn.functional.pad(x, (0, pad), value=float("-inf"))
    w = (a + pad) // c
    bv, bi = torch.topk(xp.reshape(r * c, w), min(k, w))
    kk = bv.shape[-1]
    # global index = block * w + local
    gi = bi + (torch.arange(r * c, device=x.device)[:, None] % c) * w
    mv, mi = torch.topk(bv.reshape(r, c * kk), k)
    return mv, gi.reshape(r, c * kk).gather(-1, mi)


def sorted_blocks(x, k: int):
    """Sort each 128-wide block (stable, descending), keep its first k,
    then one top-K over the kept entries."""
    r, a = x.shape
    pad = (-a) % 128
    xp = torch.nn.functional.pad(x, (0, pad), value=float("-inf"))
    c = (a + pad) // 128
    idx = torch.arange(a + pad, device=x.device).expand(r, a + pad)
    sv, order = torch.sort(-xp.reshape(r * c, 128), dim=-1, stable=True)
    si = idx.reshape(r * c, 128).gather(-1, order)
    sv = (-sv[:, :k]).reshape(r, c * k)
    si = si[:, :k].reshape(r, c * k)
    mv, mi = torch.topk(sv, k)
    return mv, si.gather(-1, mi)


def main(argv=None, env=None):
    """Returns {label: seconds}, "match" included."""
    env = os.environ if env is None else env
    device = open_device(parser("profile_topk3", __doc__)
                         .parse_args(argv).cpu)
    R = knob(env, "BENCH_FLAT", 4096)
    K = knob(env, "BENCH_MCTS_K", 64)
    x = torch.as_tensor(np.random.default_rng(0).random((R, A), np.float32),
                        device=device)
    t = {}

    def part(name, fn, *args):
        out, t[name] = timeit(name, fn, device, *args, reps=30, width=40)
        return out

    base_vals, _ = part("exact top_k k=64", torch.topk, x, K)
    part("exact top_k k=32", torch.topk, x, 32)
    part("exact top_k k=16", torch.topk, x, 16)
    for c in (2, 4, 8, 18):
        part(f"two-stage c={c}", two_stage, x, c, K)
    part("sort128 blocks + merge", sorted_blocks, x, K)

    # correctness spot check (values only; ties may permute indices)
    v2, _ = two_stage(x, 8, K)
    t["match"] = bool(np.allclose(base_vals.cpu().numpy(), v2.cpu().numpy()))
    print("two-stage c=8 values match exact:", t["match"], flush=True)
    return t


if __name__ == "__main__":
    main()
