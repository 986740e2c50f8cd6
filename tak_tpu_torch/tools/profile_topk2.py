"""Micro-profile of the wave's legal+topk stage and alternatives
(counterpart of `tools/profile_topk2.py`).

    python -m tak_tpu_torch.tools.profile_topk2 [--cpu]

On BENCH_FLAT rows of the harnesses' roots with a softmax policy over
standard normal logits (numpy seed 0; the JAX script draws them with
`jax.random`, whose bits cannot be reproduced): `Engine.legal_mask`, the
exact top-K (`torch.topk`, the counterpart of `jax.lax.top_k`), the fused
step #1 "for reference", the packed-key top-K (a 17-bit prior above a
14-bit action id in one int32, one integer top-K) with its recall against
the exact top-K and its largest prior error, and the bf16 top-K.  The JAX
script's `jax.lax.approx_max_k` lines ("approx_max_k r=0.95", "r=0.99"
and its measured recall) time an operation of the TPU with no PyTorch
counterpart: they are left out.

Knobs (environment variables, the JAX script's names and defaults):
BENCH_SIZE (6), BENCH_FLAT (4096: the flat leaf count B*V), BENCH_MCTS_K
(64).  Runs on the CUDA device unless `--cpu` is given.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..bench import mcts_roots
from ..engine.core import Engine
from .profile_topk import exact_topk, exact_topk_bf16
from .timing import knob, open_device, parser, timeit


def packed_topk(lg, p, k: int):
    """Quantize the prior to 17 bits, pack the index into the low 14 bits,
    one int32 top-K (no co-sorted payload)."""
    q = torch.round(p * 131071.0).to(torch.int32)
    iota = torch.arange(p.shape[-1], dtype=torch.int32, device=p.device)
    key = torch.where(lg, (q << 14) | iota,
                      torch.full_like(q, -(1 << 31)))
    top = torch.topk(key, k).values
    idx = top & 16383
    vals = torch.where(top >= 0, (top >> 14).float() / 131071.0,
                       torch.full_like(top, -1, dtype=torch.float32))
    return vals, idx


def recall(exact_ids, ids, k: int) -> float:
    """Mean share of each row's exact top-K ids that `ids` holds, over the
    first 256 rows (numpy [R, k] arrays)."""
    rows = min(exact_ids.shape[0], 256)
    return float(np.mean([len(set(exact_ids[b]) & set(ids[b])) / k
                          for b in range(rows)]))


def prior_error(vals, exact_vals) -> float:
    """Largest |prior - exact prior| between the sorted rows."""
    return float(np.abs(np.sort(vals, 1) - np.sort(exact_vals, 1)).max())


def main(argv=None, env=None):
    """Returns {label: seconds}, "recall" and "prior_err" included."""
    env = os.environ if env is None else env
    device = open_device(parser("profile_topk2", __doc__)
                         .parse_args(argv).cpu)
    N = knob(env, "BENCH_SIZE", 6)
    B = knob(env, "BENCH_FLAT", 4096)
    K = knob(env, "BENCH_MCTS_K", 64)

    engine = Engine(N)
    states = mcts_roots(engine, B, device)
    logits = np.random.default_rng(0).standard_normal(
        (B, engine.num_actions)).astype(np.float32)
    policy = torch.softmax(torch.as_tensor(logits, device=device), -1)
    t = {}

    def part(name, fn, *args):
        out, t[name] = timeit(name, fn, device, *args, reps=30, width=34)
        return out

    legal = part("legal_mask", engine.legal_mask, states)
    v_e, i_e = part("exact top_k", exact_topk, legal, policy, K)
    # the fused leaf step already emits stepped states
    part("fused_step (for reference)", engine.step, states,
         torch.zeros(B, dtype=torch.int32, device=device),
         torch.ones(B, dtype=torch.bool, device=device))
    v_p, i_p = part("packed i32 top_k", packed_topk, legal, policy, K)
    t["recall"] = recall(i_e.cpu().numpy(), i_p.cpu().numpy(), K)
    print(f"packed topk recall vs exact: {t['recall']:.4f}")
    t["prior_err"] = prior_error(v_p.cpu().numpy(), v_e.cpu().numpy())
    print(f"packed topk max |prior err|: {t['prior_err']:.2e}", flush=True)
    part("bf16 top_k", exact_topk_bf16, legal, policy, K)
    return t


if __name__ == "__main__":
    main()
