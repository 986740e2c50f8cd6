"""AlphaTak's training step in plain PyTorch, float32, without TF32.

alpha-tak/src/model/network.rs and example.rs: the examples of a call,
shuffled once by the caller's generator, are walked in chunks of 500;
each chunk's positions are turned into input planes and expanded to the
board's eight symmetries (the planes' squares and the policy targets'
actions mapped together); the loss of a chunk is
-sum(pi * log_softmax(logits)) / R + sum((z - v)^2) / R over its R rows,
with BatchNorm on the chunk's batch statistics; the gradients of 20
chunks are summed and Adam steps once (lr 1e-4, betas 0.9 / 0.999, eps
1e-8) on the gradient plus 1e-4 times the weights (classic L2).  A fresh
Adam is made for every call.  The policy target of an example is its
visits over its actions, normalised.
"""

from __future__ import annotations

import numpy as np
import torch

from . import net, tak

LR = 1e-4
WEIGHT_DECAY = 1e-4
BETAS = (0.9, 0.999)
EPS = 1e-8


def chunk_inputs(pool: dict, idx, n: int, device):
    """(planes [8R, n, n, C], pi [8R, A], z [8R]) of the examples `idx`.
    `pool`: fields [N, ...], `actions`/`visits` [N, W] (0 visits pad),
    `z` [N]."""
    fields = {k: pool[k][idx] for k in tak.FIELDS}
    planes = tak.observe(fields, n, device)
    R = planes.shape[0]
    A = tak.num_actions(n)
    acts = torch.as_tensor(pool["actions"][idx], device=device).long()
    vis = torch.as_tensor(pool["visits"][idx], device=device).float()
    pi = torch.zeros((R, A), device=device)
    pi.scatter_add_(1, acts, vis)
    pi = pi / vis.sum(-1, keepdim=True).clamp(min=1.0)
    z = torch.as_tensor(pool["z"][idx], device=device).float()
    sq, act = tak.symmetries(n)
    sq = torch.as_tensor(sq, device=device)
    act = torch.as_tensor(act, device=device)
    flat = planes.reshape(R, n * n, -1)
    out_p, out_pi = [], []
    for g in range(8):
        p = torch.empty_like(flat)
        p[:, sq[g]] = flat
        q = torch.empty_like(pi)
        q[:, act[g]] = pi
        out_p.append(p.reshape(planes.shape))
        out_pi.append(q)
    return torch.cat(out_p), torch.cat(out_pi), z.repeat(8)


def train_call(w: dict, pool: dict, order, n: int, device, chunk: int = 500,
               chunks_in_step: int = 20, quant: str | None = None,
               fault: str | None = None):
    """One call of the training step over the examples in `order`:
    (new leaves, [mean chunk loss of each step], [summed loss gradient of
    each step by leaf]).  `w`: float32 tensors by leaf name.  `fault`
    plants one of the faults the comparison must catch, for reading its
    numbers: "unchanged" (no step is applied), "half_batch" (each chunk's
    first half of the examples only, the loss its mean)."""
    params = {k: v.clone().requires_grad_(net.trainable(k))
              for k, v in w.items()}
    trainable = [k for k in params if net.trainable(k)]
    m = {k: torch.zeros_like(params[k]) for k in trainable}
    v2 = {k: torch.zeros_like(params[k]) for k in trainable}
    step = 0
    losses, grads = [], []
    chunk_losses = []
    n_chunks = len(order) // chunk
    with net.exact_float32():
        for c in range(n_chunks):
            idx = order[c * chunk:(c + 1) * chunk]
            if fault == "half_batch":
                idx = idx[:len(idx) // 2]
            planes, pi, z = chunk_inputs(pool, idx, n, device)
            logits, value = net.forward(params, planes, train=True,
                                        quant=quant)
            R = logits.shape[0]
            loss = (-(pi * torch.log_softmax(logits, -1)).sum() / R
                    + ((z - value) ** 2).sum() / R)
            loss.backward()
            chunk_losses.append(float(loss.detach()))
            if (c + 1) % chunks_in_step == 0:
                step += 1
                raw = {k: params[k].grad.detach().clone() for k in trainable}
                grads.append(raw)
                losses.append(float(np.mean(chunk_losses)))
                chunk_losses = []
                if fault == "unchanged":
                    for k in trainable:
                        params[k].grad = None
                    continue
                with torch.no_grad():
                    for k in trainable:
                        p = params[k]
                        g = p.grad + WEIGHT_DECAY * p
                        m[k].mul_(BETAS[0]).add_((1 - BETAS[0]) * g)
                        v2[k].mul_(BETAS[1]).add_((1 - BETAS[1]) * g * g)
                        mh = m[k] / (1 - BETAS[0] ** step)
                        vh = v2[k] / (1 - BETAS[1] ** step)
                        p.sub_(LR * mh / (vh.sqrt() + EPS))
                        p.grad = None
    return ({k: p.detach() for k, p in params.items()}, losses, grads)
