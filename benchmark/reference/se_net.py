"""The SE-ResNet in plain PyTorch, float32, from flax's variables: the
benchmark's frozen copy of `tests/se_resnet_reference.py`, in the layout
of `net.py` (named leaves, inference in blocks of rows, the float8
control), so that `checks.py` compares the program with it as with
`net.py`.

Leela Chess Zero's squeeze-and-excitation tower (lczero-training
`tf/tfprocess.py`: `residual_block`, `squeeze_excitation`,
`ApplySqueezeExcitation`) with AlphaTak's Tak stem and heads: `net.py`'s
network, each block ending

    s = relu(W1 · mean_hw(y) + b1),  e = W2 · s + b2,  γ, β = e[:C], e[C:]
    x = relu(sigmoid(γ) ⊙ y + β + x)

after its second BatchNorm y.  The departures from lczero-training are
those the test reference lists (Tak's stem and heads, BatchNorm scales
and convolution biases everywhere, flax's BatchNorm, SE ratio 8).  With
`quant="fp8"` the SE unit's dense layers take float8 inputs and weights
too, as every convolution and Dense does.

`random_se_flax`: a seeded tree whose BatchNorm statistics are those of
a batch of the benchmark's random positions (so that every BatchNorm
normalises, as a trained net's does, and the residual stream stays near
unit scale over 20 blocks); its value Dense is scaled so that the value
head's output before its tanh has mean 0 and spread 1 there (it neither
saturates nor sits at 0), and its policy convolution so that the logits
spread POLICY_LOGIT_STD there.  Renormalised over the legal moves, a
spread of 3 shapes the priors near a trained Tak net's: the top move a
fifth or so, a few dozen moves carrying the mass (Net6's trained
weights: a tenth, some forty).  At `net.random_flax`'s own gain, about
10, the top move takes three quarters, as no trained net's does.  A
random head puts almost none of its softmax on the legal moves at either
spread (a trained one about half), so the search's trees hardly depend
on the spread: PERF.md §6 gives both sets of tree statistics.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import net, tak
from .net import BN_EPS, exact_float32, to_torch  # noqa: F401 (re-exported)

CALIBRATION_ROWS = 512
POLICY_LOGIT_STD = 3.0


def leaves(tree: dict, blocks: int) -> dict:
    """`net.leaves`, and `se{b}.dense{j}.kernel/bias` of every block."""
    out = net.leaves(tree, blocks)
    for b in range(blocks):
        se = tree["params"][f"ResBlock_{b}"]["SqueezeExcite_0"]
        for j in range(2):
            out[f"se{b}.dense{j}.kernel"] = np.asarray(
                se[f"Dense_{j}"]["kernel"], np.float32)
            out[f"se{b}.dense{j}.bias"] = np.asarray(
                se[f"Dense_{j}"]["bias"], np.float32)
    return out


def heads(w: dict, planes, train: bool = False, quant: str | None = None,
          record: dict | None = None):
    """planes [R, n, n, C] float32 -> (logits [R, A], the value before its
    tanh [R]).  With `train`, BatchNorm takes the batch statistics; with
    `record` as well, each BatchNorm's (mean, var) is kept there by
    name."""
    q = net._fp8 if quant == "fp8" else (lambda x: x)

    def conv(x, name):
        kern = w[f"{name}.kernel"].permute(3, 2, 0, 1)
        return F.conv2d(q(x), q(kern), w[f"{name}.bias"], padding=1)

    def bn(x, name):
        if train:
            mean = x.mean((0, 2, 3))
            var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
            if record is not None:
                record[name] = (mean, var)
        else:
            mean, var = w[f"{name}.bn_mean"], w[f"{name}.bn_var"]
        mul = torch.rsqrt(var + BN_EPS) * w[f"{name}.bn_scale"]
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + w[f"{name}.bn_bias"][:, None, None])

    def dense(x, name):
        return q(x) @ q(w[f"{name}.kernel"]) + w[f"{name}.bias"]

    x = planes.permute(0, 3, 1, 2)
    x = torch.relu(bn(conv(x, "conv0"), "conv0"))
    for b in range((net.convs(w) - 1) // 2):
        c0, c1 = f"conv{1 + 2 * b}", f"conv{2 + 2 * b}"
        y = torch.relu(bn(conv(x, c0), c0))
        y = bn(conv(y, c1), c1)
        C = y.shape[1]
        s = torch.relu(dense(y.mean((2, 3)), f"se{b}.dense0"))
        e = dense(s, f"se{b}.dense1")
        gate = torch.sigmoid(e[:, :C])[:, :, None, None]
        x = torch.relu(gate * y + e[:, C:][:, :, None, None] + x)
    R = x.shape[0]
    pol = F.conv2d(q(x), q(w["policy.kernel"].permute(3, 2, 0, 1)),
                   w["policy.bias"], padding=1)
    flat = x.permute(0, 2, 3, 1).reshape(R, -1)           # flax (h, w, c)
    v = q(flat) @ q(w["value.kernel"]) + w["value.bias"]
    return pol.reshape(R, -1), v[:, 0]


def policy_value(w: dict, planes, quant: str | None = None, block: int = 256):
    """Inference in blocks of rows: (softmax policy [R, A], value [R], the
    value before its tanh [R])."""
    pols, logits = [], []
    with torch.no_grad(), exact_float32():
        for i in range(0, planes.shape[0], block):
            pol, x = heads(w, planes[i:i + block], quant=quant)
            pols.append(torch.softmax(pol, -1))
            logits.append(x)
    x = torch.cat(logits)
    return torch.cat(pols), torch.tanh(x), x


def random_se_flax(n: int, filters: int, blocks: int, se: int, seed: int,
                   device) -> dict:
    """A `{params, batch_stats}` tree from the seed: `net.random_flax`'s
    leaves, each block's SE dense layers (kernels N(0, 1/fan_in), biases
    0.1 N(0, 1)), then the statistics and the value scale of a batch of
    CALIBRATION_ROWS random positions (`inputs.learner_pool`), computed on
    `device`: the BatchNorms' statistics, then the value's and the
    policy's scales."""
    from benchmark import inputs

    tree = net.random_flax(n, filters, blocks, seed)
    rng = np.random.default_rng([seed, 8])

    def dense(cin, cout):
        return {"kernel": (rng.standard_normal((cin, cout))
                           / np.sqrt(cin)).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(cout)).astype(np.float32)}

    for b in range(blocks):
        tree["params"][f"ResBlock_{b}"]["SqueezeExcite_0"] = {
            "Dense_0": dense(filters, se), "Dense_1": dense(se, 2 * filters)}
    pool = inputs.learner_pool(n, CALIBRATION_ROWS, seed)
    planes = tak.observe({k: pool[k] for k in tak.FIELDS}, n, device)
    w = to_torch(leaves(tree, blocks), device)
    record = {}
    with torch.no_grad(), exact_float32():
        heads(w, planes, train=True, record=record)
    stats = tree["batch_stats"]
    for name, (mean, var) in record.items():
        i = int(name[len("conv"):])
        node = (stats["BatchNorm_0"] if i == 0 else
                stats[f"ResBlock_{(i - 1) // 2}"][f"BatchNorm_{(i - 1) % 2}"])
        node["mean"] = mean.cpu().numpy().astype(np.float32)
        node["var"] = var.cpu().numpy().astype(np.float32)
    w = to_torch(leaves(tree, blocks), device)
    with torch.no_grad(), exact_float32():
        logits, v = heads(w, planes)
    mean, std = float(v.mean()), max(float(v.std()), 1e-6)
    value = tree["params"]["Dense_0"]
    value["kernel"] = (value["kernel"] / std).astype(np.float32)
    value["bias"] = ((value["bias"] - mean) / std).astype(np.float32)
    gain = POLICY_LOGIT_STD / max(float(logits.std()), 1e-6)
    policy = tree["params"]["Conv_1"]
    policy["kernel"] = (policy["kernel"] * gain).astype(np.float32)
    policy["bias"] = (policy["bias"] * gain).astype(np.float32)
    return tree
