"""The policy/value ResNet in plain PyTorch, float32, from flax's variables.

AlphaTak's Net6 (alpha-tak/src/model/net6.rs) and the repository's conv
head for Net5: a 3x3 stem convolution, BatchNorm and ReLU; `blocks`
residual blocks (conv, BN, ReLU, conv, BN, skip, ReLU); a 3x3 policy
convolution whose channel c at square (row, col) is the logit of action
c * n^2 + row * n + col; a value Dense over the NHWC-flattened (h, w, c)
features and tanh.  BatchNorm is flax's: in inference the running
statistics; in training the batch mean and the biased variance E[x^2] -
E[x]^2 clipped at 0, eps 1e-5.  Convolutions run NCHW with the kernels
turned from flax's HWIO; TF32 is switched off by `exact_float32()`.

`quant="fp8"` is the control: every convolution's and Dense's input and
weight rounded to float8 e4m3 with one scale per tensor (amax / 448), the
product in float32, the precision below the configurations' bfloat16.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """Float32 products without TF32 while the block runs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(x):
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()      # the rounding, passed straight through


def leaves(tree: dict, blocks: int) -> dict:
    """flax `{params, batch_stats}` -> named float32 numpy leaves:
    `conv{i}.kernel/bias` (i = 0 the stem, then two per block), its
    BatchNorm's `conv{i}.bn_scale/bn_bias/bn_mean/bn_var`,
    `policy.kernel/bias`, `value.kernel/bias`."""
    p, s = tree["params"], tree["batch_stats"]
    out = {}

    def put(name, conv, bn, bn_stats):
        out[f"{name}.kernel"] = conv["kernel"]
        out[f"{name}.bias"] = conv["bias"]
        out[f"{name}.bn_scale"] = bn["scale"]
        out[f"{name}.bn_bias"] = bn["bias"]
        out[f"{name}.bn_mean"] = bn_stats["mean"]
        out[f"{name}.bn_var"] = bn_stats["var"]

    put("conv0", p["Conv_0"], p["BatchNorm_0"], s["BatchNorm_0"])
    for b in range(blocks):
        rb, rs = p[f"ResBlock_{b}"], s[f"ResBlock_{b}"]
        for j in range(2):
            put(f"conv{1 + 2 * b + j}", rb[f"Conv_{j}"], rb[f"BatchNorm_{j}"],
                rs[f"BatchNorm_{j}"])
    out["policy.kernel"] = p["Conv_1"]["kernel"]
    out["policy.bias"] = p["Conv_1"]["bias"]
    out["value.kernel"] = p["Dense_0"]["kernel"]
    out["value.bias"] = p["Dense_0"]["bias"]
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def trainable(name: str) -> bool:
    """Whether a leaf is a parameter (the BatchNorm statistics are not)."""
    return not (name.endswith(".bn_mean") or name.endswith(".bn_var"))


def to_torch(named: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in named.items()}


def convs(named: dict) -> int:
    return sum(1 for k in named if k.endswith(".bn_scale"))


def forward(w: dict, planes, train: bool = False, quant: str | None = None):
    """planes [R, n, n, C] float32 -> (logits [R, A], value [R]).  With
    `train` BatchNorm takes the batch statistics."""
    logits, v = heads(w, planes, train, quant)
    return logits, torch.tanh(v)


def heads(w: dict, planes, train: bool = False, quant: str | None = None):
    """planes [R, n, n, C] float32 -> (logits [R, A], the value before its
    tanh [R])."""
    q = _fp8 if quant == "fp8" else (lambda x: x)

    def conv(x, name):
        kern = w[f"{name}.kernel"].permute(3, 2, 0, 1)
        return F.conv2d(q(x), q(kern), w[f"{name}.bias"], padding=1)

    def bn(x, name):
        if train:
            mean = x.mean((0, 2, 3))
            var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
        else:
            mean, var = w[f"{name}.bn_mean"], w[f"{name}.bn_var"]
        mul = torch.rsqrt(var + BN_EPS) * w[f"{name}.bn_scale"]
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + w[f"{name}.bn_bias"][:, None, None])

    x = planes.permute(0, 3, 1, 2)
    x = torch.relu(bn(conv(x, "conv0"), "conv0"))
    for b in range((convs(w) - 1) // 2):
        c0, c1 = f"conv{1 + 2 * b}", f"conv{2 + 2 * b}"
        y = torch.relu(bn(conv(x, c0), c0))
        x = torch.relu(bn(conv(y, c1), c1) + x)
    R = x.shape[0]
    pol = F.conv2d(q(x), q(w["policy.kernel"].permute(3, 2, 0, 1)),
                   w["policy.bias"], padding=1)
    flat = x.permute(0, 2, 3, 1).reshape(R, -1)           # flax (h, w, c)
    v = q(flat) @ q(w["value.kernel"]) + w["value.bias"]
    return pol.reshape(R, -1), v[:, 0]


def policy_value(w: dict, planes, quant: str | None = None, block: int = 512):
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


def random_flax(n: int, filters: int, blocks: int, seed: int) -> dict:
    """A `{params, batch_stats}` tree of random weights from the seed:
    kernels N(0, 1/fan_in) (the heads' four times that, so that policies
    and values differ from position to position as a trained net's do),
    small random biases and BatchNorm statistics, so that no leaf is
    trivially the identity."""
    from .tak import input_channels, num_patterns

    rng = np.random.default_rng([seed, 7])
    f = filters

    def conv(cin, cout, gain=1.0):
        return {"kernel": (gain * rng.standard_normal((3, 3, cin, cout))
                           / np.sqrt(9 * cin)).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(cout)).astype(np.float32)}

    def bn():
        scale = 1 + 0.1 * rng.standard_normal(f)
        return ({"scale": scale.astype(np.float32),
                 "bias": (0.1 * rng.standard_normal(f)).astype(np.float32)},
                {"mean": (0.1 * rng.standard_normal(f)).astype(np.float32),
                 "var": (1 + 0.1 * rng.random(f)).astype(np.float32)})

    params, stats = {}, {}
    params["Conv_0"] = conv(input_channels(n), f)
    params["BatchNorm_0"], stats["BatchNorm_0"] = bn()
    for b in range(blocks):
        p, s = {}, {}
        for j in range(2):
            p[f"Conv_{j}"] = conv(f, f)
            p[f"BatchNorm_{j}"], s[f"BatchNorm_{j}"] = bn()
        params[f"ResBlock_{b}"], stats[f"ResBlock_{b}"] = p, s
    params["Conv_1"] = conv(f, 3 + 4 * num_patterns(n), gain=4.0)
    params["Dense_0"] = {
        "kernel": (4.0 * rng.standard_normal((n * n * f, 1))
                   / np.sqrt(n * n * f)).astype(np.float32),
        "bias": np.zeros(1, np.float32)}
    return {"params": params, "batch_stats": stats}
