"""A plain reference of the SE-ResNet policy/value net, in float32 torch ops.

Leela Chess Zero's squeeze-and-excitation residual tower
(lczero-training `tf/tfprocess.py`: `residual_block`, `squeeze_excitation`,
`ApplySqueezeExcitation`; the SE unit of Hu et al., arXiv:1709.01507) with
AlphaTak's Tak stem and heads (`alpha-tak/src/model/net6.rs`):

    stem:  x = relu(BN(conv3x3(planes)))
    block: y  = BN(conv3x3(relu(BN(conv3x3(x)))))
           s  = relu(W1 · mean_hw(y) + b1)            W1: C -> S
           e  = W2 · s + b2                           W2: S -> 2C
           γ, β = e[:C], e[C:]
           x  = relu(sigmoid(γ) ⊙ y + β + x)
    policy: conv3x3 to the move channels; logit of action c·n² + row·n + col
    value:  tanh(Linear(the (h, w, c)-flattened features -> 1))

The loss is `Network._loss`'s: -Σ pi · log_softmax(logits) / R +
Σ (z - v)² / R over the R rows, with BatchNorm on the batch's statistics.

Departures from lczero-training:
  * the stem and heads are Tak's (above), not Lc0's chess input planes,
    attention/convolutional policy map and WDL value head;
  * every BatchNorm has a scale (lczero-training leaves it out where a
    ReLU follows) and every convolution a bias, as flax's modules and
    AlphaTak's Net6 have them;
  * BatchNorm is flax's: the biased variance E[x²] - E[x]², clipped at 0,
    eps 1e-5 (Keras's default is 1e-3), running statistics in inference;
  * the SE ratio is 8 where the caller picks S = C / 8 (lczero-training's
    example configuration; its runs used other ratios too).

Weights are a flax `{params, batch_stats}` tree of numpy arrays (the
names `Network.save` writes): `Conv_0`/`BatchNorm_0` the stem,
`ResBlock_i/{Conv_0, BatchNorm_0, Conv_1, BatchNorm_1}` and
`ResBlock_i/SqueezeExcite_0/{Dense_0, Dense_1}` the blocks, `Conv_1` the
policy and `Dense_0` the value; kernels HWIO, Dense kernels [in, out].

Imports neither JAX nor the port.  TF32 is off (set here, for the
process), so that float32 on a card is float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BN_EPS = 1e-5


def random_tree(n: int, filters: int, blocks: int, se: int, in_channels: int,
                move_channels: int, seed: int) -> dict:
    """A seeded `{params, batch_stats}` tree: kernels N(0, 1/fan_in),
    small random biases, BatchNorm scales near 1 and statistics near the
    identity."""
    rng = np.random.default_rng(seed)
    f = filters

    def normal(*shape, fan_in, gain=1.0):
        return (gain * rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    def small(k):
        return (0.1 * rng.standard_normal(k)).astype(np.float32)

    def conv(cin, cout, gain=1.0):
        return {"kernel": normal(3, 3, cin, cout, fan_in=9 * cin, gain=gain),
                "bias": small(cout)}

    def bn():
        return ({"scale": (1 + small(f)).astype(np.float32), "bias": small(f)},
                {"mean": small(f),
                 "var": (1 + 0.1 * rng.random(f)).astype(np.float32)})

    def dense(cin, cout, gain=1.0):
        return {"kernel": normal(cin, cout, fan_in=cin, gain=gain),
                "bias": small(cout)}

    params, stats = {}, {}
    params["Conv_0"] = conv(in_channels, f)
    params["BatchNorm_0"], stats["BatchNorm_0"] = bn()
    for b in range(blocks):
        p, s = {}, {}
        for j in range(2):
            p[f"Conv_{j}"] = conv(f, f)
            p[f"BatchNorm_{j}"], s[f"BatchNorm_{j}"] = bn()
        p["SqueezeExcite_0"] = {"Dense_0": dense(f, se),
                                "Dense_1": dense(se, 2 * f)}
        params[f"ResBlock_{b}"], stats[f"ResBlock_{b}"] = p, s
    params["Conv_1"] = conv(f, move_channels, gain=4.0)
    params["Dense_0"] = dense(n * n * f, 1)
    return {"params": params, "batch_stats": stats}


def to_torch(tree, device="cpu", requires_grad: bool = False):
    """The tree's arrays as float32 tensors, nested the same way (the
    parameters requiring gradients where asked)."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device, requires_grad) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32), device=device,
                        requires_grad=requires_grad)


def _conv(x, p):
    return F.conv2d(x, p["kernel"].permute(3, 2, 0, 1), p["bias"], padding=1)


def _bn(x, p, s, train: bool):
    if train:
        mean = x.mean((0, 2, 3))
        var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
    else:
        mean, var = s["mean"], s["var"]
    mul = torch.rsqrt(var + BN_EPS) * p["scale"]
    return ((x - mean[:, None, None]) * mul[:, None, None]
            + p["bias"][:, None, None])


def squeeze_excite(y, x, p):
    """relu(sigmoid(γ) ⊙ y + β + x) of one block: y, x [R, C, H, W]."""
    C = y.shape[1]
    s = torch.relu(y.mean((2, 3)) @ p["Dense_0"]["kernel"]
                   + p["Dense_0"]["bias"])
    e = s @ p["Dense_1"]["kernel"] + p["Dense_1"]["bias"]
    gate = torch.sigmoid(e[:, :C])[:, :, None, None]
    return torch.relu(gate * y + e[:, C:][:, :, None, None] + x)


def forward(tree: dict, planes, train: bool = False):
    """planes [R, n, n, C_in] float32 -> (logits [R, A], value [R]);
    `tree` holds tensors (`to_torch`).  With `train` BatchNorm takes the
    batch statistics."""
    p, s = tree["params"], tree["batch_stats"]
    x = planes.permute(0, 3, 1, 2)
    x = torch.relu(_bn(_conv(x, p["Conv_0"]), p["BatchNorm_0"],
                       s["BatchNorm_0"], train))
    b = 0
    while f"ResBlock_{b}" in p:
        rp, rs = p[f"ResBlock_{b}"], s[f"ResBlock_{b}"]
        y = torch.relu(_bn(_conv(x, rp["Conv_0"]), rp["BatchNorm_0"],
                           rs["BatchNorm_0"], train))
        y = _bn(_conv(y, rp["Conv_1"]), rp["BatchNorm_1"], rs["BatchNorm_1"],
                train)
        x = squeeze_excite(y, x, rp["SqueezeExcite_0"])
        b += 1
    R = x.shape[0]
    logits = _conv(x, p["Conv_1"]).reshape(R, -1)
    flat = x.permute(0, 2, 3, 1).reshape(R, -1)            # flax (h, w, c)
    v = flat @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"]
    return logits, torch.tanh(v[:, 0])


def loss(tree: dict, planes, pi, z):
    """`Network._loss` in train mode: (loss, policy part, value part)."""
    logits, value = forward(tree, planes, train=True)
    R = logits.shape[0]
    loss_p = -torch.sum(pi * torch.log_softmax(logits, -1)) / R
    loss_z = torch.sum(torch.square(z - value)) / R
    return loss_p + loss_z, loss_p, loss_z
