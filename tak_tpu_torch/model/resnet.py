"""ResNet policy/value tower for Tak (counterpart of `tak_tpu/model/resnet.py`).

  stem: 3x3 conv (input_channels -> filters) + BN + ReLU
  body: `blocks` residual blocks (conv-BN-ReLU-conv-BN + skip + ReLU)
  policy head: 3x3 conv to move_channels(n) planes, flattened
               channel-major to action_space(n) logits (net6.rs:98-108);
               the dense Net5-style head is not ported
  value head: Linear(filters*n^2 -> 1) + tanh

Inputs are NHWC `[B, n, n, C]` like the JAX package; the module runs
NCHW inside.  The value Linear reads the NCHW-flattened features (c, h, w)
(`model/network.variables_from_numpy` permutes flax's (h, w, c) weight).
Convolutions and the Linear stay `torch.nn` calls: the JAX package leaves
them to XLA, not to a Pallas kernel.

Compute runs in `NetConfig.dtype` (bf16 by default) as flax's modules do
with `dtype=bf16`: every convolution and the Linear cast their input,
weight and bias to it, whatever the parameters' own type, so training
keeps float32 parameters and the inference copy may hold bf16 ones.
`BatchNorm` reproduces flax's `nn.BatchNorm`, not `nn.BatchNorm2d`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..sizes import input_channels, move_channels

BN_EPS = 1e-5        # flax nn.BatchNorm default
BN_MOMENTUM = 0.99   # flax's: running = 0.99 * running + 0.01 * batch


@dataclass(frozen=True)
class NetConfig:
    n: int
    filters: int = 128
    blocks: int = 8
    dtype: torch.dtype = torch.bfloat16
    # inference variant: BatchNorm folded into the conv weights/biases
    fold_bn: bool = False

    @staticmethod
    def for_size(n: int) -> "NetConfig":
        """Reference defaults: Net5 = 8 blocks, Net6 = 16 blocks."""
        return NetConfig(n=n, blocks=16 if n >= 6 else 8)


class BatchNorm(nn.Module):
    """flax 0.12.3 `nn.BatchNorm(dtype=...)` over the channels of NCHW input.

    Train mode: the batch mean and the biased variance E[x^2] - E[x]^2
    (clipped at 0) in float32 (or the input's wider type); the running statistics move by
    `running = 0.99 * running + 0.01 * batch` and store that biased
    variance.  Both modes normalise in float32, (x - mean) *
    (rsqrt(var + eps) * scale) + bias, and return the input's dtype.
    Parameter and buffer names are `nn.BatchNorm2d`'s, so state_dicts keep
    their keys (`num_batches_tracked` is kept, not counted)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.int64))

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            mean = xf.mean((0, 2, 3))
            var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(
                    (1 - BN_MOMENTUM) * mean)
                self.running_var.mul_(BN_MOMENTUM).add_(
                    (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(x.dtype)


class Conv(nn.Conv2d):
    """3x3 'same' convolution computed in its input's dtype."""

    def __init__(self, cin, cout):
        super().__init__(cin, cout, 3, padding=1)

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        padding=1)


class Linear(nn.Linear):
    """`nn.Linear` computed in its input's dtype."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class ResBlock(nn.Module):
    def __init__(self, filters: int, fold_bn: bool):
        super().__init__()
        self.conv0 = Conv(filters, filters)
        self.conv1 = Conv(filters, filters)
        self.bn0 = nn.Identity() if fold_bn else BatchNorm(filters)
        self.bn1 = nn.Identity() if fold_bn else BatchNorm(filters)

    def forward(self, x):
        y = torch.relu(self.bn0(self.conv0(x)))
        y = self.bn1(self.conv1(y))
        return torch.relu(y + x)


class TakResNet(nn.Module):
    """[B, n, n, input_channels(n)] -> (policy logits [B, A], value [B])."""

    def __init__(self, config: NetConfig):
        super().__init__()
        self.config = config
        n, f = config.n, config.filters
        self.stem = Conv(input_channels(n), f)
        self.stem_bn = nn.Identity() if config.fold_bn else BatchNorm(f)
        self.blocks = nn.ModuleList(
            ResBlock(f, config.fold_bn) for _ in range(config.blocks))
        self.policy = Conv(f, move_channels(n))
        self.value = Linear(f * n * n, 1)

    def forward(self, planes):
        x = planes.permute(0, 3, 1, 2).to(self.config.dtype)
        x = torch.relu(self.stem_bn(self.stem(x)))
        for block in self.blocks:
            x = block(x)
        B = x.shape[0]
        # action id = channel * n^2 + row * n + col: NCHW flatten order
        p = self.policy(x).reshape(B, -1)
        v = self.value(x.reshape(B, -1))
        return p.float(), torch.tanh(v.float())[:, 0]
