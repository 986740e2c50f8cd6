"""ResNet policy/value tower for Tak (counterpart of `tak_tpu/model/resnet.py`).

  stem: 3x3 conv (input_channels -> filters) + BN + ReLU
  body: `blocks` residual blocks (conv-BN-ReLU-conv-BN + skip + ReLU)
  policy head:
    * "conv" (Net6-style, net6.rs:56,98-108): 3x3 conv to move_channels(n)
      planes, flattened channel-major to action_space(n) logits
    * "dense" (legacy Net5-style, net5.rs:56-62): Linear(filters*n^2 ->
      legacy_action_space(n)) over the legacy move list (1,575 at 5x5)
  value head: Linear(filters*n^2 -> 1) + tanh

Inputs are NHWC `[B, n, n, C]` like the JAX package; the module runs
NCHW inside.  The value Linear and the dense policy Linear read the
NCHW-flattened features (c, h, w) (`model/network.variables_from_numpy`
permutes flax's (h, w, c) weights).
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

from ..sizes import (
    action_space,
    input_channels,
    legacy_action_space,
    move_channels,
)
from .batch_norm import BN_EPS, batch_norm_train


@dataclass(frozen=True)
class NetConfig:
    n: int
    filters: int = 128
    blocks: int = 8
    policy_head: str = "conv"  # "conv" | "dense"
    dtype: torch.dtype = torch.bfloat16
    # inference variant: BatchNorm folded into the conv weights/biases
    fold_bn: bool = False

    @staticmethod
    def for_size(n: int) -> "NetConfig":
        """Reference defaults: Net5 = 8 blocks, Net6 = 16 blocks."""
        return NetConfig(n=n, blocks=16 if n >= 6 else 8)

    @property
    def policy_size(self) -> int:
        if self.policy_head == "dense":
            return legacy_action_space(self.n)
        return action_space(self.n)


class BatchNorm(nn.Module):
    """flax 0.12.3 `nn.BatchNorm(dtype=...)` over the channels of NCHW input.

    Train mode: the batch mean and the biased variance E[x^2] - E[x]^2
    (clipped at 0) in float32 (or the input's wider type); the running statistics move by
    `running = 0.99 * running + 0.01 * batch` and store that biased
    variance.  Both modes normalise in float32, (x - mean) *
    (rsqrt(var + eps) * scale) + bias, and return the input's dtype.
    Train mode is one autograd Function with its backward written out
    (`batch_norm.batch_norm_train`): the `tak_bn_*` CUDA kernels on the
    card, on channels-last input (`Network._train_model` lays the model
    out so), torch ops on the CPU.
    Parameter and buffer names are `nn.BatchNorm2d`'s, so state_dicts keep
    their keys (`num_batches_tracked` is kept, not counted).

    With `mesh` set (a `parallel.mesh.Mesh`; the data-parallel learner sets
    it), train mode takes the statistics over the GLOBAL batch, as XLA
    does for the JAX package's sharded step: every rank holds an equal
    block of rows (`shard_rows`), so E[x] and E[x^2] over the batch are
    the sums over the ranks of their own means divided by W, formed by
    one all-reduce, and the backward's gradient sums by another; at W = 1
    both are skipped.  The running statistics then agree on every rank."""

    mesh = None

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.int64))

    def forward(self, x):
        if self.training:
            return batch_norm_train(x, self.weight, self.bias,
                                    self.running_mean, self.running_var,
                                    self.mesh)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        y = (xf - self.running_mean[:, None, None]) * mul[:, None, None]
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
        if config.policy_head == "conv":
            self.policy = Conv(f, move_channels(n))
        elif config.policy_head == "dense":
            self.policy = Linear(f * n * n, config.policy_size)
        else:
            raise ValueError(f"unknown policy head {config.policy_head!r}")
        self.value = Linear(f * n * n, 1)

    def forward(self, planes):
        x = planes.permute(0, 3, 1, 2).to(self.config.dtype)
        x = torch.relu(self.stem_bn(self.stem(x)))
        for block in self.blocks:
            x = block(x)
        B = x.shape[0]
        flat = x.reshape(B, -1)
        if self.config.policy_head == "conv":
            # action id = channel * n^2 + row * n + col: NCHW flatten order
            p = self.policy(x).reshape(B, -1)
        else:
            p = self.policy(flat)
        v = self.value(flat)
        return p.float(), torch.tanh(v.float())[:, 0]
