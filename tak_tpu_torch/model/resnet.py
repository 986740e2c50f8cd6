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
them to XLA, not to a Pallas kernel.  On the card the module runs in bf16.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..sizes import input_channels, move_channels

BN_EPS = 1e-5  # flax nn.BatchNorm default


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


def _conv(cin, cout):
    return nn.Conv2d(cin, cout, 3, padding=1)


class ResBlock(nn.Module):
    def __init__(self, filters: int, fold_bn: bool):
        super().__init__()
        self.conv0 = _conv(filters, filters)
        self.conv1 = _conv(filters, filters)
        self.bn0 = nn.Identity() if fold_bn else nn.BatchNorm2d(filters, BN_EPS)
        self.bn1 = nn.Identity() if fold_bn else nn.BatchNorm2d(filters, BN_EPS)

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
        self.stem = _conv(input_channels(n), f)
        self.stem_bn = (nn.Identity() if config.fold_bn
                        else nn.BatchNorm2d(f, BN_EPS))
        self.blocks = nn.ModuleList(
            ResBlock(f, config.fold_bn) for _ in range(config.blocks))
        self.policy = _conv(f, move_channels(n))
        self.value = nn.Linear(f * n * n, 1)

    def forward(self, planes):
        dtype = self.stem.weight.dtype
        x = planes.permute(0, 3, 1, 2).to(dtype)
        x = torch.relu(self.stem_bn(self.stem(x)))
        for block in self.blocks:
            x = block(x)
        B = x.shape[0]
        # action id = channel * n^2 + row * n + col: NCHW flatten order
        p = self.policy(x).reshape(B, -1)
        v = self.value(x.reshape(B, -1))
        return p.float(), torch.tanh(v.float())[:, 0]
