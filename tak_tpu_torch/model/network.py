"""Network wrapper, inference only (counterpart of `tak_tpu/model/network.py:44-148`).

  * `policy_eval` — planes [B, n, n, C] -> (softmax policy [B, A] over the
    full action space, tanh value [B]), with BatchNorm folded into the
    convolutions (`_fold_bn`, eps 1e-5) as the JAX package does.
  * `variables_from_numpy` — flax's nested numpy `{params, batch_stats}`
    dicts -> the port's unfolded `state_dict`.
  * `init_variables(seed)` — random weights from a seeded torch.Generator.
  * `Network.load(path)` — a weights file written by the JAX package.

Variables are `state_dict`s of the unfolded `TakResNet`; the folded copy
is built once per variables object (by identity) and loaded into the
inference module.  Training (`Network.train`) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..engine.observe import observe
from ..sizes import input_channels, move_channels
from ..utils.device import resolve_device
from .resnet import BN_EPS, NetConfig, TakResNet


def _conv_names(config: NetConfig):
    """(torch conv prefix, torch bn prefix | None, flax path) per conv."""
    out = [("stem", "stem_bn", ("Conv_0",), ("BatchNorm_0",))]
    for i in range(config.blocks):
        for j in range(2):
            out.append((f"blocks.{i}.conv{j}", f"blocks.{i}.bn{j}",
                        (f"ResBlock_{i}", f"Conv_{j}"),
                        (f"ResBlock_{i}", f"BatchNorm_{j}")))
    return out


def variables_from_numpy(params, batch_stats, config: NetConfig) -> dict:
    """flax {params, batch_stats} (nested dicts of arrays) -> state_dict.

    Conv kernels go from HWIO to OIHW.  The value Dense reads flax's
    NHWC-flattened (h, w, c) features; the port's Linear reads NCHW
    (c, h, w), so its weight is permuted."""
    n, f = config.n, config.filters

    def get(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    sd = {}
    for conv, bn, cpath, bpath in _conv_names(config):
        p = get(params, cpath)
        sd[f"{conv}.weight"] = t(p["kernel"]).permute(3, 2, 0, 1).contiguous()
        sd[f"{conv}.bias"] = t(p["bias"])
        bp, bs = get(params, bpath), get(batch_stats, bpath)
        sd[f"{bn}.weight"] = t(bp["scale"])
        sd[f"{bn}.bias"] = t(bp["bias"])
        sd[f"{bn}.running_mean"] = t(bs["mean"])
        sd[f"{bn}.running_var"] = t(bs["var"])
        sd[f"{bn}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    pol = params["Conv_1"]
    sd["policy.weight"] = t(pol["kernel"]).permute(3, 2, 0, 1).contiguous()
    sd["policy.bias"] = t(pol["bias"])
    val = params["Dense_0"]
    w = t(val["kernel"]).reshape(n, n, f, 1).permute(3, 2, 0, 1)
    sd["value.weight"] = w.reshape(1, f * n * n).contiguous()
    sd["value.bias"] = t(val["bias"])
    return sd


def init_variables(config: NetConfig, seed: int = 0) -> dict:
    """Random unfolded state_dict from a seeded torch.Generator: conv and
    linear weights ~ N(0, 1/fan_in), zero biases, identity BatchNorm."""
    g = torch.Generator().manual_seed(seed)
    n, f = config.n, config.filters
    sd = {}

    def weight(*shape):
        fan_in = int(np.prod(shape[1:]))
        return torch.randn(shape, generator=g) / np.sqrt(fan_in)

    for conv, bn, _, _ in _conv_names(config):
        cin = input_channels(n) if conv == "stem" else f
        sd[f"{conv}.weight"] = weight(f, cin, 3, 3)
        sd[f"{conv}.bias"] = torch.zeros(f)
        sd[f"{bn}.weight"] = torch.ones(f)
        sd[f"{bn}.bias"] = torch.zeros(f)
        sd[f"{bn}.running_mean"] = torch.zeros(f)
        sd[f"{bn}.running_var"] = torch.ones(f)
        sd[f"{bn}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    sd["policy.weight"] = weight(move_channels(n), f, 3, 3)
    sd["policy.bias"] = torch.zeros(move_channels(n))
    sd["value.weight"] = weight(1, f * n * n)
    sd["value.bias"] = torch.zeros(1)
    return sd


def fold_bn(variables: dict, config: NetConfig) -> dict:
    """Fold BatchNorm running statistics into the conv weights/biases:
    gamma*(conv+b-mean)/sqrt(var+eps) + beta (`Network._fold_bn`)."""
    out = {}
    for conv, bn, _, _ in _conv_names(config):
        s = variables[f"{bn}.weight"] / torch.sqrt(
            variables[f"{bn}.running_var"] + BN_EPS)
        out[f"{conv}.weight"] = variables[f"{conv}.weight"] * s[:, None, None, None]
        out[f"{conv}.bias"] = ((variables[f"{conv}.bias"]
                                - variables[f"{bn}.running_mean"]) * s
                               + variables[f"{bn}.bias"])
    for k in ("policy.weight", "policy.bias", "value.weight", "value.bias"):
        out[k] = variables[k]
    return out


class Network:
    def __init__(self, engine, config: NetConfig | None = None, device=None):
        self.engine = engine
        self.device = resolve_device(device)
        self.config = config or NetConfig.for_size(engine.n)
        folded = dataclasses.replace(self.config, fold_bn=True)
        self.model = TakResNet(folded).to(self.device, self.config.dtype).eval()
        if self.device.type == "cuda":
            # NHWC planes permute to a channels-last NCHW view for free, and
            # cuDNN's Hopper convolutions run NHWC: no layout copies
            self.model = self.model.to(memory_format=torch.channels_last)
        self._loaded = None

    def init_variables(self, seed: int = 0) -> dict:
        return init_variables(self.config, seed)

    def load(self, path: str) -> dict:
        """Variables from a weights file written by the JAX package's
        `Network.save` (`utils/checkpoint.py`)."""
        from ..utils.checkpoint import load_variables

        return load_variables(path, self.config)

    def _fold_bn(self, variables: dict) -> dict:
        return fold_bn(variables, self.config)

    def _prepare(self, variables: dict) -> None:
        if self._loaded is not variables:
            folded = self._fold_bn({k: v.float() for k, v in variables.items()})
            self.model.load_state_dict(folded)
            self._loaded = variables

    @torch.no_grad()
    def policy_eval(self, variables: dict, planes):
        """planes [B, n, n, C] -> (policy [B, A] softmax, value [B])."""
        self._prepare(variables)
        logits, value = self.model(planes.to(self.device))
        return torch.softmax(logits, -1), value

    def observe_batch(self, states):
        return observe(self.engine, states)

    def policy_eval_states(self, variables: dict, states):
        return self.policy_eval(variables, self.observe_batch(states))
