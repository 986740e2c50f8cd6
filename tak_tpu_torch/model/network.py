"""Network wrapper: inference and reference-parity training (counterpart of
`tak_tpu/model/network.py`).

  * `policy_eval` — planes [B, n, n, C] -> (softmax policy [B, A] over the
    full action space, tanh value [B]), with BatchNorm folded into the
    convolutions (`_fold_bn`, eps 1e-5) as the JAX package does.
  * `train(...)` — Adam(lr=1e-4) with classic L2 weight decay 1e-4
    (network.rs:14-15,40-45), shuffled 500-example chunks, an optimizer
    step on the SUM of every 20 chunks' gradients, i.e. an effective batch
    of 10,000 examples (network.rs:17-21,92-96); each chunk is expanded 8x
    by D4 symmetry on the device (example.rs:62-78); loss =
    -sum(pi * log_softmax)/B + sum((z - v)^2)/B (network.rs:84-87).  The
    optimizer is rebuilt per call, as upstream does; the train module is
    built once and loaded in place each call, and on a card without a
    mesh its forward and backward replay as CUDA graphs
    (`model/train_graph.py`).
  * `variables_from_numpy` / `variables_to_numpy` — flax's nested numpy
    `{params, batch_stats}` <-> the port's unfolded `state_dict`, for
    either policy head, with the SE blocks' dense layers (flax
    `ResBlock_i/SqueezeExcite_0/Dense_0`, `Dense_1`) where the net has
    them.
  * the dense (legacy Net5) head: `policy_eval` scatters its softmax over
    the legacy move list into the channel-scheme action space the search
    reads; training targets and the D4 expansion use the legacy list.
  * `init_variables(seed)` — random weights from a seeded torch.Generator.
  * `Network.load` / `Network.save` — weights files of either package
    (`utils/checkpoint.py`).

Variables are `state_dict`s of the unfolded `TakResNet`; the folded copy
is built once per variables object (by identity) and loaded into the
inference module, so `train` returns new tensors and never writes into
the ones it was given.  `train(..., mesh=)` is the data-parallel path
(`parallel/`): every rank takes its rows of each chunk, BatchNorm takes
global statistics and the gradients are summed over the ranks.
"""

from __future__ import annotations

import dataclasses
import math
import time
from functools import cached_property

import numpy as np
import torch

from ..engine.observe import observe
from ..sizes import input_channels, move_channels
from ..types import GameState
from ..utils.device import resolve_device
from ..utils.profiling import count, span
from .resnet import BN_EPS, BatchNorm, NetConfig, SqueezeExcite, TakResNet
from .train_graph import ChunkGraphs

LEARNING_RATE = 1e-4
WEIGHT_DECAY = 1e-4
CHUNK_SIZE = 500
CHUNKS_IN_STEP = 20


def _conv_names(config: NetConfig):
    """(torch conv prefix, torch bn prefix | None, flax path) per conv."""
    out = [("stem", "stem_bn", ("Conv_0",), ("BatchNorm_0",))]
    for i in range(config.blocks):
        for j in range(2):
            out.append((f"blocks.{i}.conv{j}", f"blocks.{i}.bn{j}",
                        (f"ResBlock_{i}", f"Conv_{j}"),
                        (f"ResBlock_{i}", f"BatchNorm_{j}")))
    return out


def _se_names(config: NetConfig):
    """(torch prefix, flax path) of every SE dense layer; none without SE."""
    if not config.se_channels:
        return []
    return [(f"blocks.{i}.se.dense{j}",
             (f"ResBlock_{i}", "SqueezeExcite_0", f"Dense_{j}"))
            for i in range(config.blocks) for j in range(2)]


def _dense_names(config: NetConfig):
    """flax names of (the policy Dense | None, the value Dense): a dense
    policy head is created first, so it is `Dense_0` and the value
    `Dense_1`; with the conv head the value is `Dense_0`."""
    if config.policy_head == "dense":
        return "Dense_0", "Dense_1"
    return None, "Dense_0"


def variables_from_numpy(params, batch_stats, config: NetConfig) -> dict:
    """flax {params, batch_stats} (nested dicts of arrays) -> state_dict.

    Conv kernels go from HWIO to OIHW.  The Dense layers read flax's
    NHWC-flattened (h, w, c) features; the port's Linears read NCHW
    (c, h, w), so their weights are permuted."""
    n, f = config.n, config.filters
    pol_name, val_name = _dense_names(config)

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

    def dense(p):
        out = t(p["kernel"]).shape[1]
        w = t(p["kernel"]).reshape(n, n, f, out).permute(3, 2, 0, 1)
        return w.reshape(out, f * n * n).contiguous(), t(p["bias"])

    for name, path in _se_names(config):
        p = get(params, path)
        # flax's Dense kernel is [in, out]
        sd[f"{name}.weight"] = t(p["kernel"]).t().contiguous()
        sd[f"{name}.bias"] = t(p["bias"])

    if pol_name is None:
        pol = params["Conv_1"]
        sd["policy.weight"] = t(pol["kernel"]).permute(3, 2, 0, 1).contiguous()
        sd["policy.bias"] = t(pol["bias"])
    else:
        sd["policy.weight"], sd["policy.bias"] = dense(params[pol_name])
    sd["value.weight"], sd["value.bias"] = dense(params[val_name])
    return sd


def config_of(variables: dict) -> NetConfig:
    """The widths of a `state_dict` (board size, filters, blocks, head, SE
    channels)."""
    f = variables["stem.weight"].shape[0]
    blocks = len({k.split(".")[1] for k in variables if k.startswith("blocks.")})
    n = math.isqrt(variables["value.weight"].shape[1] // f)
    head = "dense" if variables["policy.weight"].dim() == 2 else "conv"
    se = variables.get("blocks.0.se.dense0.weight")
    return NetConfig(n=n, filters=f, blocks=blocks, policy_head=head,
                     se_channels=0 if se is None else se.shape[0])


def variables_to_numpy(variables: dict) -> dict:
    """state_dict -> flax {params, batch_stats} of float32 numpy arrays: the
    exact inverse of `variables_from_numpy` (OIHW kernels back to HWIO,
    the value weight back to flax's (h, w, c) order)."""
    config = config_of(variables)
    n, f = config.n, config.filters
    pol_name, val_name = _dense_names(config)

    def a(key):
        return variables[key].detach().float().cpu().numpy()

    def put(tree, path, leaf):
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = leaf

    def hwio(key):
        return np.ascontiguousarray(a(key).transpose(2, 3, 1, 0))

    params, stats = {}, {}
    for conv, bn, cpath, bpath in _conv_names(config):
        put(params, cpath, {"kernel": hwio(f"{conv}.weight"),
                            "bias": a(f"{conv}.bias")})
        put(params, bpath, {"scale": a(f"{bn}.weight"),
                            "bias": a(f"{bn}.bias")})
        put(stats, bpath, {"mean": a(f"{bn}.running_mean"),
                           "var": a(f"{bn}.running_var")})
    for name, path in _se_names(config):
        put(params, path,
            {"kernel": np.ascontiguousarray(a(f"{name}.weight").T),
             "bias": a(f"{name}.bias")})

    def dense(key):
        w = a(f"{key}.weight")
        out = w.shape[0]
        w = w.reshape(out, f, n, n).transpose(2, 3, 1, 0)
        return {"kernel": np.ascontiguousarray(w.reshape(n * n * f, out)),
                "bias": a(f"{key}.bias")}

    if pol_name is None:
        params["Conv_1"] = {"kernel": hwio("policy.weight"),
                            "bias": a("policy.bias")}
    else:
        params[pol_name] = dense("policy")
    params[val_name] = dense("value")
    return {"params": params, "batch_stats": stats}


def init_variables(config: NetConfig, seed: int = 0) -> dict:
    """Random unfolded state_dict from a seeded torch.Generator: conv and
    linear weights ~ N(0, 1/fan_in), zero biases, identity BatchNorm (the
    SE layers drawn after every convolution, so that a net without them
    draws what it always has)."""
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
    if config.policy_head == "dense":
        sd["policy.weight"] = weight(config.policy_size, f * n * n)
    else:
        sd["policy.weight"] = weight(move_channels(n), f, 3, 3)
    sd["policy.bias"] = torch.zeros(sd["policy.weight"].shape[0])
    sd["value.weight"] = weight(1, f * n * n)
    sd["value.bias"] = torch.zeros(1)
    S = config.se_channels
    for name, _ in _se_names(config):
        out, cin = (S, f) if name.endswith("dense0") else (2 * f, S)
        sd[f"{name}.weight"] = weight(out, cin)
        sd[f"{name}.bias"] = torch.zeros(out)
    return sd


def fold_bn(variables: dict, config: NetConfig) -> dict:
    """Fold BatchNorm running statistics into the conv weights/biases:
    gamma*(conv+b-mean)/sqrt(var+eps) + beta (`Network._fold_bn`); the SE
    layers and the heads are kept as they are."""
    out = {}
    for conv, bn, _, _ in _conv_names(config):
        s = variables[f"{bn}.weight"] / torch.sqrt(
            variables[f"{bn}.running_var"] + BN_EPS)
        out[f"{conv}.weight"] = variables[f"{conv}.weight"] * s[:, None, None, None]
        out[f"{conv}.bias"] = ((variables[f"{conv}.bias"]
                                - variables[f"{bn}.running_mean"]) * s
                               + variables[f"{bn}.bias"])
    keep = ["policy.weight", "policy.bias", "value.weight", "value.bias"]
    for name, _ in _se_names(config):
        keep += [f"{name}.weight", f"{name}.bias"]
    for k in keep:
        out[k] = variables[k]
    return out


class Network:
    def __init__(self, engine, config: NetConfig | None = None, device=None):
        self.engine = engine
        self.device = resolve_device(device)
        self.config = config or NetConfig.for_size(engine.n)
        folded = dataclasses.replace(self.config, fold_bn=True)
        self.model = TakResNet(folded).to(self.device, self.config.dtype).eval()
        for m in self.model.modules():
            if isinstance(m, SqueezeExcite):
                m.float()                 # the SE unit's arithmetic is float32
        if self.device.type == "cuda":
            # NHWC planes permute to a channels-last NCHW view for free, and
            # cuDNN's Hopper convolutions run NHWC: no layout copies
            self.model = self.model.to(memory_format=torch.channels_last)
        self._loaded = None
        self._train_module = None
        self._graphs = None
        self._legacy = None
        if self.config.policy_head == "dense":
            self._legacy = torch.as_tensor(engine.tables.legacy_actions,
                                           device=self.device).long()

    def init_variables(self, seed: int = 0) -> dict:
        return init_variables(self.config, seed)

    def load(self, path: str) -> dict:
        """Variables from a weights file written by either package's
        `Network.save` (`utils/checkpoint.py`)."""
        from ..utils.checkpoint import load_variables

        return load_variables(path, self.config)

    def save(self, variables: dict, path: str) -> None:
        from ..utils.checkpoint import save_variables

        save_variables(path, variables)

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
        probs = torch.softmax(logits, -1)
        if self._legacy is not None:
            # the legacy list's softmax into the channel-scheme action
            # space the search reads (moves outside the list: prior 0)
            full = torch.zeros((probs.shape[0], self.engine.num_actions),
                               dtype=probs.dtype, device=probs.device)
            full[:, self._legacy] = probs
            probs = full
        return probs, value

    def observe_batch(self, states):
        return observe(self.engine, states)

    def policy_eval_states(self, variables: dict, states):
        if self.config.se_channels:
            count("network.se_rows", states.ply.shape[0] * self.config.blocks)
        with span("network.observe"):
            planes = self.observe_batch(states)
        with span("network.forward"):
            return self.policy_eval(variables, planes)

    # -- training ------------------------------------------------------------

    def make_optimizer(self, params):
        # classic Adam-with-L2: torch's coupled weight decay adds wd * p to
        # the gradient before Adam's scaling, as optax.chain(
        # add_decayed_weights, adam) and tch's Adam { wd } do
        # (network.rs:40-45); AdamW's decoupled decay would not
        return torch.optim.Adam(params, lr=LEARNING_RATE,
                                weight_decay=WEIGHT_DECAY)

    def _train_model(self, variables: dict, mesh=None) -> TakResNet:
        """The unfolded module in train mode holding float32 copies of
        `variables` on the network's device, every `.grad` zero.  Without
        `mesh` it is one module for the network's life: built at the first
        call, then loaded in place (`load_state_dict` copies parameters,
        running statistics and `num_batches_tracked` into its tensors),
        so that the CUDA graphs of its chunk keep their addresses.  With
        `mesh`, a fresh module whose BatchNorms take global batch
        statistics."""
        model = self._train_module if mesh is None else None
        if model is None:
            model = TakResNet(self.config)
            # one copy a tensor, each waiting for the card's queue
            with span("train.upload_model", sync=len(model.state_dict())):
                model = model.to(self.device)
            if self.device.type == "cuda":
                model = model.to(memory_format=torch.channels_last)
            if mesh is None:
                self._train_module = model
            else:
                for m in model.modules():
                    if isinstance(m, BatchNorm):
                        m.mesh = mesh
        model.load_state_dict(variables)
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.zero_()
        return model.train()

    def _chunk_graphs(self, model: TakResNet) -> ChunkGraphs:
        """The CUDA graphs of `model`'s chunk, kept while they address its
        tensors."""
        if self._graphs is None or not self._graphs.holds(model):
            self._graphs = ChunkGraphs(model)
        return self._graphs

    @cached_property
    def _sym_tables(self):
        """The inverse D4 permutations of squares [8, n2] and of the policy
        head's actions [8, A] (the legacy list's [8, L] for the dense
        head), on the network's device."""
        t = self.engine.tables
        act = (t.legacy_sym_action_inv if self._legacy is not None
               else t.sym_action_inv)
        return (torch.as_tensor(t.sym_square_inv, device=self.device).long(),
                torch.as_tensor(act, device=self.device).long())

    def _symmetry_expand(self, planes, pi, z):
        """[B, ...] -> [8B, ...] by the D4 group, on the device
        (example.rs:62), rows in symmetry-major order."""
        n = self.engine.n
        sq_inv, act_inv = self._sym_tables
        B = planes.shape[0]
        flat = planes.reshape(B, n * n, -1)
        planes8 = flat[:, sq_inv].transpose(0, 1)           # [8, B, n2, C]
        pi8 = pi[:, act_inv].transpose(0, 1)                # [8, B, A]
        return (planes8.reshape((8 * B,) + tuple(planes.shape[1:])),
                pi8.reshape(8 * B, -1), z.repeat(8))

    def _build_pi(self, acts, vis):
        """(padded acts [C, W], vis [C, W]) -> [C, A] normalized policy
        targets, built on the device from the sparse (action, visits)
        pairs (pads are action 0 with 0 visits); the dense head keeps the
        legacy list's columns [C, L].  Equals `Example.policy_dense`
        exactly: visit counts are below 2^24, so the float32 sums are
        exact."""
        pi = torch.zeros((acts.shape[0], self.engine.num_actions),
                         dtype=torch.float32, device=acts.device)
        pi.scatter_add_(1, acts.long(), vis)
        pi = pi / torch.clamp(vis.sum(-1, keepdim=True), min=1.0)
        return pi if self._legacy is None else pi[:, self._legacy]

    @staticmethod
    def _loss(model, planes, pi, z, world: int = 1):
        """(loss, policy part, value part); each is this rank's sum over
        the global row count (`world` equal blocks of rows), so that the
        ranks' parts sum to the global mean."""
        logits, value = model(planes)
        B = logits.shape[0] * world
        loss_p = -torch.sum(pi * torch.log_softmax(logits, -1)) / B
        loss_z = torch.sum(torch.square(z - value)) / B
        return loss_p + loss_z, loss_p, loss_z

    @staticmethod
    def _prestack(examples):
        """One pass over the epoch's examples: stacked state fields, a CSR
        (concatenated actions/visits + offsets) policy layout, and the
        result vector, so that each chunk is a few numpy row gathers."""
        n_ex = len(examples)
        keys = examples[0].state.keys()
        states = {k: np.stack([e.state[k] for e in examples]) for k in keys}
        lens = np.fromiter((len(e.actions) for e in examples), np.int64, n_ex)
        off = np.zeros(n_ex + 1, np.int64)
        np.cumsum(lens, out=off[1:])
        cat_acts = np.concatenate([e.actions for e in examples]).astype(np.int64)
        cat_vis = np.concatenate([e.visits for e in examples]).astype(np.float32)
        z = np.fromiter((e.result for e in examples), np.float32, n_ex)
        return states, off, lens, cat_acts, cat_vis, z

    def _chunk_arrays(self, pre, idx):
        """One chunk's (states, acts, vis, z) on the device, gathered from
        the prestacked epoch; the sparse pairs are padded to a power-of-two
        width.  On a card they go up from pinned memory without blocking:
        the copies queue behind the previous chunk's work, and the host
        goes on to queue this chunk's."""
        states, off, lens, cat_acts, cat_vis, z = pre
        rows = {k: v[idx] for k, v in states.items()}
        l = lens[idx]
        width = 1 << max(int(l.max()) - 1, 0).bit_length()
        cols = np.arange(width, dtype=np.int64)[None, :]
        mask = cols < l[:, None]
        pos = np.where(mask, off[idx][:, None] + cols, 0)
        acts = np.where(mask, cat_acts[pos], 0)
        vis = np.where(mask, cat_vis[pos], 0.0).astype(np.float32)

        if self.device.type == "cuda":
            def dev(x):
                return torch.as_tensor(x).pin_memory().to(self.device,
                                                          non_blocking=True)
            blocking = 0
        else:
            # counted as the blocking copies pageable memory would make
            dev, blocking = torch.as_tensor, len(rows) + 3
        with span("train.upload", sync=blocking):
            return (GameState.from_numpy(rows).map(dev), dev(acts), dev(vis),
                    dev(z[idx]))

    def _accum_chunk(self, model, states, acts, vis, z, world: int = 1):
        """Planes, targets and the 8x symmetry expansion of one chunk (this
        rank's rows of it over `world` ranks), then its loss's gradients
        ADDED to the model's `.grad` (and its batch statistics moved);
        `model` is the train module or its `ChunkGraphs`.  Returns the
        (policy, value) loss parts."""
        planes = self.observe_batch(states)
        pi = self._build_pi(acts, vis)
        planes, pi, z = self._symmetry_expand(planes, pi, z)
        loss, loss_p, loss_z = self._loss(model, planes, pi, z, world)
        loss.backward()
        return loss_p.detach(), loss_z.detach()

    def train(self, variables, examples, *, rng=None, log=print,
              chunk_size: int | None = None, chunks_in_step: int | None = None,
              passes: int = 1, mesh=None) -> dict:
        """`passes` training passes over `examples` (list of Example);
        passes=1 is reference parity.  Returns the new variables.

        Shuffles the example order with `rng.permutation` (a fresh shuffle
        per pass, ONE Adam state across passes), walks 500-example chunks
        and steps the fresh Adam on the summed gradients of every 20
        (network.rs:37-57); every chunk moves the batch statistics.  A
        trailing partial step is flushed (the reference drops it, which a
        small buffer cannot afford: no step at all would leave the
        candidate equal to the incumbent).  Empty input is a no-op.

        With `mesh` (`parallel.mesh.Mesh`; every rank calls `train` with the
        same examples and an equally seeded `rng`, so the chunk order is
        the same everywhere): each rank takes its `shard_rows` of every
        chunk, BatchNorm takes the global batch statistics, and the
        accumulated gradients are summed over the ranks (one all-reduce
        per optimizer step) before Adam steps; the logged `p=`/`z=` are
        the global means.  Same math, same effective batch; every rank
        returns the same variables.

        On a card without `mesh`, each chunk's model forward and backward
        replay as CUDA graphs (`ChunkGraphs`, captured at a shape's first
        chunk); the planes, targets, symmetry expansion, loss arithmetic
        and Adam's step stay eager.  Otherwise the chunk runs eagerly."""
        from ..parallel.mesh import (
            all_reduce_grads,
            all_reduce_sum,
            shard_rows,
        )

        if len(examples) == 0:  # tolerate empty input (no-op, ref parity)
            return variables
        chunk_size = chunk_size or CHUNK_SIZE
        chunks_in_step = chunks_in_step or CHUNKS_IN_STEP
        rng = rng or np.random.default_rng()
        with span("train"):
            model = self._train_model(variables, mesh)
            opt = self.make_optimizer(model.parameters())
            world = 1 if mesh is None else mesh.world
            graphs = (self._chunk_graphs(model)
                      if mesh is None and self.device.type == "cuda"
                      else None)
            run = model if graphs is None else graphs

            def step(lp, lz, what):
                with span("train.step"):
                    both = all_reduce_sum(mesh, torch.stack([lp, lz]))
                    with span("train.readback", sync=True):
                        lp, lz = both.tolist()
                    log(f"chunk {done}/{total_chunks} p={lp:.4f} z={lz:.4f} "
                        f"{what}")
                    all_reduce_grads(mesh, model.parameters())
                    opt.step()

            t0 = time.time()
            with span("train.prestack"):
                pre = self._prestack(examples)
            n_chunks = len(examples) // chunk_size
            total_chunks = passes * n_chunks
            log(f"train: prestacked {len(examples)} examples in "
                f"{time.time() - t0:.1f}s; {n_chunks} chunks"
                + (f" x {passes} passes" if passes > 1 else ""))
            done = 0
            for _ in range(passes):
                order = rng.permutation(len(examples))
                for i in range(n_chunks):
                    idx = order[i * chunk_size:(i + 1) * chunk_size]
                    with span("train.chunk"):
                        with span("train.assemble"):
                            arrays = self._chunk_arrays(pre,
                                                        shard_rows(mesh, idx))
                        replays = 0 if graphs is None else graphs.replays
                        with span("train.forward_backward"):
                            lp, lz = self._accum_chunk(run, *arrays, world)
                    count("train.chunks")
                    if graphs is not None and graphs.replays > replays:
                        count("train.graph_replays")
                    done += 1
                    if done % chunks_in_step == 0:
                        step(lp, lz, "step")
                        # in place: the backward graph adds into .grad
                        opt.zero_grad(set_to_none=False)
            if total_chunks % chunks_in_step != 0:
                step(lp, lz, "step (trailing flush)")
            dt = time.time() - t0
            if dt > 0:
                log(f"train: {total_chunks} chunks in {dt:.1f}s "
                    f"({total_chunks * chunk_size / dt:,.0f} examples/s)")
            return {k: v.detach().clone()
                    for k, v in model.state_dict().items()}
