"""The learner's chunk as CUDA graphs: the train module's forward (planes
[rows, n, n, C] -> (logits, value)) and backward (the two outputs'
gradients -> the parameters' `.grad`) captured once for each shape of the
planes, then replayed on every chunk.

`ChunkGraphs(model)` stands in for the persistent train module of a
`Network` (`Network._train_model`) in `Network.train` on a card without a
mesh: calling it copies the chunk's planes into the forward graph's
input and replays it, and returns the outputs through an autograd
Function whose backward copies the output gradients in and replays the
backward graph.  The loss arithmetic around the two stays eager, so the
loss tensors are fresh ones that no later replay overwrites.  The module
itself stays plain and runs eagerly at any batch size.

The backward graph adds into the parameters' `.grad` itself (autograd's
in-place accumulation, captured), so every `.grad` must exist before the
capture and stay the same tensor: `Network._train_model` gives zeros and
`Network.train` zeroes them in place after each Adam step.  `holds` says
whether the graphs still address the module's tensors.

A capture first runs `WARMUP` eager forwards and backwards on a side
stream (cuDNN and cuBLAS pick their algorithms and workspaces, the
kernels' libraries load), then captures the forward and the backward in
a memory pool of their own.  Neither leaves a trace in the model: the
buffers (running statistics, `num_batches_tracked`) and every `.grad` are
saved before and put back after.  Every kernel in the graphs is one the
eager module launches (the `tak_bn_*` BatchNorm kernels on the current
stream, which is the capture's; no collective, no host sync).

Counters (`utils.profiling.count`): `train.graph_captures`, one a
capture.  `kernels.build.LAUNCHES` counts kernels executed: the launches
recorded while a graph was captured are taken back out, and added again
at each replay of it.
"""

from __future__ import annotations

import collections

import torch
from torch.autograd.function import once_differentiable

from ..kernels import build as kb
from ..utils.profiling import count

WARMUP = 2


class _Pair:
    """The two graphs of one shape, their static tensors and the launches
    each replays."""

    __slots__ = ("planes", "outputs", "grad_outputs", "forward", "backward",
                 "forward_launches", "backward_launches")


class _Replay(torch.autograd.Function):
    """(graphs, pair, planes, anchor) -> (logits, value): `anchor`, a
    parameter, makes autograd call the backward, which returns no
    gradient: the backward graph has added them to `.grad`."""

    @staticmethod
    def forward(ctx, graphs, pair, planes, anchor):
        pair.planes.copy_(planes)
        pair.forward.replay()
        kb.LAUNCHES.update(pair.forward_launches)
        ctx.graphs, ctx.pair = graphs, pair
        return tuple(o.detach() for o in pair.outputs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        pair = ctx.pair
        for static, g in zip(pair.grad_outputs, grads):
            static.copy_(g)
        pair.backward.replay()
        kb.LAUNCHES.update(pair.backward_launches)
        ctx.graphs.replays += 1
        return None, None, None, None


class ChunkGraphs:
    """The train module `model` (on a card, in train mode, every `.grad`
    allocated) behind a forward and a backward graph for each shape and
    dtype of the planes; `replays` counts the chunks whose forward and
    backward both replayed."""

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self._params = list(model.parameters())
        self._grads = [p.grad for p in self._params]
        if any(g is None for g in self._grads):
            raise ValueError("ChunkGraphs needs every parameter's .grad")
        self._pairs: dict = {}
        self.replays = 0

    def holds(self, model: torch.nn.Module) -> bool:
        """Whether the graphs address `model`'s parameters and `.grad`."""
        return self.model is model and all(
            p.grad is g for p, g in zip(self._params, self._grads))

    def __call__(self, planes):
        key = (tuple(planes.shape), planes.dtype)
        pair = self._pairs.get(key)
        if pair is None:
            pair = self._pairs[key] = self._capture(planes)
        return _Replay.apply(self, pair, planes, self._params[0])

    def _warm_up(self, planes) -> None:
        """`WARMUP` eager forwards and backwards on a side stream; their
        autograd graphs die here, so that the capture's nodes are its
        own."""
        main = torch.cuda.current_stream(planes.device)
        side = torch.cuda.Stream(planes.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                outputs = self.model(planes)
                torch.autograd.backward(
                    outputs, [torch.zeros_like(o) for o in outputs])
                del outputs
        main.wait_stream(side)

    def _capture(self, planes) -> _Pair:
        model = self.model
        count("train.graph_captures")
        kept = list(model.buffers()) + self._grads
        saved = [t.clone() for t in kept]
        pair = _Pair()
        pair.planes = planes.clone()
        self._warm_up(pair.planes)
        executed = collections.Counter(kb.LAUNCHES)
        pool = torch.cuda.graph_pool_handle()
        pair.forward, pair.backward = torch.cuda.CUDAGraph(), \
            torch.cuda.CUDAGraph()
        with torch.cuda.graph(pair.forward, pool=pool):
            outputs = model(pair.planes)
        pair.forward_launches = collections.Counter(kb.LAUNCHES) - executed
        pair.grad_outputs = tuple(torch.zeros_like(o) for o in outputs)
        before = collections.Counter(kb.LAUNCHES)
        with torch.cuda.graph(pair.backward, pool=pool):
            torch.autograd.backward(outputs, pair.grad_outputs)
        pair.backward_launches = collections.Counter(kb.LAUNCHES) - before
        pair.outputs = tuple(o.detach() for o in outputs)
        kb.LAUNCHES.clear()
        kb.LAUNCHES.update(executed)
        with torch.no_grad():
            for t, s in zip(kept, saved):
                t.copy_(s)
        return pair
