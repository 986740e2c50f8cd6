"""Train-mode BatchNorm as one `torch.autograd.Function` (flax 0.12.3's
`nn.BatchNorm` over the channels of NCHW input, as `resnet.BatchNorm`
states it).

Forward: the batch mean and the biased variance E[x^2] - E[x]^2, clipped
at 0, in float32 (float64 for float64 input); the running statistics move
by `running = 0.99 * running + 0.01 * batch` and store that variance; y =
(x - mean) * (rsqrt(var + eps) * weight) + bias in float32, returned in
the input's type.  Backward, written out: with x-hat = (x - mean) / std,

    dx      = weight / std * (dy - mean(dy) - x-hat * mean(dy * x-hat))
    dweight = sum(dy * x-hat),   dbias = sum(dy)

where the term through the variance (the last one of dx) is zero in a
channel whose variance was clipped, as autograd's clamp gives.

With `mesh` (a `parallel.mesh.Mesh` of W ranks, each holding an equal
block of rows), the statistics are the global batch's: the ranks' [2, C]
means over W go through one all-reduce before the statistics are
finished, and the [2, C] gradient sums through one before the input
gradient, so that every rank's dx is that of one process holding the
whole batch; dweight and dbias stay this rank's own sums (the learner sums
the parameters' gradients over the ranks).  At W = 1 both are skipped.

Two versions of the same Function:
  * `BatchNormPlain`: torch ops, taken for a CPU tensor;
  * `BatchNormKernel`: the `tak_bn_*` kernels of `csrc/batch_norm.cu`,
    taken for a CUDA tensor, which must be channels-last with C a multiple
    of 8 (at most 2,048) in bf16, float32 or float64; anything else
    raises.
`batch_norm_train` picks by the input's device, and lays a CUDA input out
channels-last (the learner's already is: `Network._train_model`).
"""

from __future__ import annotations

import functools

import torch
from torch.autograd.function import once_differentiable

from ..kernels import build as kb
from ..parallel.mesh import all_reduce_sum

BN_EPS = 1e-5        # flax nn.BatchNorm default
BN_MOMENTUM = 0.99   # flax's: running = 0.99 * running + 0.01 * batch

_KIND = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}


def _world(mesh) -> int:
    return 1 if mesh is None else mesh.world


def _over_ranks(mesh, t):
    """The sum of `t` over the mesh's ranks; `t` itself at W = 1."""
    return all_reduce_sum(mesh, t) if _world(mesh) > 1 else t


def _channel(v):
    return v[:, None, None]


class BatchNormPlain(torch.autograd.Function):
    """The Function in torch ops: (x, weight, bias, running_mean,
    running_var, mesh) -> y; moves the running statistics in place."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, mesh):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean((0, 2, 3))
        ex2 = (xf * xf).mean((0, 2, 3))
        if _world(mesh) > 1:
            both = torch.stack([mean, ex2]) / mesh.world
            mean, ex2 = all_reduce_sum(mesh, both)
        gap = ex2 - mean * mean
        var = torch.clamp(gap, min=0.0)
        running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
        running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
        inv = torch.rsqrt(var + BN_EPS)
        y = (xf - _channel(mean)) * _channel(inv * weight) + _channel(bias)
        # autograd's clamp passes the gradient where gap >= 0
        ctx.save_for_backward(x, weight, mean, inv, (gap >= 0).to(mean.dtype))
        ctx.mesh = mesh
        return y.to(x.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, mean, inv, keep = ctx.saved_tensors
        xf = x.to(mean.dtype)
        dyf = dy.to(mean.dtype)
        xhat = (xf - _channel(mean)) * _channel(inv)
        sums = torch.stack([dyf.sum((0, 2, 3)), (dyf * xhat).sum((0, 2, 3))])
        total = _over_ranks(ctx.mesh, sums)
        count = x.numel() // x.shape[1] * _world(ctx.mesh)
        mdy = total[0] / count
        mdyx = total[1] / count * keep
        dx = ((dyf - _channel(mdy) - xhat * _channel(mdyx))
              * _channel(weight * inv))
        return (dx.to(x.dtype), sums[1].to(weight.dtype),
                sums[0].to(weight.dtype), None, None, None)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _groups(device: torch.device, rows: int) -> int:
    """Blocks of the two sums kernels: about 2 an SM, each at least 256
    rows."""
    return max(1, min(2 * _sm_count(device), rows // 256))


def _check(x, weight, bias, running_mean, running_var) -> tuple:
    """(kind, rows, C) of a tensor the kernels take; raises otherwise."""
    if x.dtype not in _KIND:
        raise ValueError(f"tak_bn kernels take bf16, float32 or float64, "
                         f"not {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"tak_bn kernels take a channels-last NCHW tensor, "
                         f"not shape {tuple(x.shape)} strides {x.stride()}")
    C = x.shape[1]
    if C % 8 or C > 2048:
        raise ValueError(f"tak_bn kernels take 8 to 2,048 channels in steps "
                         f"of 8, not {C}")
    rows = x.numel() // C
    if rows == 0:
        raise ValueError("tak_bn kernels take a non-empty batch")
    if x.data_ptr() % 16:
        raise ValueError("tak_bn kernels take a 16-byte aligned tensor")
    for name, t in (("weight", weight), ("bias", bias),
                    ("running_mean", running_mean),
                    ("running_var", running_var)):
        if (t.dtype != torch.float32 or t.shape != (C,) or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"tak_bn kernels take a contiguous float32 "
                             f"{name} of shape ({C},) on {x.device}")
    return _KIND[x.dtype], rows, C


def _launch(entry: str, *args) -> None:
    kb.check(getattr(kb.library("batch_norm"), entry)(*args), entry)
    kb.LAUNCHES[entry] += 1


def _finalize(kind, C, G, divisor, partials, sums, weight, running_mean,
              running_var, stats, stream) -> None:
    def p(t):
        return None if t is None else kb.ptr(t)

    _launch("tak_bn_finalize", kind, C, G, divisor, p(partials), p(sums),
            p(weight), p(running_mean), p(running_var), p(stats), stream)


class BatchNormKernel(torch.autograd.Function):
    """The Function on the `tak_bn_*` kernels: six launches a forward and
    backward (statistics, finalize, normalize; gradient sums, finalize,
    input gradient), the sums combined in a fixed order."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, mesh):
        kind, rows, C = _check(x, weight, bias, running_mean, running_var)
        acc = torch.promote_types(x.dtype, torch.float32)
        dev = x.device
        stream = kb.stream_ptr(dev)
        G = _groups(dev, rows)
        partials = torch.empty((G, 2, C), dtype=acc, device=dev)
        sums = torch.empty((2, C), dtype=acc, device=dev)
        stats = torch.empty((4, C), dtype=acc, device=dev)
        _launch("tak_bn_stats", kind, rows, C, G, kb.ptr(x), kb.ptr(partials),
                stream)
        if _world(mesh) > 1:
            _finalize(kind, C, G, float(rows), partials, sums, None, None,
                      None, None, stream)
            sums = all_reduce_sum(mesh, sums / mesh.world)
            partials = None
        _finalize(kind, C, G, float(rows), partials, sums, weight,
                  running_mean, running_var, stats, stream)
        y = torch.empty_like(x, memory_format=torch.channels_last)
        _launch("tak_bn_normalize", kind, rows, C, _sm_count(dev), kb.ptr(x),
                kb.ptr(stats), kb.ptr(bias), kb.ptr(y), stream)
        ctx.save_for_backward(x, weight, stats)
        ctx.mesh = mesh
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, stats = ctx.saved_tensors
        kind, rows, C = _KIND[x.dtype], x.numel() // x.shape[1], x.shape[1]
        dy = dy.to(x.dtype).contiguous(memory_format=torch.channels_last)
        dev = x.device
        stream = kb.stream_ptr(dev)
        G = _groups(dev, rows)
        partials = torch.empty((G, 2, C), dtype=stats.dtype, device=dev)
        sums = torch.empty((2, C), dtype=stats.dtype, device=dev)
        _launch("tak_bn_grad_sums", kind, rows, C, G, kb.ptr(x), kb.ptr(dy),
                kb.ptr(stats), kb.ptr(partials), stream)
        _finalize(kind, C, G, 1.0, partials, sums, None, None, None, None,
                  stream)
        total = _over_ranks(ctx.mesh, sums)
        dx = torch.empty_like(x, memory_format=torch.channels_last)
        _launch("tak_bn_grad_input", kind, rows, C, _sm_count(dev),
                float(rows * _world(ctx.mesh)), kb.ptr(x), kb.ptr(dy),
                kb.ptr(stats), kb.ptr(total), kb.ptr(weight), kb.ptr(dx),
                stream)
        return (dx, sums[1].to(weight.dtype), sums[0].to(weight.dtype), None,
                None, None)


def batch_norm_train(x, weight, bias, running_mean, running_var, mesh=None):
    """Train-mode BatchNorm of NCHW `x`: the kernels for a CUDA tensor, laid
    out channels-last first (a copy only where it is not: cuDNN's float64
    convolutions give contiguous NCHW), the plain version for a CPU one."""
    if x.device.type == "cuda":
        fn = BatchNormKernel
        x = x.contiguous(memory_format=torch.channels_last)
    elif x.device.type == "cpu":
        fn = BatchNormPlain
    else:
        raise ValueError(f"no BatchNorm for device {x.device}")
    return fn.apply(x, weight, bias, running_mean, running_var, mesh)
