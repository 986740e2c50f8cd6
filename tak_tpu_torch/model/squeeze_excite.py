"""Leela Chess Zero's squeeze-and-excitation unit as a residual block's
epilogue (lczero-training `tf/tfprocess.py`: `squeeze_excitation`,
`ApplySqueezeExcitation`; Hu et al., arXiv:1709.01507).

For the block's second BatchNorm output y and its input x (NCHW, C
channels):

    s     = relu(W1 · mean_hw(y) + b1)         W1: C -> S
    e     = W2 · s + b2                        W2: S -> 2C
    γ, β  = e[:, :C], e[:, C:]
    out   = relu(sigmoid(γ) ⊙ y + β + x)

The means, both dense layers, the ReLU and the sigmoid run in float32
(the dense weights stay float32 in every model, the folded bf16 one
included); the last line in float32, rounded once to y's type.

Two versions of the same function:
  * `se_epilogue_plain`: torch ops, taken on the CPU and wherever autograd
    records (the learner);
  * `se_epilogue_kernel`: `tak_se_epilogue` of `csrc/squeeze_excite.cu`,
    taken for CUDA tensors under `torch.no_grad()` (the folded inference
    model): channels-last bf16 y and x, C a multiple of 8 whose groups of
    8 divide 256, at most 2,048 values of 8 channels a row, S dividing 256;
    anything else raises.
`se_epilogue` picks between them.
"""

from __future__ import annotations

import functools

import torch

from ..kernels import build as kb

THREADS = 256          # a block of `csrc/squeeze_excite.cu`
MAX_VECTORS = 8        # 8-channel vectors a thread holds of one row


def se_epilogue_plain(y, x, w1, b1, w2, b2):
    """The unit in torch ops: y, x [R, C, H, W]; w1 [S, C], b1 [S], w2
    [2C, S], b2 [2C] float32.  Returns [R, C, H, W] in y's type."""
    C = y.shape[1]
    yf = y.float()
    s = torch.relu(yf.mean((2, 3)) @ w1.t() + b1)
    e = s @ w2.t() + b2
    gate = torch.sigmoid(e[:, :C])[:, :, None, None]
    beta = e[:, C:][:, :, None, None]
    return torch.relu(gate * yf + beta + x.float()).to(y.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(y, x, w1, b1, w2, b2) -> tuple:
    """(rows, HW, C, S) of tensors the kernel takes; raises otherwise."""
    if y.dtype != torch.bfloat16 or x.dtype != torch.bfloat16:
        raise ValueError(f"tak_se kernel takes bf16 y and x, not {y.dtype} "
                         f"and {x.dtype}")
    if y.dim() != 4 or y.shape != x.shape:
        raise ValueError(f"tak_se kernel takes y and x of one NCHW shape, not "
                         f"{tuple(y.shape)} and {tuple(x.shape)}")
    R, C, H, W = y.shape
    S = w1.shape[0]
    G = C // 8
    if C % 8 or THREADS % G:
        raise ValueError(f"tak_se kernel takes C a multiple of 8 whose groups "
                         f"of 8 divide {THREADS}, not {C}")
    if H * W * G > THREADS * MAX_VECTORS:
        raise ValueError(f"tak_se kernel takes at most "
                         f"{THREADS * MAX_VECTORS * 8} values a row, not "
                         f"{H * W * C}")
    if S <= 0 or THREADS % S or C % (THREADS // S):
        raise ValueError(f"tak_se kernel takes S dividing {THREADS} (and C "
                         f"split into {THREADS} / S parts), not S={S}, C={C}")
    for name, t, shape in (("w1", w1, (S, C)), ("b1", b1, (S,)),
                           ("w2", w2, (2 * C, S)), ("b2", b2, (2 * C,))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != y.device or not t.is_contiguous()):
            raise ValueError(f"tak_se kernel takes a contiguous float32 "
                             f"{name} of shape {shape} on {y.device}")
    return R, H * W, C, S


def se_epilogue_kernel(y, x, w1, b1, w2, b2):
    """The unit on the `tak_se_epilogue` kernel: one launch, y and x laid
    out channels-last first (no copy where they are already)."""
    y = y.contiguous(memory_format=torch.channels_last)
    x = x.contiguous(memory_format=torch.channels_last)
    R, HW, C, S = _check(y, x, w1, b1, w2, b2)
    out = torch.empty_like(y, memory_format=torch.channels_last)
    if R == 0:
        return out
    for t in (y, x, out):
        if t.data_ptr() % 16:
            raise ValueError("tak_se kernel takes 16-byte aligned tensors")
    dev = y.device
    lib = kb.library("squeeze_excite")
    kb.check(lib.tak_se_epilogue(
        R, HW, C, S, _sm_count(dev), kb.ptr(y), kb.ptr(x), kb.ptr(w1),
        kb.ptr(b1), kb.ptr(w2), kb.ptr(b2), kb.ptr(out), kb.stream_ptr(dev)),
        "tak_se_epilogue")
    kb.LAUNCHES["tak_se_epilogue"] += 1
    return out


def se_epilogue(y, x, w1, b1, w2, b2):
    """The kernel for CUDA tensors outside autograd, the plain version
    otherwise (the CPU, and training on the card)."""
    if y.device.type == "cuda" and not torch.is_grad_enabled():
        return se_epilogue_kernel(y, x, w1, b1, w2, b2)
    return se_epilogue_plain(y, x, w1, b1, w2, b2)
