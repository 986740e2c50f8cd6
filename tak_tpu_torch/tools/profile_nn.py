"""NN forward formulation shootout on the card (counterpart of
`tools/profile_nn.py`).

Compares the convolution tower against manual matmul formulations of the
same 3x3 convs (the board is 6x6, so conv lowering overheads can
dominate): 16 residual blocks of 128 channels on [BENCH_FLAT, 6, 6, 92]
bf16 planes, a 251-plane policy conv and a dense value head, the weights
drawn from numpy seed 0 in the JAX script's order and shapes (NHWC
planes, HWIO kernels), so that both packages see the same numbers.  The
four formulations:
  * cuDNN: `F.conv2d` (the JAX script's "XLA conv"), on NCHW views of the
    NHWC planes (channels-last memory) with the kernels carried to OIHW;
  * 9 shifted bf16 matmuls accumulated in float32 (`torch.mm` with
    `out_dtype=float32` on the card);
  * one im2col matmul, [B*36, 9*Cin] x [9*Cin, Cout] (explicit shifts);
  * int8: 9 shifted `torch._int_mm` with int32 accumulation and the JAX
    script's toy quantization.  On the card `_int_mm` takes K and N that
    are multiples of 8: the stem's 92 input channels and the policy's 251
    outputs are padded with zeros, which is exact.
The bf16 formulations compute the same function (up to the order of the
float32 sums); the last line prints how far the matmul ones are from the
cuDNN tower.  The lines say "cuDNN" where the JAX script's say "XLA".

    python -m tak_tpu_torch.tools.profile_nn [--cpu]

Knobs (environment variables, the JAX script's names and defaults):
BENCH_FLAT (4096: the batch).  Runs on the CUDA device unless `--cpu` is
given.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from .timing import knob, open_device, parser, timeit

N = 6
C = 128
BLOCKS = 16
CIN = 92
A_OUT = 251
BF16 = torch.bfloat16


def draw_weights(rng, batch: int, blocks: int = BLOCKS) -> dict:
    """The JAX script's planes and weights as float32 numpy arrays, in its
    order of draws (the JAX script then rounds them to bf16)."""
    return {
        "x0": rng.standard_normal((batch, N, N, CIN), np.float32),
        "w_stem": rng.standard_normal((3, 3, CIN, C), np.float32) * 0.05,
        "ws": rng.standard_normal((2 * blocks, 3, 3, C, C),
                                  np.float32) * 0.05,
        "w_pol": rng.standard_normal((3, 3, C, A_OUT), np.float32) * 0.05,
        "w_val": rng.standard_normal((N * N * C, 1), np.float32) * 0.05,
    }


def mm_f32(a, b):
    """a @ b of bf16 operands, summed and returned in float32: cuBLAS with
    a float32 output on the card; on the CPU the float32 product of the
    operands, which is the same function (the product of two bf16 values
    is exact in float32) up to the order of the sums."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _pad_hw(x):
    """Zero-pad the two board axes of NHWC `x` by one."""
    return F.pad(x, (0, 0, 1, 1, 1, 1))


def conv_mm(x, w):
    """3x3 SAME conv as 9 shifted matmuls accumulated in f32.

    x [B, N, N, Cin]; w [3, 3, Cin, Cout]."""
    B, n, _, cin = x.shape
    xp = _pad_hw(x)
    acc = None
    for dy in range(3):
        for dx in range(3):
            prod = mm_f32(xp[:, dy:dy + n, dx:dx + n, :].reshape(-1, cin),
                          w[dy, dx])
            acc = prod if acc is None else acc + prod
    return acc.reshape(B, n, n, -1).to(BF16)


def conv_im2col(x, w):
    """3x3 SAME conv as one big [B*36, 9*Cin] x [9*Cin, Cout] matmul."""
    B, n, _, cin = x.shape
    xp = _pad_hw(x)
    cols = torch.cat([xp[:, dy:dy + n, dx:dx + n, :]
                      for dy in range(3) for dx in range(3)], -1)
    out = mm_f32(cols.reshape(-1, 9 * cin), w.reshape(9 * cin, -1))
    return out.reshape(B, n, n, -1).to(BF16)


def conv_mm_i8(x_i8, w_i8):
    """int8 conv: 9 shifted int8 matmuls, int32 accumulation.  The input
    channels and the outputs are zero-padded to multiples of 8."""
    B, n, _, cin = x_i8.shape
    cout = w_i8.shape[-1]
    kp, op = -(-cin // 8) * 8, -(-cout // 8) * 8
    xp = F.pad(x_i8, (0, kp - cin, 1, 1, 1, 1))
    wp = F.pad(w_i8, (0, op - cout, 0, kp - cin))
    acc = None
    for dy in range(3):
        for dx in range(3):
            prod = torch._int_mm(
                xp[:, dy:dy + n, dx:dx + n, :].reshape(-1, kp), wp[dy, dx])
            acc = prod if acc is None else acc + prod
    return acc.reshape(B, n, n, op)[..., :cout]


def _q(v):
    """The JAX script's toy quantization: round(16 v) clipped to int8."""
    return torch.clamp(torch.round(v * 16.0), -127, 127).to(torch.int8)


def _i8(v):
    return torch.clamp(v, -127, 127).to(torch.int8)


class Towers:
    """The four formulations over one set of weights (`draw_weights`) on
    `device`.  Each tower maps NHWC bf16 planes to (policy [B, N, N, 251]
    NHWC, value [B] float32)."""

    def __init__(self, weights: dict, device):
        def bf16(a):
            return torch.as_tensor(a, device=device).to(BF16)

        self.x0 = bf16(weights["x0"])
        self.w_stem = bf16(weights["w_stem"])
        self.ws = bf16(weights["ws"])
        self.w_pol = bf16(weights["w_pol"])
        self.w_val = bf16(weights["w_val"])
        self.blocks = self.ws.shape[0] // 2

        # cuDNN's layout: HWIO -> OIHW kernels
        def oihw(w):
            return w.permute(3, 2, 0, 1).contiguous()

        self.o_stem = oihw(self.w_stem)
        self.o_ws = [oihw(w) for w in self.ws]
        self.o_pol = oihw(self.w_pol)

    def value(self, x_nhwc):
        B = x_nhwc.shape[0]
        return torch.tanh((x_nhwc.reshape(B, -1) @ self.w_val).float())[:, 0]

    def conv(self, x):
        """cuDNN `conv2d` on NCHW views of the planes."""
        def conv(x, w):
            return F.conv2d(x, w, padding=1)

        x = torch.relu(conv(x.permute(0, 3, 1, 2), self.o_stem))
        for i in range(self.blocks):
            y = torch.relu(conv(x, self.o_ws[2 * i]))
            y = conv(y, self.o_ws[2 * i + 1])
            x = torch.relu(x + y)
        p = conv(x, self.o_pol).permute(0, 2, 3, 1)
        return p, self.value(x.permute(0, 2, 3, 1))

    def _matmul(self, x, conv):
        x = torch.relu(conv(x, self.w_stem))
        for i in range(self.blocks):
            y = torch.relu(conv(x, self.ws[2 * i]))
            y = conv(y, self.ws[2 * i + 1])
            x = torch.relu(x + y)
        return conv(x, self.w_pol), self.value(x)

    def mm(self, x):
        return self._matmul(x, conv_mm)

    def im2col(self, x):
        return self._matmul(x, conv_im2col)

    def i8(self, x):
        """Fixed scales, requantized to int8 between layers; the policy
        comes out in int32."""
        xq = _q(x.float())
        wq_stem = _q(self.w_stem.float() * 8)
        wqs = _q(self.ws.float() * 8)
        xq = _i8(conv_mm_i8(xq, wq_stem) >> 7)
        for i in range(self.blocks):
            yq = _i8(conv_mm_i8(xq, wqs[2 * i]) >> 7)
            yi = conv_mm_i8(yq, wqs[2 * i + 1])
            xq = _i8((yi >> 7) + xq)
        p = conv_mm_i8(xq, _q(self.w_pol.float() * 8))
        return p, self.value(xq.to(BF16))


def max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def main(argv=None, env=None):
    """Returns {label: seconds}, the two differences and the cuDNN policy's
    largest magnitude ("max_abs_policy") included."""
    env = os.environ if env is None else env
    device = open_device(parser("profile_nn", __doc__).parse_args(argv).cpu)
    B = knob(env, "BENCH_FLAT", 4096)
    towers = Towers(draw_weights(np.random.default_rng(0), B, BLOCKS), device)
    x0 = towers.x0
    t = {}
    outs = {}
    for label, fn in (("tower cuDNN conv (bf16)", towers.conv),
                      ("tower 9-shift matmul (bf16)", towers.mm),
                      ("tower im2col matmul (bf16)", towers.im2col),
                      ("tower int8 9-shift matmul", towers.i8)):
        with torch.no_grad():
            outs[label], t[label] = timeit(label, fn, device, x0, width=34)

    # numeric sanity: matmul formulations agree with the cuDNN conv
    p1 = outs["tower cuDNN conv (bf16)"][0]
    t["d_mm"] = max_diff(p1, outs["tower 9-shift matmul (bf16)"][0])
    t["d_im2col"] = max_diff(p1, outs["tower im2col matmul (bf16)"][0])
    t["max_abs_policy"] = float(p1.float().abs().max())
    print(f"max|cudnn - mm| = {t['d_mm']:.4f}  "
          f"max|cudnn - im2col| = {t['d_im2col']:.4f}", flush=True)
    return t


if __name__ == "__main__":
    main()
