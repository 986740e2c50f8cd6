"""Train-mode BatchNorm's Function (`tak_tpu_torch/model/batch_norm.py`)
on the CPU: the plain version with its backward written out, against
autograd through the module's former formulation (flax's arithmetic in
torch ops, kept below as `reference`).

  * forward: y and the running statistics are the reference's exactly,
    in every dtype (the same ops in the same order);
  * backward: float64 within 1e-10 (relative to each tensor's largest
    entry); float32 within 1e-5; bf16's dx within one bf16 step of its
    largest entry (2^-7: the two sides round their float32 dx to bf16
    independently), its float32 parameter gradients within 1e-4;
  * a channel whose E[x^2] - E[x]^2 comes out below 0 (the clip at 0
    active: the term through the variance drops, as autograd's clamp
    gives), a channels-last input, eval mode, the module;
  * two gloo ranks of the CPU, each holding half the rows: global
    statistics and gradients equal to one process's on the whole batch
    (float64 within 1e-10, the float32 parameters' gradients 1e-6);
  * the benchmark's reader of the kernels' device ms a chunk.
The CUDA kernels are held against the plain version on the card by
`chip_smoke.py`.
"""

from pathlib import Path

import pytest
import torch

from tak_tpu_torch.model.batch_norm import BN_EPS, BatchNormPlain
from tak_tpu_torch.model.resnet import BatchNorm
from tak_tpu_torch.parallel.mesh import spawn_local

from tests import torch_parallel_ranks as R

REPO = Path(__file__).resolve().parents[1]
BN_MOMENTUM = 0.99
# backward tolerances, relative to the largest entry of the reference's
# tensor (dx in bf16: one bf16 step at that entry)
TOL = {torch.float64: (1e-10, 1e-10), torch.float32: (1e-5, 1e-5),
       torch.bfloat16: (2.0 ** -7, 1e-4)}


def reference(x, weight, bias, running_mean, running_var):
    """The module's train-mode forward before the Function, differentiated
    by autograd."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean((0, 2, 3))
    ex2 = (xf * xf).mean((0, 2, 3))
    var = torch.clamp(ex2 - mean * mean, min=0.0)
    with torch.no_grad():
        running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
        running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
    mul = torch.rsqrt(var + BN_EPS) * weight
    y = (xf - mean[:, None, None]) * mul[:, None, None]
    return (y + bias[:, None, None]).to(x.dtype)


def inputs(dtype, channels_last=False, shape=(8, 16, 4, 4), seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g, dtype=torch.float64) * 3 + 1)
    dy = torch.randn(shape, generator=g, dtype=torch.float64)
    if channels_last:
        x = x.to(memory_format=torch.channels_last)
        dy = dy.to(memory_format=torch.channels_last)
    C = shape[1]
    params = (torch.rand(C, generator=g) + 0.5, torch.randn(C, generator=g),
              torch.randn(C, generator=g), torch.rand(C, generator=g) + 0.5)
    return x.to(dtype), dy.to(dtype), params


def both(fn_a, fn_b, x, dy, params):
    """(y, dx, dweight, dbias, running_mean, running_var) of each side."""
    out = []
    for fn in (fn_a, fn_b):
        xg = x.clone().requires_grad_()
        w, b = (p.clone().requires_grad_() for p in params[:2])
        rm, rv = params[2].clone(), params[3].clone()
        y = fn(xg, w, b, rm, rv)
        y.backward(dy)
        out.append((y.detach(), xg.grad, w.grad, b.grad, rm, rv))
    return out


def plain(x, w, b, rm, rv):
    return BatchNormPlain.apply(x, w, b, rm, rv, None)


def assert_rel(got, want, tol, what):
    scale = want.abs().max().double().clamp(min=1e-300)
    err = float((got.double() - want.double()).abs().max() / scale)
    assert err <= tol, f"{what}: {err:.3e} over {tol:.1e}"


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_plain_matches_autograd(dtype, channels_last):
    x, dy, params = inputs(dtype, channels_last)
    got, want = both(plain, reference, x, dy, params)
    for i, name in ((0, "y"), (4, "running_mean"), (5, "running_var")):
        assert torch.equal(got[i], want[i]), name
    dx_tol, param_tol = TOL[dtype]
    assert_rel(got[1], want[1], dx_tol, "dx")
    assert got[1].dtype == dtype
    assert_rel(got[2], want[2], param_tol, "dweight")
    assert_rel(got[3], want[3], param_tol, "dbias")
    if channels_last:
        assert got[0].is_contiguous(memory_format=torch.channels_last)


def test_clipped_variance():
    """Channel 0 holds one value in float32, whose E[x^2] - E[x]^2 comes
    out below 0: the variance clips to 0 there and the gradient takes no
    term through it, as autograd's clamp gives; the other channels are
    untouched by it."""
    x, dy, params = inputs(torch.float32, shape=(4, 8, 3, 3), seed=1)
    x[:, 0] = 0.1
    xf = x.double().float()
    mean = xf.mean((0, 2, 3))
    assert float((xf * xf).mean((0, 2, 3))[0] - mean[0] * mean[0]) < 0
    got, want = both(plain, reference, x, dy, params)
    assert torch.equal(got[0], want[0])
    assert_rel(got[1], want[1], 1e-5, "dx")
    # the clipped channel's dx is weight / sqrt(eps) * (dy - mean(dy))
    d0 = dy[:, 0] - dy[:, 0].mean()
    expect = d0 * params[0][0] * torch.rsqrt(torch.tensor(BN_EPS))
    assert_rel(got[1][:, 0], expect, 1e-5, "clipped channel's dx")
    assert_rel(got[2], want[2], 1e-5, "dweight")
    assert_rel(got[3], want[3], 1e-5, "dbias")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_module_modes(dtype):
    """The module: train mode goes through the Function (the reference's
    y and running statistics exactly, its gradients within TOL), eval
    mode normalises with the running statistics as before, bit for bit."""
    x, dy, params = inputs(dtype, channels_last=True, shape=(4, 16, 3, 3))
    bn = BatchNorm(16)
    with torch.no_grad():
        bn.weight.copy_(params[0])
        bn.bias.copy_(params[1])
        bn.running_mean.copy_(params[2])
        bn.running_var.copy_(params[3])
    xg = x.clone().requires_grad_()
    y = bn.train()(xg)
    y.backward(dy)
    (want_y, want_dx, want_dw, want_db, rm, rv), = both(
        reference, reference, x, dy, params)[:1]
    assert torch.equal(y, want_y)
    assert torch.equal(bn.running_mean, rm)
    assert torch.equal(bn.running_var, rv)
    assert int(bn.num_batches_tracked) == 0
    dx_tol, param_tol = TOL[dtype]
    assert_rel(xg.grad, want_dx, dx_tol, "dx")
    assert_rel(bn.weight.grad, want_dw, param_tol, "dweight")
    assert_rel(bn.bias.grad, want_db, param_tol, "dbias")

    bn.eval()
    xf = x.float()
    mul = torch.rsqrt(bn.running_var + BN_EPS) * bn.weight
    want = ((xf - bn.running_mean[:, None, None]) * mul[:, None, None]
            + bn.bias[:, None, None]).to(dtype)
    with torch.no_grad():
        assert torch.equal(bn(x), want)
    assert torch.equal(bn.running_mean, rm)


@pytest.fixture(scope="module")
def bn_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("bn_ranks")
    spawn_local(R.bn_rank_main, 2, (str(out),), backend="gloo",
                timeout_s=240)
    return [torch.load(out / f"bn_rank{r}.pt") for r in range(2)]


@pytest.mark.parametrize("key", ["y", "dx", "dweight", "dbias",
                                 "running_mean", "running_var"])
def test_mesh_matches_one_process(bn_ranks, key):
    """Two ranks, each with half the rows: y and dx are the rows of one
    process's, the ranks' parameter gradients sum to its, and both ranks
    hold its running statistics: within 1e-10 in float64 (the constant
    channel's variance is rounding, about 1e-16 either way, which moves
    its 1/sqrt(var + 1e-5) by about 1e-11 of itself), and the float32
    parameters' gradients within 1e-6 (each rank's is rounded to float32
    before the sum)."""
    whole = R.bn_run(*R.bn_inputs())
    ranks = [r[key] for r in bn_ranks]
    tol = 1e-10
    if key in ("y", "dx"):
        got = torch.cat(ranks)
    elif key in ("dweight", "dbias"):
        got = ranks[0] + ranks[1]
        tol = 1e-6
    else:
        assert torch.equal(ranks[0], ranks[1])
        got = ranks[0]
    assert_rel(got, whole[key], tol, key)
    if key == "dx":
        # the constant channel's variance may clip: either way the ranks
        # agree with one process, which the rows of one rank alone do not
        x, w, b, rm, rv, dy = R.bn_inputs()
        alone = R.bn_run(x[:3], w, b, rm, rv, dy[:3])
        assert float((alone["dx"] - whole["dx"][:3]).abs().max()) > 1e-3


@pytest.mark.parametrize("kernels, want", [
    ((("void tak_bn_stats_kernel<__nv_bfloat16>(...)", 1.0, 1.003),
      ("void tak_bn_grad_input_kernel<__nv_bfloat16>(...)", 2.0, 2.005),
      ("sm90_xmma_fprop_implicit_gemm_bf16", 3.0, 3.5)), 1e3 * 0.008 / 4),
    ((("sm90_xmma_fprop_implicit_gemm_bf16", 3.0, 3.5),
      ("void at::native::reduce_kernel<...>", 4.0, 4.1)), None),
])
def test_bn_metric_reader(monkeypatch, kernels, want):
    """`bn_device_ms_per_chunk.learner` reads the `tak_bn_` kernels'
    device ms over the program's `train.chunks` in the window, and None
    where none ran (a program whose BatchNorm is torch ops)."""
    from benchmark import harness
    from tak_tpu_torch.utils import profiling

    reader = harness.load_module(
        REPO / "benchmark" / "metrics" / "bn_device_ms_per_chunk.learner.py",
        "bn_device_ms_per_chunk_learner")
    monkeypatch.setattr(profiling, "counts",
                        lambda t0, t1: {"train.chunks": 4, "sync": 9})
    trace = harness.Trace(
        window_s=10.0, busy_s=1.0, rec=None, window=(0.0, 10.0), config={},
        workload={}, extras={}, counts={}, gaps=[],
        kernels=[(name, s, e, frozenset()) for name, s, e in kernels])
    got = reader.read(trace)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)
