"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled at first
use by `nvcc` into its own shared library under `build/tak_tpu_torch/`
(listed in `.gitignore`), then loaded with `ctypes`.  Pointers and the
CUDA stream are passed as `c_void_p`; every C entry point returns
`cudaGetLastError()` and `check()` raises when it is not 0.

All sources are compiled in parallel (one `nvcc` per source, started
together).  The library name carries a hash of its source and of the
shared headers (`csrc/*.cuh`), so an edited kernel is rebuilt and a stale
library is never loaded.

No fast-math: the tree kernels must reproduce the plain PyTorch version's
float32 PUCT arithmetic bit for bit, so `-fmad=false` also keeps the
compiler from contracting a multiply and an add into one rounding.

Launch counters: each wrapper adds one to `LAUNCHES[<kernel name>]` where
it launches its kernel, and nowhere else (the BatchNorm kernels and the
SE epilogue count under their C entry points' names, `tak_bn_*` and
`tak_se_epilogue`).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "tak_tpu_torch"
SOURCES = ("fused_step", "fused_step_legal", "env_rollout", "tree_wave",
           "tree_wave_hbm", "batch_norm", "squeeze_excite", "legal_topk")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U, _L, _D = ctypes.c_uint, ctypes.c_longlong, ctypes.c_double
# C entry points: (library, argtypes); every one returns cudaGetLastError()
SIGNATURES = {
    # n, rows, 10 input state fields, 10 output fields, action, enabled,
    # stream
    "tak_fused_step": ("fused_step", [_I, _I] + [_P] * 23),
    # the same, then the class tables, place, spread, stream
    "tak_fused_step_legal": ("fused_step_legal", [_I, _I] + [_P] * 26),
    # n, rows, 10 state fields, tables, bits, use_seed, key low, key high,
    # action, total, stream
    "tak_legal_sampler": ("env_rollout", [_I, _I] + [_P] * 12 + [_I, _U, _U]
                          + [_P] * 3),
    # n, rows, steps, start stones, start caps, 10 input fields, 10 output
    # fields, tables, bits, use_seed, key low, key high, stream
    "tak_env_rollout": ("env_rollout", [_I] * 5 + [_P] * 22 + [_I, _U, _U]
                        + [_P]),
    # B, M, K, A, V, recycle, base, init, valid, 22 tree fields,
    # 6 pending fields, leaves, created, stream
    "tak_backup_descend_wave": ("tree_wave", [_I] * 6 + [_F, _F, _I]
                                + [_P] * 31),
    "tak_expand_backup_wave": ("tree_wave", [_I] * 6 + [_F, _F, _I]
                               + [_P] * 31),
    # B, M, K, A, V, base, init, 19 tree fields, leaves, created, stream
    "tak_descend_wave_hbm": ("tree_wave_hbm", [_I] * 5 + [_F, _F]
                             + [_P] * 22),
    # B, M, K, A, V, 15 tree fields, 6 pending fields, scratch (or null),
    # stream
    "tak_expand_backup_wave_hbm": ("tree_wave_hbm", [_I] * 5 + [_P] * 23),
    # V, the host address of a long long: the scratch bytes a game
    "tak_backup_scratch_bytes": ("tree_wave_hbm", [_I, _P]),
    # B, M, V, parent, leaves, levels, stream
    "tak_parent_chase": ("tree_wave_hbm", [_I] * 3 + [_P] * 4),
    # B, M, K, A, V, D, root_child, edge_child, actions, slots, ends, stream
    "tak_child_chase": ("tree_wave_hbm", [_I] * 6 + [_P] * 6),
    # train-mode BatchNorm: kind (0 bf16, 1 float32, 2 float64), rows, C,
    # then as `csrc/batch_norm.cu` lists them
    "tak_bn_stats": ("batch_norm", [_I, _L, _I, _I] + [_P] * 3),
    "tak_bn_grad_sums": ("batch_norm", [_I, _L, _I, _I] + [_P] * 5),
    "tak_bn_finalize": ("batch_norm", [_I, _I, _I, _D] + [_P] * 7),
    "tak_bn_normalize": ("batch_norm", [_I, _L, _I, _I] + [_P] * 5),
    "tak_bn_grad_input": ("batch_norm", [_I, _L, _I, _I, _D] + [_P] * 7),
    # the SE epilogue: rows, H*W, C, S, SMs, y, x, w1, b1, w2, b2, out,
    # stream
    "tak_se_epilogue": ("squeeze_excite", [_L] + [_I] * 4 + [_P] * 8),
    # the legal top-K: n, rows, A, K, policy, place, spread, vals, ids,
    # stream
    "tak_legal_topk": ("legal_topk", [_I] * 4 + [_P] * 6),
}

LAUNCHES: collections.Counter = collections.Counter()
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return path


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES, verbose: bool = False) -> float:
    """Compile every library in `names` that is not built yet, all `nvcc`
    processes at once.  Returns the wall seconds spent.  `verbose` adds
    `-Xptxas -v` (registers, shared memory, spills) to BUILD_LOG."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        if not _lib_path(name).exists():
            build(SOURCES)
        lib = ctypes.CDLL(str(_lib_path(name)))
        for entry, (owner, argtypes) in SIGNATURES.items():
            if owner == name:
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed: cudaError {err}")


def ptr(t) -> int:
    """Device address of a tensor; the caller keeps the tensor alive."""
    return t.data_ptr()


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
