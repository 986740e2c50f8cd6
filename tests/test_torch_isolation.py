"""The PyTorch port stands alone: no JAX, flax or tak_tpu module is
loaded by importing it, and asking for a missing CUDA device raises."""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, pkgutil, sys
import tak_tpu_torch
for m in pkgutil.walk_packages(tak_tpu_torch.__path__, "tak_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(name for name in sys.modules
             if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "tak_tpu"))
print("MODULES", len([n for n in sys.modules if n.startswith("tak_tpu_torch")]))
print("BAD", ",".join(bad))
"""


def test_port_imports_no_jax_or_tak_tpu():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if " " in line)
    assert int(lines["MODULES"]) >= 15
    assert lines["BAD"].strip() == "", lines["BAD"]


def test_cuda_request_without_card_raises():
    import torch

    from tak_tpu_torch.engine.core import Engine
    from tak_tpu_torch.model.network import Network
    from tak_tpu_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        Engine(6).initial_batch(2)  # the default device is cuda
    with pytest.raises(RuntimeError):
        Network(Engine(6))
    assert resolve_device("cpu").type == "cpu"
