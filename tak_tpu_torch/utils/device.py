"""Device resolution for the PyTorch port.

Every entry point takes an explicit `device` and defaults to "cuda".
Asking for a CUDA device on a machine without one raises: nothing falls
back to the CPU.  The tests pass device="cpu".
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def synchronize(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def setup_performance_defaults(device) -> None:
    """What every command line sets for its device (the counterpart of
    `tak_tpu/utils/device.py`'s, which sets JAX's compile cache): on CUDA,
    cuDNN autotuning (`torch.backends.cudnn.benchmark`), whose choices
    last for the process that made them."""
    if torch.device(device).type == "cuda":
        torch.backends.cudnn.benchmark = True
