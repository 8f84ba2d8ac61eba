"""What every kernel wrapper of the port shares: the device test that
picks kernel (CUDA tensors) or plain version (CPU tensors), the operand
checks, and the launch's error code turned into an exception."""
from __future__ import annotations

import torch


def on_cpu(*ts) -> bool:
    """True when every operand lies on the CPU (the wrapper then runs its
    plain version); False when all lie on one CUDA device; raises on a
    mix or on another device type."""
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(f"kernel operands on mixed or unsupported devices: {devs}")
    return False


def check(name: str, t: torch.Tensor, shape: tuple,
          dtype: torch.dtype = torch.float32) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous tensor")


def raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {rc}")
