"""What every kernel wrapper of the port shares: the device test that
picks kernel (CUDA tensors), plain version (CPU tensors) or the dry-run's
reckoning (meta tensors), the operand checks, and the launch's error code
turned into an exception.

On the meta device (``launch/dryrun.py``) a wrapper runs neither: it
returns a meta output of the kernel's shape and adds the kernel's
reckoned FLOPs and bytes (``roofline/analysis.kernel_work``) to every
active counter (``roofline/analysis.count_work``)."""
from __future__ import annotations

import torch

# the active work counters (roofline/analysis.count_work), innermost last
COUNTERS: list = []


def on_meta(*ts) -> bool:
    """True when every operand lies on the meta device (the wrapper then
    returns a meta output and counts its kernel's work); a mix with
    another device is left to ``on_cpu``, which raises on it."""
    return all(t.device.type == "meta" for t in ts)


def count_kernel(kernel: str, **shape) -> None:
    """Add ``kernel``'s reckoned work at ``shape`` to the active counters."""
    if COUNTERS:
        from repro_torch.roofline.analysis import kernel_work

        flops, nbytes = kernel_work(kernel, **shape)
        for c in COUNTERS:
            c.add_kernel(kernel, flops, nbytes)


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
