"""FedSPD's gossip mix C' = W·C as CUDA kernels for Hopper.

Two kernels, in ``csrc/gossip_mix.cu``, built by ``kernels/build.py``:

- ``gossip_mix_flat`` replaces the Pallas TPU kernel
  ``src/repro/kernels/gossip_mix.py:gossip_mix_flat``: C' = W·C over the
  packed ``(N, X)`` plane, once per round on the main path.
- ``gossip_mix_fused_dp`` replaces
  ``src/repro/kernels/gossip_mix.py:gossip_mix_fused_dp``:
  W·(c_old + scale ⊙ (c_new − c_old) + σ·noise) in one pass, once per DP
  round. The noise is drawn outside the kernel; with σ = 0 there is no
  noise operand.

Both are memory-bound on an H100 for N below ≈ 80: they move
4·(N² + 2NX) bytes (flat) for 2N²X FLOPs. The kernel streams the plane
once, one thread per column, with W staged in shared memory and fp32 FMA
accumulation (no TF32); see the source for the design.

Beside each kernel: its plain PyTorch version (``*_ref``, an fp32 einsum
with the prologue written out) and a launch counter (``.launches`` on the
wrapper, raised by one per kernel launch and nowhere else). A wrapper
takes the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load_library


def gossip_mix_flat_ref(w: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Plain C' = W·C, fp32 accumulation."""
    return torch.einsum("ij,jx->ix", w.float(), c.float())


def gossip_mix_fused_dp_ref(w, c_old, c_new, scale, noise,
                            sigma: float) -> torch.Tensor:
    """Plain W·(c_old + scale ⊙ (c_new − c_old) [+ σ·noise])."""
    c = c_old + scale.reshape(-1, 1) * (c_new - c_old)
    if sigma > 0.0:
        c = c + sigma * noise
    return gossip_mix_flat_ref(w, c)


def _on_cpu(*ts) -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(f"gossip mix operands on mixed or unsupported devices: {devs}")
    return False


def _check(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes float32")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous tensor")


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {rc}")


def gossip_mix_flat(w: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """C' = W·C. w ``(N, N)``, c ``(N, X)``, fp32; returns a new ``(N, X)``."""
    if _on_cpu(w, c):
        return gossip_mix_flat_ref(w, c)
    n, x = c.shape
    _check("w", w, (n, n))
    _check("c", c, (n, x))
    out = torch.empty_like(c)
    lib = load_library()
    stream = torch.cuda.current_stream(c.device).cuda_stream
    _raise_on(lib.gossip_mix_flat(w.data_ptr(), c.data_ptr(), out.data_ptr(),
                                  n, x, stream), "gossip_mix_flat")
    gossip_mix_flat.launches += 1
    return out


gossip_mix_flat.launches = 0


def gossip_mix_fused_dp(w: torch.Tensor, c_old: torch.Tensor,
                        c_new: torch.Tensor, scale: torch.Tensor,
                        noise: torch.Tensor | None,
                        sigma: float) -> torch.Tensor:
    """W·(c_old + scale ⊙ (c_new − c_old) + σ·noise). scale ``(N, 1)`` or
    ``(N,)``; ``noise`` is ``(N, X)`` when σ > 0 and None when σ = 0."""
    sigma = float(sigma)
    if (noise is None) != (sigma <= 0.0):
        raise ValueError("noise must be given exactly when sigma > 0")
    ops = (w, c_old, c_new, scale) + ((noise,) if noise is not None else ())
    if _on_cpu(*ops):
        return gossip_mix_fused_dp_ref(w, c_old, c_new, scale, noise, sigma)
    n, x = c_old.shape
    scale = scale.reshape(n)
    _check("w", w, (n, n))
    _check("c_old", c_old, (n, x))
    _check("c_new", c_new, (n, x))
    _check("scale", scale, (n,))
    if noise is not None:
        _check("noise", noise, (n, x))
    out = torch.empty_like(c_old)
    lib = load_library()
    stream = torch.cuda.current_stream(c_old.device).cuda_stream
    _raise_on(lib.gossip_mix_fused_dp(
        w.data_ptr(), c_old.data_ptr(), c_new.data_ptr(), scale.data_ptr(),
        noise.data_ptr() if noise is not None else None, sigma,
        out.data_ptr(), n, x, stream), "gossip_mix_fused_dp")
    gossip_mix_fused_dp.launches += 1
    return out


gossip_mix_fused_dp.launches = 0

KERNELS = (gossip_mix_flat, gossip_mix_fused_dp)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
