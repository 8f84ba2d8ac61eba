"""Device resolution for the port's entry points.

The port runs on the card unless the caller asks for the CPU: ``"cuda"`` is
the default everywhere, and asking for it on a host without a card raises
instead of quietly running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` when CUDA
    is asked for and no card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} needs CUDA, but torch.cuda.is_available() "
            "is False on this host; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}; use 'cuda' or 'cpu'")
    return dev


def make_generator(device: torch.device, seed: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (the port's
    stand-in for a ``jax.random`` key)."""
    return torch.Generator(device=device).manual_seed(int(seed))


def fork_generator(gen: torch.Generator) -> torch.Generator:
    """A new generator on ``gen``'s device whose seed is drawn from ``gen``
    (one draw: ``gen`` advances, the child stream is independent)."""
    seed = torch.randint(0, 2**62, (1,), generator=gen, device=gen.device)
    return make_generator(gen.device, int(seed.item()))


def copy_generator(gen: torch.Generator) -> torch.Generator:
    """A generator at ``gen``'s current position: drawing from the copy
    leaves ``gen`` where it was (JAX's reuse of a key without splitting)."""
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
