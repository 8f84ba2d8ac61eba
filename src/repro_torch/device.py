"""Device resolution, generators and CUDA-graph capture for the port.

The port runs on the card unless the caller asks for the CPU: ``"cuda"`` is
the default everywhere, and asking for it on a host without a card raises
instead of quietly running on the CPU.

Capture (``warm_up``, ``capture``): a closure over static buffers is run
once on a side stream, then recorded into a ``torch.cuda.CUDAGraph`` and
replayed. Every generator the closure draws from is registered with the
graph, so each replay draws anew from where the generator stands, and
advances it by what the closure draws: after a replay, ``get_state()``
(and so ``copy_generator``) is where the same work run eagerly would have
left it. A capture that fails raises.
"""
from __future__ import annotations

from typing import Callable, Iterable

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


def warm_up(fn: Callable[[], object], device: torch.device) -> None:
    """Run ``fn`` once on a side stream and wait for it: what a capture
    needs first (the lazy set-up of cuBLAS, autograd's device thread and
    the allocator happens outside the graph)."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)


def capture(fn: Callable[[], object],
            gens: Iterable[torch.Generator]) -> torch.cuda.CUDAGraph:
    """``fn`` recorded into a new CUDA graph, each of ``gens`` registered
    with it (``gen`` may repeat). Nothing runs: ``graph.replay()`` does
    the work. Raises what the capture raises (an op that syncs with the
    host, a generator that is not registered)."""
    graph = torch.cuda.CUDAGraph()
    seen: set = set()
    for gen in gens:
        if id(gen) not in seen:
            seen.add(id(gen))
            graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        fn()
    return graph


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
