"""Per-client batch sampling on the device.

FedSPD's local step samples uniformly, with replacement, from the points of
client i currently assigned to its selected cluster s_i, and falls back to
all of the client's points when none is assigned to s_i. Index draws and
gathers are split so that a caller can inject the indices (the tests feed
the JAX package's draws to both packages).
"""
from __future__ import annotations

import torch


def cluster_batch_indices(gen: torch.Generator, z: torch.Tensor,
                          s: torch.Tensor, batch: int) -> torch.Tensor:
    """``(N, batch)`` indices, row i uniform over ``{k : z[i, k] == s[i]}``
    (over all M points when that set is empty). z ``(N, M)``, s ``(N,)``."""
    match = z == s[:, None]
    weights = (match | ~match.any(dim=1, keepdim=True)).float()
    return torch.multinomial(weights, batch, replacement=True, generator=gen)


def uniform_batch_indices(gen: torch.Generator, n: int, m: int,
                          batch: int) -> torch.Tensor:
    """``(n, batch)`` indices uniform over the M points of each client."""
    return torch.randint(0, m, (n, batch), generator=gen, device=gen.device)


def gather_batches(x: torch.Tensor, y: torch.Tensor,
                   idx: torch.Tensor) -> dict:
    """x ``(N, M, d)``, y ``(N, M)``, idx ``(N, B)`` -> ``{"x": (N, B, d),
    "y": (N, B)}``."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return {"x": x[rows, idx], "y": y[rows, idx]}
