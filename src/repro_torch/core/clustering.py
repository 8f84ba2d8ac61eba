"""FedSPD Step 4: data clustering and mixture coefficients.

Every client labels each local point with the cluster whose current center
gives it the lowest loss (Algorithm 1, DataClustering), then sets u_{i,s}
to the fraction of its points labelled s. All S×N centers are evaluated on
all N×M points in one batched forward: ``(S, N, ...)`` parameters against
``(N, M, d)`` inputs broadcast over S. ``clustering_accuracy`` scores the
labels against the true clusters.
"""
from __future__ import annotations

import itertools
from typing import Callable

import torch


def assign_clusters(per_example_loss: Callable, centers: dict,
                    batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """centers leaves ``(S, *B, ...)``, batch leaves ``(*B, M, ...)``.
    Returns (z ``(*B, M)`` argmin over S, losses ``(S, *B, M)``); ties go to
    the lowest cluster index, as ``jnp.argmin``."""
    losses = per_example_loss(centers, batch)
    return torch.argmin(losses, dim=0), losses


def mixture_coefficients(z: torch.Tensor, s_clusters: int,
                         floor: float = 1e-3) -> torch.Tensor:
    """u ``(*B, S)``: the fraction of points in each cluster, floored at
    ``floor`` and renormalised, so no cluster's selection probability
    collapses to exactly zero."""
    counts = torch.nn.functional.one_hot(z, s_clusters).float().sum(dim=-2)
    u = counts / counts.sum(dim=-1, keepdim=True).clamp_min(1.0)
    u = u.clamp_min(floor)
    return u / u.sum(dim=-1, keepdim=True)


def cluster_all_clients(per_example_loss: Callable, centers: dict,
                        data: dict, s_clusters: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """centers leaves ``(S, N, ...)``, data ``{"x": (N, M, d), "y": (N, M)}``.
    Returns (z ``(N, M)``, u ``(N, S)``)."""
    z, _ = assign_clusters(per_example_loss, centers, data)
    return z, mixture_coefficients(z, s_clusters)


def clustering_accuracy(z: torch.Tensor, z_true: torch.Tensor,
                        s_clusters: int) -> torch.Tensor:
    """The best agreement between inferred and true cluster labels over
    all S! label maps (label switching makes the raw agreement
    meaningless); an fp32 scalar. S is small here (2–4). Each agreement
    is the count times the fp32 reciprocal of the number of points, as
    the JAX package's compiled mean rounds it."""
    z = torch.as_tensor(z)
    z_true = torch.as_tensor(z_true, device=z.device)
    inv = torch.tensor(1.0 / z.numel(), dtype=torch.float32, device=z.device)
    accs = [(torch.as_tensor(perm, device=z.device)[z] == z_true).float().sum() * inv
            for perm in itertools.permutations(range(s_clusters))]
    return torch.stack(accs).max()
