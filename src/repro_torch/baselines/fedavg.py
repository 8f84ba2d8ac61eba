"""FedAvg [McMahan et al. 2017] — centralized and decentralized (D-SGD
gossip) variants. The non-personalized reference point.

The state is the packed ``(N, X)`` plane: local SGD is one batched update
over the plane, and the W-average is one ``gossip_mix_flat`` launch.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.baselines.common import gossip_avg_comm, local_sgd
from repro_torch.core.packing import PackSpec, unpack


def make_step(loss_fn: Callable, w: torch.Tensor, *, tau: int, batch: int,
              pack_spec: PackSpec):
    """``step(plane, data, gen, lr, *, idx=None) -> (plane, {})``; ``w``
    is the ``(N, N)`` mixing matrix on the plane's device; injectable
    ``idx`` ``(τ, N, batch)``."""
    def step(plane, data, gen, lr, *, idx=None):
        plane = local_sgd(loss_fn, plane, data, gen, tau, batch, lr,
                          pack_spec=pack_spec, idx=idx)
        return gossip_avg_comm(plane, w), {}

    return step


def personalized_params(plane, pack_spec: PackSpec) -> dict:
    """FedAvg has no personalization: every client evaluates its own copy
    (equal to the consensus model up to gossip error)."""
    return unpack(plane, pack_spec)
