"""Local-only training: the no-collaboration floor in the paper's tables.

The per-client models live on the packed ``(N, X)`` plane and every SGD
step is one batched update over the plane (core/packing.py); on the
pytree engine (``pack_spec=None``) they are a tree of ``(N, ...)`` leaves,
updated leaf by leaf.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.baselines.common import local_sgd
from repro_torch.core.packing import PackSpec, maybe_unpack


def make_step(loss_fn: Callable, *, tau: int, batch: int, pack_spec: PackSpec | None):
    """``step(plane, data, gen, lr, *, idx=None) -> (plane, {})``;
    injectable ``idx`` ``(τ, N, batch)``."""
    def step(plane, data, gen, lr, *, idx=None):
        return local_sgd(loss_fn, plane, data, gen, tau, batch, lr,
                         pack_spec=pack_spec, idx=idx), {}

    return step


def personalized_params(plane, pack_spec: PackSpec | None) -> dict:
    return maybe_unpack(plane, pack_spec)
