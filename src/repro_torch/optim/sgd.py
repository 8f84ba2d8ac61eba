"""Plain SGD (the paper trains every method with it): x <- x - lr * g."""
from __future__ import annotations

import torch


def sgd_update(params: torch.Tensor, grads: torch.Tensor,
               lr: float) -> torch.Tensor:
    """One step on a packed slab, taken in fp32 and cast once to the
    parameters' dtype (the JAX ``sgd().update`` on a flat leaf)."""
    return (params.float() - lr * grads.float()).to(params.dtype)
