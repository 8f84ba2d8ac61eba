"""Plain SGD (the paper trains every method with it): x <- x - lr * g."""
from __future__ import annotations

import torch


def sgd_update(params: torch.Tensor, grads: torch.Tensor,
               lr: float | torch.Tensor) -> torch.Tensor:
    """One step on a packed slab, taken in fp32 and cast once to the
    parameters' dtype (the JAX ``sgd().update`` on a flat leaf). ``lr`` is
    an fp32 value: a float, or a 0-d fp32 tensor on the device (the same
    bits; a captured round reads it from a tape)."""
    return (params.float() - lr * grads.float()).to(params.dtype)
