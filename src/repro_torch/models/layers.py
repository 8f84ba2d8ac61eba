"""Shared building blocks for the port's models (plain tensor functions).

Parameters are plain dicts of tensors with the JAX package's keys and
layouts (``x @ w + b``, so ``w`` is ``(d_in, d_out)``).
"""
from __future__ import annotations

import math

import torch


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: float | None = None) -> torch.Tensor:
    """``(d_in, d_out)`` Gaussian weights with std ``1/sqrt(d_in)`` (or
    ``scale``), drawn from ``gen`` on its device."""
    std = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32) * std
    return w.to(dtype)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position cross entropy in fp32, logsumexp form. logits
    ``(..., V)``; labels broadcast against ``logits.shape[:-1]``."""
    logits = logits.float()
    labels = labels.expand(logits.shape[:-1])
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.unsqueeze(-1)).squeeze(-1)
    return logz - gold
