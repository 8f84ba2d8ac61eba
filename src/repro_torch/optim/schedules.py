"""Learning-rate schedules, the JAX package's ``optim/schedules.py``. The
paper uses multiplicative decay per global epoch (initial 5e-2, factor
0.80); cosine with warmup is the LLM substrate's.

A schedule maps a step (an int, or an integer tensor on the device) to
the step's learning rate as a 0-d fp32 tensor on the step's device (the
CPU for an int), every operation taken in fp32 as XLA takes it.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[int | torch.Tensor], torch.Tensor]  # step -> lr


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float) -> Schedule:
    def fn(step):
        return torch.full((), lr, dtype=torch.float32,
                          device=torch.as_tensor(step).device)

    return fn


def exponential_decay(lr0: float, decay: float, steps_per_decay: int = 1) -> Schedule:
    """Paper-faithful: lr0 * decay^floor(step / steps_per_decay)."""

    def fn(step):
        e = _f32(step) / steps_per_decay
        return lr0 * torch.pow(e.new_full((), decay), torch.floor(e))

    return fn


def cosine_with_warmup(lr0: float, warmup: int, total: int, floor: float = 0.1) -> Schedule:
    """Linear warmup to lr0 over ``warmup`` steps, then a half cosine from
    lr0 down to ``floor * lr0`` at ``total``, flat after it."""

    def fn(step):
        s = _f32(step)
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return lr0 * torch.where(s < warmup, warm, cos)

    return fn


def make_schedule(name: str, **kw) -> Schedule:
    reg = {
        "constant": constant,
        "exponential": exponential_decay,
        "cosine": cosine_with_warmup,
    }
    if name not in reg:
        raise ValueError(f"unknown schedule {name!r}")
    return reg[name](**kw)
