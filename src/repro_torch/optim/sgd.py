"""Optimizers on the packed parameter slab.

The paper trains every method with plain SGD and a decayed learning rate
(Appendix B.1: initial lr 5e-2, decay 0.80): ``sgd_update``, and ``sgd``
around it. SGD-momentum and AdamW are the JAX package's ``optim/sgd.py``
counterparts, optax-style ``Optimizer(init, update)`` pairs with
``update(grads, state, params, lr) -> (params, state)``.

Every update works on one packed ``(..., X)`` tensor (a client's row, an
``(N, X)`` slab of clients stepping together), accumulates in fp32 and
casts once to the parameters' dtype, as the JAX package does leaf by
leaf. On the pytree engine ``tree_init`` and ``tree_update`` apply an
optimizer leaf by leaf over a nested dict of parameters (one state per
leaf: the JAX optimizers' per-leaf ``tree.map``). ``lr`` is a float or a
0-d fp32 tensor on the device (a captured round reads it from a tape).
AdamW's step count is a 0-d int32 tensor on the parameters' device and
its bias corrections ``1 - b ** count`` are taken there in fp32, so a
replayed round reads them without a host sync.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


def sgd_update(params: torch.Tensor, grads: torch.Tensor,
               lr: float | torch.Tensor) -> torch.Tensor:
    """One step on a packed slab, taken in fp32 and cast once to the
    parameters' dtype (the JAX ``sgd().update`` on a flat leaf). ``lr`` is
    an fp32 value: a float, or a 0-d fp32 tensor on the device (the same
    bits; a captured round reads it from a tape)."""
    return (params.float() - lr * grads.float()).to(params.dtype)


class Optimizer(NamedTuple):
    init: Callable[[torch.Tensor], Any]
    update: Callable[..., tuple]
    # update(grads, state, params, lr) -> (new_params, new_state)


def sgd() -> Optimizer:
    """Paper-faithful plain SGD: x <- x - lr * g. Stateless."""

    def init(params):
        return ()

    def update(grads, state, params, lr):
        return sgd_update(params, grads, lr), state

    return Optimizer(init, update)


def _step(params: torch.Tensor, step: torch.Tensor, lr) -> torch.Tensor:
    return (params.float() - lr * step.float()).to(params.dtype)


def momentum(beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    """Heavy-ball momentum m <- beta * m + g; the step is m, or beta * m + g
    with ``nesterov``. The buffer has the parameters' dtype."""

    def init(params):
        return torch.zeros_like(params)

    def update(grads, state, params, lr):
        new_m = beta * state + grads.to(state.dtype)
        step = beta * new_m + grads.to(new_m.dtype) if nesterov else new_m
        return _step(params, step, lr), new_m

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: torch.Tensor      # fp32 first moment, the parameters' shape
    nu: torch.Tensor      # fp32 second moment
    count: torch.Tensor   # () int32 steps taken, on the parameters' device


def adamw(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """Adam with decoupled weight decay: the step is
    (mu / c1) / (sqrt(nu / c2) + eps) + weight_decay * p, with the bias
    corrections c = 1 - b ** count."""

    def init(params):
        z = torch.zeros_like(params, dtype=torch.float32)
        return AdamState(mu=z, nu=torch.zeros_like(z),
                         count=torch.zeros((), dtype=torch.int32, device=params.device))

    def update(grads, state, params, lr):
        count = state.count + 1
        g32 = grads.float()
        mu = b1 * state.mu + (1 - b1) * g32
        nu = b2 * state.nu + (1 - b2) * g32 * g32
        t = count.float()
        c1 = 1 - torch.pow(t.new_full((), b1), t)
        c2 = 1 - torch.pow(t.new_full((), b2), t)
        p32 = params.float()
        upd = (mu / c1) / (torch.sqrt(nu / c2) + eps) + weight_decay * p32
        return (p32 - lr * upd).to(params.dtype), AdamState(mu=mu, nu=nu, count=count)

    return Optimizer(init, update)


def tree_init(opt: Optimizer, params):
    """``opt``'s state for every leaf of a parameter dict, as a dict of the
    same keys (a bare tensor is one leaf)."""
    if isinstance(params, dict):
        return {k: tree_init(opt, v) for k, v in params.items()}
    return opt.init(params)


def tree_update(opt: Optimizer, grads, state, params, lr) -> tuple:
    """One step of ``opt`` on every leaf of a parameter dict with its own
    state: returns (params, state), dicts of the same keys."""
    if not isinstance(params, dict):
        return opt.update(grads, state, params, lr)
    out = {k: tree_update(opt, grads[k], state[k], v, lr) for k, v in params.items()}
    return {k: p for k, (p, _) in out.items()}, {k: st for k, (_, st) in out.items()}


_REGISTRY = {"sgd": sgd, "momentum": momentum, "adamw": adamw}


def make_optimizer(name: str, **kwargs) -> Optimizer:
    if name not in _REGISTRY:
        raise ValueError(f"unknown optimizer {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [leaf for v in tree for leaf in _leaves(v)]


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return type(tree)(_map(fn, v) for v in tree)


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` (a tensor, or a dict / list / tuple of them) by
    min(1, max_norm / (norm + 1e-12)), the norm taken in fp32 over every
    element of every leaf together."""
    sq = sum(torch.sum(torch.square(g.float())) for g in _leaves(grads))
    scale = torch.clamp(max_norm / (torch.sqrt(sq) + 1e-12), max=1.0)
    return _map(lambda g: g * scale.to(g.dtype), grads)
