"""Shared machinery for the baseline FL algorithms (paper Section 6
baselines: FedAvg, FedEM, IFCA, FedSoft, pFedMe, Local — each in a
decentralized (static gossip matrix) and centralized (complete averaging)
variant), on the packed parameter plane.

Per-client models are one ``(N, X)`` fp32 tensor and center stacks one
``(S, N, X)`` tensor (core/packing.py). The exchange is a hand-written
Hopper kernel (kernels/gossip_mix.py): ``gossip_mix_flat`` for an
``(N, X)`` plane, ``gossip_mix_stack`` for all S slabs of a stack in one
launch, and, behind an int8/int4 wire codec on an ``(N, X)`` plane,
``gossip_mix_dequant`` over the encoded payload. The tensor's device
picks the execution: the kernel on a CUDA tensor, its plain version on a
CPU tensor.

On the pytree engine (``pack_spec=None``; ``RunConfig(param_plane=False)``)
the same helpers take nested dicts of ``(N, ...)`` / ``(S, N, ...)``
leaves (utils/pytree.py), as the JAX helpers do: the exchange launches
its kernel once per leaf, and ``local_sgd`` takes per-leaf gradients and
the optimizer's per-leaf update (a regularizer's gradient added to the
loss's, one step). No codec runs there.

Every random draw can be injected (``idx``: batch indices; ``comm_u``:
the codec's rounding draw), so tests can feed both packages the same
numbers; without them the draws come from the ``torch.Generator`` the
step is given.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.packing import PackSpec, grad, stack_models
from repro_torch.data.pipeline import gather_batches, uniform_batch_indices
from repro_torch.graphs.mixing import metropolis_weights
from repro_torch.graphs.topology import Graph
from repro_torch.kernels.gossip_mix import (
    gossip_mix_encoded,
    gossip_mix_stack,
    gossip_mix_tree,
)
from repro_torch.optim.sgd import Optimizer, sgd, tree_init, tree_update
from repro_torch.utils.pytree import tree_add, tree_map


def init_planes(gen: torch.Generator, model_init: Callable, count: int,
                pack_spec: PackSpec | None, lead: tuple | None = None):
    """``count`` independently initialised models, drawn from ``gen`` one
    after another: packed, ``(*lead, X)``, or with ``pack_spec=None`` a
    tree of ``(*lead, ...)`` leaves (``lead`` defaults to ``(count,)``)."""
    return stack_models([model_init(gen) for _ in range(count)], pack_spec,
                        (count,) if lead is None else lead)


def mixing_matrix(graph: Graph | None, n: int, centralized: bool) -> np.ndarray:
    """Centralized = exact global average (a server); decentralized =
    Metropolis gossip over the client graph."""
    if centralized:
        return np.full((n, n), 1.0 / n, dtype=np.float32)
    if graph is None:
        raise ValueError("a decentralized mixing matrix needs the client graph")
    return metropolis_weights(graph)


def gossip_avg(plane, w: torch.Tensor):
    """``(N, X)`` plane <- W·plane: one ``gossip_mix_flat`` launch; a tree
    of ``(N, ...)`` leaves, one launch per leaf (``gossip_mix_tree``)."""
    return gossip_mix_tree(w, plane)


def gossip_avg_stack(plane, w: torch.Tensor):
    """``(S, N, X)`` stack <- W·C_s for EVERY cluster s (the FedEM
    exchange): one ``gossip_mix_stack`` launch; a tree of ``(S, N, ...)``
    leaves, one launch per leaf, each viewed as ``(S, N, -1)``."""
    def one(leaf):
        s, n = leaf.shape[:2]
        return gossip_mix_stack(w, leaf.reshape(s, n, -1).contiguous()) \
            .reshape(leaf.shape).to(leaf.dtype)

    return tree_map(one, plane)


def gossip_avg_comm(plane: torch.Tensor, w: torch.Tensor, *, channel=None,
                    key=None, ef: torch.Tensor | None = None):
    """The exchange behind a wire codec, W·decode(encode(x + e)), on the
    ``(N, X)`` plane or FedEM's ``(S, N, X)`` stack (every one of the S
    messages goes through the codec). Returns (mixed, ef').

    - ``channel=None``: the uncompressed exchange, ``gossip_avg`` or
      ``gossip_avg_stack``, bit for bit; ``ef`` passes through. A tree
      (the pytree engine) takes ``gossip_avg``, as in JAX.
    - int8/int4 on an ``(N, X)`` plane: the payload is encoded (with the
      residual update under error feedback) and mixed by
      ``gossip_mix_dequant``: nothing is decoded outside the kernel for
      the mix.
    - otherwise (top-k, or a stack): decoded, then mixed by
      ``gossip_mix_flat`` or ``gossip_mix_stack``.

    ``key`` is the codec's rounding draw (``comm/codecs.quant_encode``: a
    generator or the uniform draw itself), ``ef`` the error-feedback
    residual of the plane's shape."""
    if channel is None:
        stack = isinstance(plane, torch.Tensor) and plane.dim() == 3
        return (gossip_avg_stack if stack else gossip_avg)(plane, w), ef
    if channel.fused and plane.dim() == 2:
        enc, _, ef = channel.encode_stream(plane, key, ef)
        mixed = gossip_mix_encoded(w, enc, qblock=channel.cfg.block,
                                   x_out=plane.shape[-1])
        return mixed.to(plane.dtype).contiguous(), ef
    x_hat, ef = channel.roundtrip(plane, key, ef)
    x_hat = x_hat.contiguous()
    mixed = gossip_avg_stack(x_hat, w) if plane.dim() == 3 else gossip_avg(x_hat, w)
    return mixed.to(plane.dtype), ef


def local_sgd(loss_fn: Callable, plane, data: dict,
              gen: torch.Generator | None, tau: int, batch: int, lr: float, *,
              pack_spec: PackSpec | None, extra_grad: Callable | None = None,
              optimizer: Optimizer | None = None,
              idx: torch.Tensor | None = None):
    """τ uniform-batch steps for every client of the ``(N, X)`` plane, all
    clients batched into each forward. Injectable: ``idx`` ``(τ, N,
    batch)``.

    With ``pack_spec=None`` the models are a tree of ``(N, ...)`` leaves
    (the JAX pytree branch): each step takes the per-leaf gradients, adds
    ``extra_grad(tree)`` to them, and takes one step of ``optimizer``
    (plain SGD by default) leaf by leaf.

    Without an ``optimizer``, the paper's plain SGD: ``extra_grad(plane)``
    (a regularizer's ``(N, X)`` gradient) is applied first, at the step's
    starting point, then the loss gradient, as the JAX plane path orders
    the two updates. With one (optim/sgd.py; its state made fresh here,
    one per client row), ``extra_grad`` is added to the loss gradient and
    the optimizer takes the one step, as the JAX stateful path does."""
    x, y = data["inputs"], data["targets"]
    n, m = x.shape[0], x.shape[1]

    def batch_of(t):
        it = idx[t] if idx is not None else uniform_batch_indices(gen, n, m, batch)
        return gather_batches(x, y, it)

    # the JAX plane path's plain SGD takes the regularizer's step first
    extra_first = optimizer is None and pack_spec is not None
    optimizer = optimizer or sgd()
    opt_state = tree_init(optimizer, plane)
    for t in range(tau):
        g = grad(loss_fn, plane, batch_of(t), pack_spec)
        if extra_grad is not None:
            if extra_first:
                plane = plane - lr * extra_grad(plane)
            else:
                g = tree_add(g, extra_grad(plane))
        plane, opt_state = tree_update(optimizer, g, opt_state, plane, lr)
    return plane


def per_client_eval(metric_fn: Callable, params: dict, data: dict) -> torch.Tensor:
    """metric_fn batched over the client axis -> ``(N,)``."""
    return metric_fn(params, {"x": data["inputs"], "y": data["targets"]})
