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

Every random draw can be injected (``idx``: batch indices; ``comm_u``:
the codec's rounding draw), so tests can feed both packages the same
numbers; without them the draws come from the ``torch.Generator`` the
step is given.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.packing import PackSpec, flat_grad, pack
from repro_torch.data.pipeline import gather_batches, uniform_batch_indices
from repro_torch.graphs.mixing import metropolis_weights
from repro_torch.graphs.topology import Graph
from repro_torch.kernels.gossip_mix import (
    gossip_mix_encoded,
    gossip_mix_flat,
    gossip_mix_stack,
)
from repro_torch.optim.sgd import Optimizer, sgd_update


def init_planes(gen: torch.Generator, model_init: Callable, count: int,
                pack_spec: PackSpec) -> torch.Tensor:
    """``count`` independently initialised models, drawn from ``gen`` one
    after another and packed: ``(count, X)``."""
    return torch.stack([pack(model_init(gen), pack_spec) for _ in range(count)])


def mixing_matrix(graph: Graph | None, n: int, centralized: bool) -> np.ndarray:
    """Centralized = exact global average (a server); decentralized =
    Metropolis gossip over the client graph."""
    if centralized:
        return np.full((n, n), 1.0 / n, dtype=np.float32)
    if graph is None:
        raise ValueError("a decentralized mixing matrix needs the client graph")
    return metropolis_weights(graph)


def gossip_avg(plane: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(N, X)`` plane <- W·plane: one ``gossip_mix_flat`` launch."""
    return gossip_mix_flat(w, plane).to(plane.dtype)


def gossip_avg_stack(plane: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(S, N, X)`` stack <- W·C_s for EVERY cluster s (the FedEM
    exchange): one ``gossip_mix_stack`` launch."""
    return gossip_mix_stack(w, plane).to(plane.dtype)


def gossip_avg_comm(plane: torch.Tensor, w: torch.Tensor, *, channel=None,
                    key=None, ef: torch.Tensor | None = None):
    """The exchange behind a wire codec, W·decode(encode(x + e)), on the
    ``(N, X)`` plane or FedEM's ``(S, N, X)`` stack (every one of the S
    messages goes through the codec). Returns (mixed, ef').

    - ``channel=None``: the uncompressed exchange, ``gossip_avg`` or
      ``gossip_avg_stack``, bit for bit; ``ef`` passes through.
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
        mixed = gossip_avg_stack(plane, w) if plane.dim() == 3 else gossip_avg(plane, w)
        return mixed, ef
    if channel.fused and plane.dim() == 2:
        enc, _, ef = channel.encode_stream(plane, key, ef)
        mixed = gossip_mix_encoded(w, enc, qblock=channel.cfg.block,
                                   x_out=plane.shape[-1])
        return mixed.to(plane.dtype).contiguous(), ef
    x_hat, ef = channel.roundtrip(plane, key, ef)
    x_hat = x_hat.contiguous()
    mixed = gossip_avg_stack(x_hat, w) if plane.dim() == 3 else gossip_avg(x_hat, w)
    return mixed.to(plane.dtype), ef


def local_sgd(loss_fn: Callable, plane: torch.Tensor, data: dict,
              gen: torch.Generator | None, tau: int, batch: int, lr: float, *,
              pack_spec: PackSpec, extra_grad: Callable | None = None,
              optimizer: Optimizer | None = None,
              idx: torch.Tensor | None = None) -> torch.Tensor:
    """τ uniform-batch steps for every client of the ``(N, X)`` plane, all
    clients batched into each forward. Injectable: ``idx`` ``(τ, N,
    batch)``.

    Without an ``optimizer``, the paper's plain SGD: ``extra_grad(plane)``
    (a regularizer's ``(N, X)`` gradient) is applied first, at the step's
    starting point, then the loss gradient, as the JAX plane path orders
    the two updates. With one (optim/sgd.py; its state made fresh here,
    one per client row), ``extra_grad`` is added to the loss gradient and
    the optimizer takes the one step, as the JAX stateful path does."""
    x, y = data["inputs"], data["targets"]
    n, m = x.shape[0], x.shape[1]
    opt_state = optimizer.init(plane) if optimizer is not None else None
    for t in range(tau):
        it = idx[t] if idx is not None else uniform_batch_indices(gen, n, m, batch)
        g = flat_grad(loss_fn, plane, gather_batches(x, y, it), pack_spec)
        if optimizer is not None:
            if extra_grad is not None:
                g = g + extra_grad(plane)
            plane, opt_state = optimizer.update(g, opt_state, plane, lr)
            continue
        if extra_grad is not None:
            plane = plane - lr * extra_grad(plane)
        plane = sgd_update(plane, g, lr)
    return plane


def per_client_eval(metric_fn: Callable, params: dict, data: dict) -> torch.Tensor:
    """metric_fn batched over the client axis -> ``(N,)``."""
    return metric_fn(params, {"x": data["inputs"], "y": data["targets"]})
