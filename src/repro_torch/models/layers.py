"""Shared building blocks for the port's models (plain tensor functions).

Parameters are plain dicts of tensors with the JAX package's keys and
layouts (``x @ w + b``, so ``w`` is ``(d_in, d_out)``); initializers draw
from an explicit ``torch.Generator`` on its device. Layer stacks carry a
leading ``(L,)`` axis on every leaf, as the JAX package's ``stack_init``
builds them; the port runs them as a Python loop over that axis.

Request-batched weights. A server answers B requests, each through its
own mixture of the cluster models, so each request has its own weights:
every leaf then carries one more leading axis, ``(B, ...)``, matching
the activations' batch. ``linear`` and ``per_feature`` take either form
(a shared leaf or a per-request one) and tell them apart by rank; a
per-request product runs as one ``torch.bmm`` over the B requests.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F


def init_device(gen: torch.Generator | None) -> torch.device:
    """Where an initializer puts its tensors: ``gen``'s device, or the meta
    device for ``gen=None`` (shapes and dtypes only, no storage: the
    counterpart of ``jax.eval_shape`` over an init)."""
    return torch.device("meta") if gen is None else gen.device


def normal(gen: torch.Generator | None, shape: tuple) -> torch.Tensor:
    """N(0, 1) fp32 draws from ``gen`` on its device (meta for None)."""
    return torch.randn(shape, generator=gen, device=init_device(gen), dtype=torch.float32)


def uniform(gen: torch.Generator | None, shape: tuple) -> torch.Tensor:
    """U[0, 1) fp32 draws from ``gen`` on its device (meta for None)."""
    return torch.rand(shape, generator=gen, device=init_device(gen), dtype=torch.float32)


def dense_init(gen: torch.Generator | None, d_in: int, d_out: int,
               dtype=torch.float32, scale: float | None = None) -> torch.Tensor:
    """``(d_in, d_out)`` Gaussian weights with std ``1/sqrt(d_in)`` (or
    ``scale``), drawn from ``gen`` on its device (meta for None)."""
    std = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (normal(gen, (d_in, d_out)) * std).to(dtype)


def embed_init(gen: torch.Generator | None, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    return (normal(gen, (vocab, d)) * 0.02).to(dtype)


def rmsnorm_init(d: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


# --------------------------------------------------------------------------
# Shared or per-request weights
# --------------------------------------------------------------------------


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x ``(B, ..., d_in)``: ``w`` ``(d_in, d_out)`` shared by
    the batch, or ``(B, d_in, d_out)`` one per request (``torch.bmm``)."""
    if w.dim() == 2:
        return x @ w
    b = x.shape[0]
    out = torch.bmm(x.reshape(b, -1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def per_feature(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-feature parameter, ``(F,)`` shared or ``(B, F)`` per request,
    shaped to broadcast against x ``(B, ..., F)``."""
    if p.dim() == 1:
        return p
    return p.reshape(p.shape[0], *([1] * (x.dim() - 2)), p.shape[-1])


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``embed`` ``(V, D)`` (or ``(B, V, D)``, per request) at
    tokens ``(B, L)`` -> ``(B, L, D)``. A shared table is read through
    ``F.embedding``, whose backward on the card sums a token's repeats in
    a fixed order (an indexed read's backward adds them with atomics), so
    a trained round gives the same bits on every run."""
    if embed.dim() == 2:
        return F.embedding(tokens, embed)
    rows = torch.arange(tokens.shape[0], device=tokens.device)[:, None]
    return embed[rows, tokens]


def unstack_layers(stacked: dict, batched: bool) -> list:
    """The layers of a stacked ``(L, ...)`` params dict, or of a
    per-request ``(B, L, ...)`` one, as a list of per-layer dicts of views
    (no copy). The views come from one ``unbind`` a leaf, whose backward
    stacks the L layers' gradients into one tensor; indexing layer by
    layer would give each layer's gradient a zero-padded copy of the
    whole stack, and add the L copies."""
    dim = 1 if batched else 0

    def split(node):
        if isinstance(node, dict):
            return {k: split(v) for k, v in node.items()}
        return node.unbind(dim)

    def pick(node, i):
        if isinstance(node, dict):
            return {k: pick(v, i) for k, v in node.items()}
        return node[i]

    def depth(node):
        if isinstance(node, dict):
            return next((d for d in map(depth, node.values()) if d is not None), None)
        return node.shape[dim]

    parts = split(stacked)
    return [pick(parts, i) for i in range(depth(stacked))]


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * per_feature(params["scale"], x).float()).to(x.dtype)


def layernorm_np(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Non-parametric LayerNorm (OLMo): no scale, no bias, population
    variance [arXiv:2402.00838]."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def apply_norm(kind: str, params, x: torch.Tensor) -> torch.Tensor:
    """``params`` is unused for ``layernorm_np``: its dict is empty, packs
    to no leaves, and is absent after ``unpack``."""
    if kind == "rmsnorm":
        return rmsnorm(params, x)
    if kind == "layernorm_np":
        return layernorm_np(x)
    raise ValueError(kind)


# --------------------------------------------------------------------------
# Rotary position embeddings (the two halves of the head, not interleaved)
# --------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: ``(..., L, H, hd)``; positions: broadcastable to ``(..., L)``."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    angles = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# MLP blocks
# --------------------------------------------------------------------------


def init_mlp(gen: torch.Generator | None, d_model: int, d_ff: int, act: str,
             dtype=torch.float32) -> dict:
    p = {
        "w_in": dense_init(gen, d_model, d_ff, dtype),
        "w_out": dense_init(gen, d_ff, d_model, dtype),
    }
    if act == "silu":  # swiglu: gate projection
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype)
    return p


def apply_mlp(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    h = linear(x, params["w_in"])
    if act == "silu":
        h = F.silu(linear(x, params["w_gate"])) * h
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    else:
        raise ValueError(act)
    return linear(h, params["w_out"])


def stack_init(init_one: Callable, gen: torch.Generator | None, n_layers: int) -> dict:
    """``init_one(gen)`` for each of ``n_layers`` layers, leaves stacked on
    a new leading ``(L,)`` axis. Each layer is drawn and copied into the
    stack before the next is drawn, so a full-width init holds the stack
    and one layer, never the stack twice."""
    def alloc(node):
        if isinstance(node, dict):
            return {k: alloc(v) for k, v in node.items()}
        return torch.empty((n_layers, *node.shape), dtype=node.dtype, device=node.device)

    def put(dst, src, i):
        if isinstance(src, dict):
            for k, v in src.items():
                put(dst[k], v, i)
        else:
            dst[i].copy_(src)

    first = init_one(gen)
    out = alloc(first)
    put(out, first, 0)
    del first
    for i in range(1, n_layers):
        put(out, init_one(gen), i)
    return out


# --------------------------------------------------------------------------
# Losses and the compute cast
# --------------------------------------------------------------------------


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position cross entropy in fp32, logsumexp form. logits
    ``(..., V)``; labels broadcast against ``logits.shape[:-1]``."""
    logits = logits.float()
    labels = labels.expand(logits.shape[:-1])
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.unsqueeze(-1)).squeeze(-1)
    return logz - gold


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE per sequence. logits ``(B, L, V)``, tokens
    ``(B, L)``."""
    return softmax_xent(logits[:, :-1], tokens[:, 1:]).mean(dim=-1)


def cast_params_for_compute(params: dict, compute: torch.dtype, *,
                            skip=("embed",)) -> dict:
    """Float leaves cast to the compute dtype (fp32 master store, bf16
    compute). ``skip`` keys (embed tables) are cast after lookup instead,
    so no second copy of a ``(V, D)`` table is made. A leaf already in the
    compute dtype is kept as it is (no copy)."""
    def cast(v):
        if isinstance(v, dict):
            return {k: cast(x) for k, x in v.items()}
        return v.to(compute) if v.is_floating_point() else v

    return {k: (v if k in skip else cast(v)) for k, v in params.items()}
