"""Mixture-of-Experts FFN (Switch/Mixtral-style top-k routing with expert
capacity), the JAX package's ``models/moe.py`` in PyTorch.

Each token's router picks its ``top_k`` experts (ties to the lower
index, as ``jax.lax.top_k``); each expert takes at most ``capacity``
tokens, in token order, and drops the rest. Dispatch scatters the kept
tokens into an ``(E, C, D)`` buffer, the experts run as batched products
over it, and the combine gathers each (token, slot) back, weighted by its
normalized gate. Capacity is Python arithmetic on the static shapes,
exactly the JAX package's: ``int(max(1, capacity_factor · top_k · t /
E))`` capped at t, and t itself for a one-token decode step (drop-free).

Routing groups. The JAX package routes the ``B·L`` tokens of a batch
together (``dispatch`` ``"cumsum"`` or ``"sort"``) or each sequence alone
(``"grouped"``, a ``vmap`` over the rows), and its server ``vmap``s
prefill and decode over requests, so each request is routed alone. Here
``_moe_core`` takes a leading group axis ``G`` and routes each group
alone: the ``B·L`` tokens as one group; each sequence as a group under
``"grouped"``; and each request as a group when the leaves carry the
request axis ``(B, ...)`` (``models/layers.py``), whatever ``dispatch``
says, as the server's ``vmap`` does. ``aux`` is then one value per
request.

Nothing depends on the data's shape (no ``nonzero``, no boolean
indexing, no host reads), so a decode step through these layers can be
captured into a CUDA graph. The router, top-k and expert products run
outside any kernel in the JAX package too, and stay PyTorch ops here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, normal

DISPATCH_MODES = ("cumsum", "sort", "grouped")


def init_moe(gen: torch.Generator | None, d_model: int, d_ff: int, n_experts: int,
             act: str, dtype) -> dict:
    """Router ``(D, E)`` in fp32 (as the JAX package's), experts ``(E, D,
    F)`` / ``(E, F, D)`` in ``dtype``; a gate projection for silu."""
    p = {
        "router": dense_init(gen, d_model, n_experts, torch.float32),
        "w_in": (normal(gen, (n_experts, d_model, d_ff)) / math.sqrt(d_model)).to(dtype),
        "w_out": (normal(gen, (n_experts, d_ff, d_model)) / math.sqrt(d_ff)).to(dtype),
    }
    if act == "silu":
        p["w_gate"] = (normal(gen, (n_experts, d_model, d_ff))
                       / math.sqrt(d_model)).to(dtype)
    return p


def _one_hot(idx: torch.Tensor, e: int) -> torch.Tensor:
    """int64 one-hot of ``idx`` over ``e`` classes (a comparison: no
    range check that reads the device)."""
    return (idx[..., None] == torch.arange(e, device=idx.device)).long()


def _slot_positions_cumsum(flat_expert: torch.Tensor, e: int) -> torch.Tensor:
    """Position of each (token, slot) in its expert's queue by a running
    sum over the one-hot matrix. ``flat_expert`` ``(..., T·k)`` in
    slot-major order (token t, slot j at t·k + j)."""
    onehot = _one_hot(flat_expert, e)                      # (..., T·k, E)
    pos = onehot.cumsum(dim=-2) - onehot
    return (pos * onehot).sum(dim=-1)


def _slot_positions_sort(flat_expert: torch.Tensor, e: int) -> torch.Tensor:
    """The same positions by a stable sort: rank in the expert-sorted order
    less the expert's segment start."""
    tk = flat_expert.shape[-1]
    order = torch.sort(flat_expert, dim=-1, stable=True).indices
    ar = torch.arange(tk, device=flat_expert.device).expand_as(order)
    ranks = torch.empty_like(flat_expert).scatter_(-1, order, ar)
    counts = torch.zeros((*flat_expert.shape[:-1], e), dtype=torch.int64,
                         device=flat_expert.device)
    counts.scatter_add_(-1, flat_expert, torch.ones_like(flat_expert))
    starts = counts.cumsum(dim=-1) - counts
    return ranks - starts.gather(-1, flat_expert)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, in descending
    order, equal values in index order (a stable sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity_of(t: int, seq_len: int, *, top_k: int, capacity_factor: float,
                n_experts: int) -> int:
    """Slots per expert for a group of t tokens of sequences of
    ``seq_len``: the JAX package's formula, t for a one-token decode
    step, at most t."""
    capacity = int(max(1, capacity_factor * top_k * t / n_experts))
    if seq_len == 1:
        capacity = t
    return min(capacity, t)


def _slots(flat_expert: torch.Tensor, e: int, capacity: int, dispatch: str):
    """(keep, slot): whether each (token, slot) fits its expert's capacity,
    and its buffer slot (a dropped one lands on the last slot with a zero
    contribution)."""
    if dispatch == "cumsum":
        pos = _slot_positions_cumsum(flat_expert, e)
    else:
        pos = _slot_positions_sort(flat_expert, e)
    keep = pos < capacity
    return keep, torch.where(keep, pos, capacity - 1)


def _moe_core(params: dict, x: torch.Tensor, *, top_k: int, capacity_factor: float,
              act: str, dispatch: str, seq_len: int):
    """x ``(G, T, D)``: G groups of T tokens, each routed alone; params'
    leaves shared or one per group (``(G, ...)``). Returns (out ``(G, T,
    D)`` in x's dtype, aux ``(G,)``)."""
    g, t, d = x.shape
    e = params["w_in"].shape[-3]

    logits = x.float() @ params["router"].float()          # (G, T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, top_k)            # (G, T, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    # Switch aux loss: E · Σ_e f_e · P_e
    me = probs.mean(dim=1)                                  # (G, E)
    ce = _one_hot(expert_idx, e).float().sum(dim=2).mean(dim=1)
    aux = e * (me * ce).sum(dim=-1) / top_k

    capacity = capacity_of(t, seq_len, top_k=top_k, capacity_factor=capacity_factor,
                           n_experts=e)
    flat_expert = expert_idx.reshape(g, t * top_k)          # slot-major
    keep, slot = _slots(flat_expert, e, capacity, dispatch)
    row = (flat_expert * capacity + slot)[..., None].expand(g, t * top_k, d)

    # the token of each (token, slot) pair is x[token_of] with token_of =
    # repeat(arange(T), k); kept pairs are unique per (expert, slot), so
    # the scatter-add only ever adds a dropped pair's zero to a row, and
    # gives the same bits in any order
    tokens = x[:, :, None, :].expand(g, t, top_k, d).reshape(g, t * top_k, d)
    contrib = torch.where(keep[..., None], tokens, 0).to(x.dtype)
    buf = x.new_zeros((g, e * capacity, d)).scatter_add_(1, row, contrib)
    buf = buf.view(g, e, capacity, d)

    h = buf @ params["w_in"]                                # (G, E, C, F)
    if act == "silu":
        h = F.silu(buf @ params["w_gate"]) * h
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")                   # jax.nn.gelu's default
    else:
        raise ValueError(act)
    out_buf = h @ params["w_out"]                           # (G, E, C, D)

    gathered = out_buf.view(g, e * capacity, d).gather(1, row)   # (G, T·k, D)
    gathered = torch.where(keep[..., None], gathered, 0)
    weighted = (gathered.float() * gate_vals.reshape(g, t * top_k, 1)).view(g, t, top_k, d)
    if dispatch == "cumsum":
        # the scatter-add over token_of, slot by slot in token order (the
        # k slots of a token are contiguous, so no atomics are needed)
        out = torch.zeros((g, t, d), dtype=torch.float32, device=x.device)
        for j in range(top_k):
            out = out + weighted[:, :, j]
    else:
        out = weighted.sum(dim=2)
    return out.to(x.dtype), aux


def apply_moe(params: dict, x: torch.Tensor, *, top_k: int, capacity_factor: float,
              act: str, dispatch: str = "sort"):
    """x ``(B, L, D)``. Returns (out ``(B, L, D)``, aux): aux a scalar for
    shared leaves, ``(B,)`` (one per request) for request-batched ones.

    ``"cumsum"`` and ``"sort"`` route the B·L tokens together (one
    capacity over the batch) and give the same result; ``"grouped"``
    routes each sequence alone and averages aux. Request-batched leaves
    route each request alone in every mode."""
    if dispatch not in DISPATCH_MODES:
        raise ValueError(f"unknown MoE dispatch {dispatch!r}; have {DISPATCH_MODES}")
    b, l, d = x.shape
    batched = params["w_in"].dim() == 4
    core = "sort" if dispatch == "grouped" else dispatch
    kw = dict(top_k=top_k, capacity_factor=capacity_factor, act=act, dispatch=core,
              seq_len=l)
    if batched:
        return _moe_core(params, x, **kw)
    if dispatch == "grouped":
        out, aux = _moe_core(params, x, **kw)
        return out, aux.mean()
    out, aux = _moe_core(params, x.reshape(1, b * l, d), **kw)
    return out.reshape(b, l, d), aux[0]
