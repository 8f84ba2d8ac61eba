"""Decoder-only transformer (dense, MoE and VLM backbone) with GQA, RoPE,
qk-norm, sliding-window and local:global attention, and a KV-cache decode
path.

One implementation covers olmo-1b, olmoe-1b-7b, phi3.5-moe, h2o-danube,
gemma3-1b, granite-3-8b and chameleon-34b (the VLM backbone reads VQ image
tokens through the same vocab), as the JAX package's
``models/transformer.py`` does. A config with ``n_experts > 0`` has an MoE
FFN in every layer (``models/moe.py``); ``forward`` sums the layers'
load-balance ``aux`` (one value per request for request-batched params).

The layer stack keeps the JAX package's stacked ``(L, ...)`` leaves and
runs them as a Python loop. Each layer's window is therefore a static
Python int: gemma3's per-layer local/global windows reach the flash
kernel as each layer's own static window, the counterpart of the JAX
package's traced ``dyn_window`` (which its ``"pallas"`` mode refuses).

Every function also takes request-batched params (each leaf with a
leading ``(B,)`` axis, ``models/layers.py``): B requests, each through its
own weights, in one batched forward. The decode path keeps its position
on the device, as the JAX package's int32 scalar: ``pos`` is a 0-dim int64
tensor (what ``index_copy_`` takes) that the prefill sets and each decode
step advances in place, and the k/v rows are written into the cache in
place. Nothing in a decode step reads a device value on the host, so the
step can be captured into a CUDA graph over the cache's tensors
(``serve/server.py``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import attention, decode_attention
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    apply_rope,
    cast_params_for_compute,
    dense_init,
    embed_init,
    embed_lookup,
    init_device,
    init_mlp,
    unstack_layers,
    linear,
    next_token_loss,
    rmsnorm_init,
    stack_init,
)
from repro_torch.models.moe import apply_moe, init_moe


def _norm_params(cfg: ArchConfig, dtype, device) -> dict:
    return rmsnorm_init(cfg.d_model, dtype, device) if cfg.norm == "rmsnorm" else {}


def layer_windows(cfg: ArchConfig) -> np.ndarray:
    """Per-layer window sizes; -1 = full causal attention.

    gemma3: repeating pattern of ``local_global_ratio`` local layers
    (window=local_window) followed by one global layer.
    """
    if cfg.local_global_ratio > 0:
        pat = [cfg.local_window] * cfg.local_global_ratio + [-1]
        w = [pat[i % len(pat)] for i in range(cfg.n_layers)]
        return np.array(w, dtype=np.int32)
    if cfg.window is not None:
        return np.full(cfg.n_layers, cfg.window, dtype=np.int32)
    return np.full(cfg.n_layers, -1, dtype=np.int32)


def static_window(cfg: ArchConfig) -> Optional[int]:
    """A single static window if all layers share one."""
    w = layer_windows(cfg)
    if (w == w[0]).all():
        return None if w[0] < 0 else int(w[0])
    return None


def _window(cfg: ArchConfig, i: int) -> Optional[int]:
    """Layer i's own static window (None: full causal)."""
    w = int(layer_windows(cfg)[i])
    return None if w < 0 else w


def init_layer(gen: torch.Generator | None, cfg: ArchConfig) -> dict:
    dtype, dev, hd = cfg.param_dtype_torch(), init_device(gen), cfg.head_dim
    p = {
        "ln1": _norm_params(cfg, dtype, dev),
        "ln2": _norm_params(cfg, dtype, dev),
        "attn": {
            "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, dtype),
            "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype),
            "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype),
            "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, dtype),
        },
    }
    if cfg.qk_norm:
        p["attn"]["q_norm"] = rmsnorm_init(hd, dtype, dev)
        p["attn"]["k_norm"] = rmsnorm_init(hd, dtype, dev)
    if cfg.n_experts > 0:
        p["moe"] = init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.act, dtype)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype)
    return p


def init_transformer(gen: torch.Generator | None, cfg: ArchConfig) -> dict:
    """Random parameters drawn from ``gen`` on its device (``gen=None``:
    the tree on the meta device, shapes and dtypes only)."""
    dtype = cfg.param_dtype_torch()
    params = {
        "embed": embed_init(gen, cfg.vocab_padded, cfg.d_model, dtype),
        "layers": stack_init(lambda g: init_layer(g, cfg), gen, cfg.n_layers),
        "ln_f": _norm_params(cfg, dtype, init_device(gen)),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, cfg.d_model, cfg.vocab_padded, dtype)
    return params


def _project_qkv(p_attn: dict, h: torch.Tensor, cfg: ArchConfig):
    b, l, _ = h.shape
    hd = cfg.head_dim
    q = linear(h, p_attn["wq"]).reshape(b, l, cfg.n_heads, hd)
    k = linear(h, p_attn["wk"]).reshape(b, l, cfg.n_kv_heads, hd)
    v = linear(h, p_attn["wv"]).reshape(b, l, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = apply_norm("rmsnorm", p_attn["q_norm"], q)
        k = apply_norm("rmsnorm", p_attn["k_norm"], k)
    return q, k, v


def apply_layer(p: dict, h: torch.Tensor, *, cfg: ArchConfig, positions: torch.Tensor,
                mode: str, window: Optional[int]):
    """Full-sequence layer. Returns (h, (k, v), aux)."""
    x = apply_norm(cfg.norm, p.get("ln1"), h)
    q, k, v = _project_qkv(p["attn"], x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    attn_out = attention(q, k, v, mode=mode, causal=True, window=window)
    b, l = attn_out.shape[:2]
    h = h + linear(attn_out.reshape(b, l, -1), p["attn"]["wo"])
    x2 = apply_norm(cfg.norm, p.get("ln2"), h)
    ffn_out, aux = _ffn(p, x2, cfg)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + ffn_out, (k, v), aux


def _ffn(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """The layer's FFN: (out, aux), the MoE's, or the MLP's with aux None
    (a dense decode step makes no aux)."""
    if cfg.n_experts > 0:
        return apply_moe(p["moe"], x, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                         act=cfg.act, dispatch=cfg.moe_dispatch)
    return apply_mlp(p["mlp"], x, cfg.act), None


def _head(params: dict, cfg: ArchConfig, compute: torch.dtype) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].transpose(-1, -2).to(compute)
    return params["head"]


def _run_layers(params: dict, tokens: torch.Tensor, cfg: ArchConfig, *, attn_mode: str,
                keep_kv: bool):
    """Embed, the layer stack, the final norm. Returns (h, compute-cast
    params, per-layer (k, v) list or None, the layers' summed aux)."""
    compute = cfg.compute_dtype_torch()
    batched = params["embed"].dim() == 3
    h = embed_lookup(params["embed"], tokens).to(compute)
    params = cast_params_for_compute(params, compute)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    kvs = [] if keep_kv else None
    aux_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    layers = unstack_layers(params["layers"], batched)
    for i in range(cfg.n_layers):
        h, kv, aux = apply_layer(layers[i], h, cfg=cfg,
                                 positions=positions, mode=attn_mode, window=_window(cfg, i))
        if cfg.n_experts > 0:
            aux_sum = aux_sum + aux
        if keep_kv:
            kvs.append(kv)
    return apply_norm(cfg.norm, params.get("ln_f"), h), params, kvs, aux_sum


def forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig, *,
            attn_mode: str = "cuda", return_cache: bool = False):
    """Full forward. Returns (logits, aux, cache_or_None): aux the layers'
    summed MoE load-balance loss (0 for dense layers); cache leaves carry
    a leading (n_layers,) axis: k/v ``(L_layers, B, L, Hkv, hd)``."""
    h, params, kvs, aux = _run_layers(params, tokens, cfg, attn_mode=attn_mode,
                                      keep_kv=return_cache)
    logits = linear(h, _head(params, cfg, h.dtype))
    if return_cache:
        cache = {"k": torch.stack([k for k, _ in kvs]),
                 "v": torch.stack([v for _, v in kvs]),
                 "pos": _position(tokens.shape[1], h.device)}
        return logits, aux, cache
    return logits, aux, None


def prefill(params: dict, tokens: torch.Tensor, cfg: ArchConfig, cache: dict, *,
            attn_mode: str = "cuda") -> dict:
    """Run the prompt ``(B, L)`` and write its k/v into rows ``[0, L)`` of
    ``cache`` and L into its ``pos``, all in place; returns ``cache``. The
    logits are not computed (the JAX package's prefill computes and drops
    them)."""
    _, _, kvs, _ = _run_layers(params, tokens, cfg, attn_mode=attn_mode, keep_kv=True)
    l = tokens.shape[1]
    for i, (k, v) in enumerate(kvs):
        cache["k"][i, :, :l] = k
        cache["v"][i, :, :l] = v
    cache["pos"].fill_(l)
    return cache


# --------------------------------------------------------------------------
# Decode path
# --------------------------------------------------------------------------


def _position(value: int, device: torch.device) -> torch.Tensor:
    """A cache position: a 0-dim int64 tensor on the cache's device."""
    return torch.full((), value, dtype=torch.int64, device=device)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, *,
               device: str | torch.device = "cuda") -> dict:
    dtype = dtype or cfg.compute_dtype_torch()
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": _position(0, dev)}


def decode_layer(p: dict, h: torch.Tensor, layer_cache: dict, *, cfg: ArchConfig,
                 pos: torch.Tensor, window: Optional[int]):
    """One-token layer step. layer_cache: dict(k=(B, Lc, Hkv, hd), v=...),
    row ``pos`` (a 0-dim int64 tensor) written in place: an index tensor,
    never a Python int, so nothing is read on the host."""
    x = apply_norm(cfg.norm, p.get("ln1"), h)
    q, k, v = _project_qkv(p["attn"], x, cfg)     # (B, 1, H, hd)
    row = pos.view(1)
    q = apply_rope(q, row, cfg.rope_theta)
    k = apply_rope(k, row, cfg.rope_theta)
    kc, vc = layer_cache["k"], layer_cache["v"]
    kc.index_copy_(1, row, k.to(kc.dtype))
    vc.index_copy_(1, row, v.to(vc.dtype))
    attn_out = decode_attention(q, kc, vc, pos, window=window)
    b = attn_out.shape[0]
    h = h + linear(attn_out.reshape(b, 1, -1), p["attn"]["wo"])
    x2 = apply_norm(cfg.norm, p.get("ln2"), h)
    return h + _ffn(p, x2, cfg)[0], {"k": kc, "v": vc}


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, cfg: ArchConfig):
    """tokens: (B, 1). Returns (logits (B, 1, V), cache): the same cache
    and tensors, its k/v row written and ``pos`` advanced by one in place."""
    compute = cfg.compute_dtype_torch()
    batched = params["embed"].dim() == 3
    h = embed_lookup(params["embed"], tokens).to(compute)
    params = cast_params_for_compute(params, compute)
    pos = cache["pos"]
    layers = unstack_layers(params["layers"], batched)
    for i in range(cfg.n_layers):
        h, _ = decode_layer(layers[i], h,
                            {"k": cache["k"][i], "v": cache["v"][i]}, cfg=cfg,
                            pos=pos, window=_window(cfg, i))
    h = apply_norm(cfg.norm, params.get("ln_f"), h)
    logits = linear(h, _head(params, cfg, compute))
    pos.add_(1)
    return logits, cache


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------


def _mask_pad_vocab(logits: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.vocab_padded == cfg.vocab:
        return logits
    bias = torch.zeros((cfg.vocab_padded,), dtype=logits.dtype, device=logits.device)
    bias[cfg.vocab:] = -1e30
    return logits + bias


def lm_loss(params, batch, cfg: ArchConfig, *, attn_mode="cuda", aux_weight: float = 0.01):
    logits, aux, _ = forward(params, batch["tokens"], cfg, attn_mode=attn_mode)
    per_seq = next_token_loss(_mask_pad_vocab(logits, cfg), batch["tokens"])
    return per_seq.mean() + aux_weight * aux


def lm_per_example_loss(params, batch, cfg: ArchConfig, *, attn_mode="cuda"):
    logits, _, _ = forward(params, batch["tokens"], cfg, attn_mode=attn_mode)
    return next_token_loss(_mask_pad_vocab(logits, cfg), batch["tokens"])   # (B,)
