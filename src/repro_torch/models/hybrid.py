"""Zamba2-style hybrid: a Mamba2 backbone and one SHARED attention block,
the JAX package's ``models/hybrid.py`` in PyTorch.

Zamba2 [arXiv:2411.15242] interleaves Mamba2 layers with a single
shared-weight attention(+MLP) block invoked at regular depth intervals:
after every ``attn_every`` Mamba2 layers, ``n_layers // attn_every``
times (zamba2-1.2b: segments ``[6, 6, 6, 6, 6, 6, 2]``, six invocations,
none after the last two layers). The block's weights are one set, reused
at every invocation; each invocation keeps its own KV rows in the cache's
``attn_k`` / ``attn_v`` ``(n_inv, B, Lc, Hkv, hd)``.

The Mamba2 layers are ``models/ssm.py``'s (kernel 9 in the prefill), the
shared block is ``models/transformer.py``'s layer (kernel 8 in the
prefill). As there, every function also takes request-batched params
(each leaf with a leading ``(B,)`` axis), and the cache is written in
place: the prefill copies each layer's SSD state and conv tail and each
invocation's k/v rows ``[0, L)`` into the cache it is given and sets its
``pos`` (a 0-dim int64 tensor on the device); each decode step writes
the states and the k/v row at ``pos`` and advances ``pos`` by one. A
decode step reads nothing on the host, so it can be captured into a CUDA
graph (``serve/server.py``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (
    apply_norm,
    cast_params_for_compute,
    dense_init,
    embed_init,
    embed_lookup,
    init_device,
    unstack_layers,
    linear,
    rmsnorm_init,
    stack_init,
)
from repro_torch.models.ssm import (
    apply_mamba_layer,
    decode_mamba_layer,
    init_mamba_cache,
    init_mamba_layer,
)


def segment_sizes(cfg: ArchConfig) -> list[int]:
    """Mamba-layer counts between shared-attention invocations."""
    k, n = cfg.attn_every, cfg.n_layers
    sizes = [k] * (n // k)
    if n % k:
        sizes.append(n % k)
    return sizes


def n_attn_invocations(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.attn_every


def _invocation_after(cfg: ArchConfig) -> dict:
    """``{Mamba layer index: invocation}``: the shared block runs after the
    last layer of each full segment."""
    out, lo = {}, 0
    for size in segment_sizes(cfg):
        lo += size
        inv = len(out)
        if inv < n_attn_invocations(cfg) and lo == (inv + 1) * cfg.attn_every:
            out[lo - 1] = inv
    return out


def init_hybrid(gen: torch.Generator | None, cfg: ArchConfig) -> dict:
    """Random parameters drawn from ``gen`` on its device (``gen=None``:
    the tree on the meta device, shapes and dtypes only)."""
    dtype = cfg.param_dtype_torch()
    return {
        "embed": embed_init(gen, cfg.vocab_padded, cfg.d_model, dtype),
        "mamba": stack_init(lambda g: init_mamba_layer(g, cfg), gen, cfg.n_layers),
        "shared": tfm.init_layer(gen, cfg),   # one attention+MLP block, reused
        "ln_f": rmsnorm_init(cfg.d_model, dtype, init_device(gen)),
        "head": dense_init(gen, cfg.d_model, cfg.vocab_padded, dtype),
    }


def _embed(params: dict, tokens: torch.Tensor, cfg: ArchConfig):
    compute = cfg.compute_dtype_torch()
    h = embed_lookup(params["embed"], tokens).to(compute)
    return h, cast_params_for_compute(params, compute), params["embed"].dim() == 3


def _run(params: dict, tokens: torch.Tensor, cfg: ArchConfig, *, attn_mode: str,
         cache: dict | None, ssd: str = "cuda"):
    """Embed and the hybrid stack; with ``cache``, each Mamba layer's
    decode state and each invocation's k/v are copied into it. Returns
    (h after the stack, compute-cast params)."""
    h, params, batched = _embed(params, tokens, cfg)
    l = tokens.shape[1]
    positions = torch.arange(l, device=tokens.device)
    after = _invocation_after(cfg)
    layers = unstack_layers(params["mamba"], batched)
    for i in range(cfg.n_layers):
        p = layers[i]
        if cache is None:
            h = apply_mamba_layer(p, h, cfg=cfg, ssd=ssd)
        else:
            h, st = apply_mamba_layer(p, h, cfg=cfg, return_state=True)
            cache["ssm"][i].copy_(st["ssm"])
            cache["conv"][i].copy_(st["conv"])
        if i in after:
            h, (k, v), _ = tfm.apply_layer(params["shared"], h, cfg=cfg, positions=positions,
                                           mode=attn_mode, window=cfg.window)
            if cache is not None:
                cache["attn_k"][after[i], :, :l] = k
                cache["attn_v"][after[i], :, :l] = v
    return h, params


def hybrid_forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig, *,
                   attn_mode: str = "cuda", ssd: str = "cuda"):
    """Returns (logits, aux = 0, None), as the JAX package's; ``ssd`` the
    Mamba layers' SSD route (``ssm.SSD_MODES``)."""
    h, params = _run(params, tokens, cfg, attn_mode=attn_mode, cache=None, ssd=ssd)
    h = apply_norm("rmsnorm", params["ln_f"], h)
    logits = linear(h, params["head"])
    return logits, torch.zeros((), dtype=torch.float32, device=h.device), None


def hybrid_prefill(params: dict, tokens: torch.Tensor, cfg: ArchConfig, cache: dict, *,
                   attn_mode: str = "cuda") -> dict:
    """Run the prompt ``(B, L)`` through the hybrid stack and write, in
    place, each layer's SSD state and conv tail, each invocation's k/v
    into rows ``[0, L)`` and L into ``pos``; returns ``cache``."""
    _run(params, tokens, cfg, attn_mode=attn_mode, cache=cache)
    cache["pos"].fill_(tokens.shape[1])
    return cache


def hybrid_init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, *,
                      device: str | torch.device = "cuda") -> dict:
    dtype = dtype or cfg.compute_dtype_torch()
    cache = init_mamba_cache(cfg, cfg.n_layers, batch, device=device)
    dev = cache["ssm"].device
    shape = (n_attn_invocations(cfg), batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cache["attn_k"] = torch.zeros(shape, dtype=dtype, device=dev)
    cache["attn_v"] = torch.zeros(shape, dtype=dtype, device=dev)
    cache["pos"] = torch.zeros((), dtype=torch.int64, device=dev)
    return cache


def _shared_attn_decode(p: dict, h: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, pos: torch.Tensor, cfg: ArchConfig):
    """One token through the shared block at ``pos``: its k/v written into
    row ``pos`` of this invocation's caches in place. Returns (h, k_cache,
    v_cache)."""
    h, kv = tfm.decode_layer(p, h, {"k": k_cache, "v": v_cache}, cfg=cfg, pos=pos,
                             window=cfg.window)
    return h, kv["k"], kv["v"]


def hybrid_decode_step(params: dict, cache: dict, tokens: torch.Tensor, cfg: ArchConfig):
    """tokens ``(B, 1)``. Returns (logits (B, 1, V), cache): the same cache
    and tensors, each layer's state and each invocation's k/v row written
    and ``pos`` advanced by one in place."""
    h, params, batched = _embed(params, tokens, cfg)
    pos = cache["pos"]
    after = _invocation_after(cfg)
    layers = unstack_layers(params["mamba"], batched)
    for i in range(cfg.n_layers):
        h, new_c = decode_mamba_layer(layers[i], h,
                                      {"ssm": cache["ssm"][i], "conv": cache["conv"][i]},
                                      cfg=cfg)
        cache["ssm"][i].copy_(new_c["ssm"])
        cache["conv"][i].copy_(new_c["conv"])
        if i in after:
            inv = after[i]
            h, _, _ = _shared_attn_decode(params["shared"], h, cache["attn_k"][inv],
                                          cache["attn_v"][inv], pos, cfg)
    h = apply_norm("rmsnorm", params["ln_f"], h)
    logits = linear(h, params["head"])
    pos.add_(1)
    return logits, cache
