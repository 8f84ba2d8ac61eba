"""Mamba2 (SSD, state-space duality) blocks and the pure-SSM model
(mamba2-370m), the JAX package's ``models/ssm.py`` in PyTorch.

The chunked SSD algorithm of arXiv:2405.21060: the sequence is split into
chunks of Q tokens; within a chunk the recurrence is evaluated in its
quadratic dual form, and chunk states are carried from chunk to chunk.
The full-sequence scan (the JAX package's ``ssm.py:203``) runs kernel 9,
``kernels/ssd_scan.ssd_scan``, with ``chunk = min(cfg.ssm_chunk, L)``; its
plain version ``ssd_chunked`` (and ``_segsum``) live beside the kernel
and are re-exported here under their JAX names. The D skip and the gating
stay outside the kernel.

Two SSD routes (``SSD_MODES``), picked by the callers' ``ssd`` argument:
``"cuda"`` (every serving path) is kernel 9, which has no backward;
``"chunked"`` (the training route of ``models/registry.build_model(...,
train=True)``, which only the train launcher takes) is ``ssd_chunked``,
the JAX package's ``models/ssm.py:44`` function, under autograd, as the
JAX package trains through it and through no Pallas kernel. Decode keeps a constant-size ``(H, P, N)`` state
per layer.

Layer layout follows the Mamba2 reference: in_proj -> (z, x, B, C, dt);
short causal depthwise conv over (x, B, C); SSD; gated RMSNorm; out_proj.
Every function also takes request-batched params (each leaf with a
leading ``(B,)`` axis, ``models/layers.py``). The cache is written in
place: the prefill copies each layer's SSD state and conv tail into the
cache it is given and sets its ``pos`` (a 0-dim int64 tensor on the
device), and each decode step writes the new states over the old and
advances ``pos`` by one, so a CUDA graph captured over the cache's
tensors reads the current state (``serve/server.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ssd_scan import _segsum, ssd_chunked, ssd_scan  # noqa: F401
from repro_torch.models.layers import (
    apply_norm,
    cast_params_for_compute,
    dense_init,
    embed_init,
    embed_lookup,
    init_device,
    unstack_layers,
    linear,
    per_feature,
    rmsnorm_init,
    stack_init,
    uniform,
)


SSD_MODES = ("cuda", "chunked")


def _ssd(mode: str):
    """The SSD function of route ``mode`` (``SSD_MODES``)."""
    if mode == "cuda":
        return ssd_scan
    if mode == "chunked":
        return ssd_chunked
    raise ValueError(f"unknown SSD route {mode!r}; have {SSD_MODES}")


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor):
    """Single-token recurrence: state ``(B, H, P, N)``, x ``(B, H, P)``, dt
    ``(B, H)``, A ``(H,)`` or ``(B, H)``, Bm/Cm ``(B, G, N)``. Returns
    (y (B, H, P), new_state)."""
    rep = x.shape[1] // Bm.shape[1]
    bh = Bm.repeat_interleave(rep, dim=1).float()           # (B, H, N)
    ch = Cm.repeat_interleave(rep, dim=1).float()
    da = torch.exp(dt.float() * A.float())                  # (B, H)
    upd = torch.einsum("bh,bhp,bhn->bhpn", dt.float(), x.float(), bh)
    new_state = state.float() * da[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, ch)
    return y.to(x.dtype), new_state.to(state.dtype)


# --------------------------------------------------------------------------
# Mamba2 layer
# --------------------------------------------------------------------------


def _conv_dim(cfg: ArchConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def init_mamba_layer(gen: torch.Generator | None, cfg: ArchConfig) -> dict:
    dtype, dev, h = cfg.param_dtype_torch(), init_device(gen), cfg.ssm_heads
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + h
    # dt bias: softplus^-1 of dt ~ logU[1e-3, 1e-1]
    dt0 = torch.exp(uniform(gen, (h,)) * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    conv_w = dense_init(gen, cfg.ssm_conv, _conv_dim(cfg), scale=0.2)
    return {
        "ln": rmsnorm_init(cfg.d_model, dtype, dev),
        "in_proj": dense_init(gen, cfg.d_model, d_in_proj, dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((_conv_dim(cfg),), dtype=dtype, device=dev),
        "A_log": torch.log(1.0 + 15.0 * uniform(gen, (h,))),   # log U[1, 16]
        "dt_bias": dt_bias,
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "gate_ln": rmsnorm_init(cfg.d_inner, dtype, dev),
        "out_proj": dense_init(gen, cfg.d_inner, cfg.d_model, dtype),
    }


def _causal_depthwise_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """u: ``(B, L, C)``; w: ``(K, C)`` (or ``(B, K, C)``); b ``(C,)`` (or
    ``(B, C)``): causal depthwise conv via shifted adds (K is tiny: 4)."""
    k, l = w.shape[-2], u.shape[1]
    out = torch.zeros_like(u)
    for i in range(k):
        shifted = F.pad(u, (0, 0, k - 1 - i, 0))[:, :l]
        out = out + shifted * per_feature(w[..., i, :], u)
    return F.silu(out + per_feature(b, u))


def _split_in_proj(zxbcdt: torch.Tensor, cfg: ArchConfig):
    di = cfg.d_inner
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + _conv_dim(cfg)]
    dt = zxbcdt[..., di + _conv_dim(cfg):]
    return z, xbc, dt


def _heads_last(p: torch.Tensor) -> torch.Tensor:
    """A per-head vector ``(H,)`` or ``(B, H)`` shaped to broadcast against
    ``(B, ..., H, P)`` with one ``...`` axis."""
    return p[:, None, :, None] if p.dim() == 2 else p[:, None]


def apply_mamba_layer(p: dict, hidden: torch.Tensor, *, cfg: ArchConfig,
                      return_state: bool = False, ssd: str = "cuda"):
    """Full-sequence Mamba2 block with residual. hidden: ``(B, L, D)``;
    ``ssd`` the SSD route (``SSD_MODES``).

    ``return_state=True`` also returns this layer's decode cache entry: the
    final SSD state (fp32) and the last (K-1) pre-conv tokens."""
    b, l, _ = hidden.shape
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    x_in = apply_norm("rmsnorm", p["ln"], hidden)
    zxbcdt = linear(x_in, p["in_proj"])
    z, xbc_raw, dt_raw = _split_in_proj(zxbcdt, cfg)
    xbc = _causal_depthwise_conv(xbc_raw, p["conv_w"], p["conv_b"])
    x = xbc[..., :di].reshape(b, l, h, cfg.ssm_headdim)
    Bm = xbc[..., di:di + g * n].reshape(b, l, g, n)
    Cm = xbc[..., di + g * n:].reshape(b, l, g, n)
    dt = F.softplus(dt_raw.float() + per_feature(p["dt_bias"], dt_raw))   # (B, L, H)
    A = -torch.exp(p["A_log"])
    y, final_state = _ssd(ssd)(x.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous(),
                               chunk=min(cfg.ssm_chunk, l))
    y = y + x * _heads_last(p["D"]).to(x.dtype)
    y = apply_norm("rmsnorm", p["gate_ln"], y.reshape(b, l, di) * F.silu(z))
    out = hidden + linear(y, p["out_proj"])
    if return_state:
        k = p["conv_w"].shape[-2]
        return out, {"ssm": final_state, "conv": xbc_raw[:, l - (k - 1):, :]}
    return out


def init_mamba_cache(cfg: ArchConfig, n_layers: int, batch: int, dtype=None, *,
                     device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    return {
        "ssm": torch.zeros((n_layers, batch, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state),
                           dtype=dtype or torch.float32, device=dev),
        "conv": torch.zeros((n_layers, batch, cfg.ssm_conv - 1, _conv_dim(cfg)),
                            dtype=cfg.compute_dtype_torch(), device=dev),
    }


def decode_mamba_layer(p: dict, hidden: torch.Tensor, layer_cache: dict, *,
                       cfg: ArchConfig):
    """Single-token Mamba2 step. hidden ``(B, 1, D)``."""
    b = hidden.shape[0]
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    x_in = apply_norm("rmsnorm", p["ln"], hidden)
    zxbcdt = linear(x_in, p["in_proj"])[:, 0]                 # (B, d_in_proj)
    z, xbc, dt_raw = _split_in_proj(zxbcdt, cfg)
    win = torch.cat([layer_cache["conv"], xbc[:, None, :]], dim=1)   # (B, K, C)
    w = p["conv_w"] if p["conv_w"].dim() == 3 else p["conv_w"][None]
    conv = F.silu((win * w).sum(dim=1) + p["conv_b"])
    x = conv[..., :di].reshape(b, h, cfg.ssm_headdim)
    Bm = conv[..., di:di + g * n].reshape(b, g, n)
    Cm = conv[..., di + g * n:].reshape(b, g, n)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])           # (B, H)
    A = -torch.exp(p["A_log"])
    y, new_state = ssd_decode_step(layer_cache["ssm"], x, dt, A, Bm, Cm)
    y = y + x * p["D"][..., :, None].to(x.dtype)
    y = apply_norm("rmsnorm", p["gate_ln"], y.reshape(b, 1, di) * F.silu(z[:, None, :]))
    return hidden + linear(y, p["out_proj"]), {"ssm": new_state, "conv": win[:, 1:]}


# --------------------------------------------------------------------------
# Pure-SSM model (mamba2-370m)
# --------------------------------------------------------------------------


def init_ssm_model(gen: torch.Generator | None, cfg: ArchConfig) -> dict:
    """Random parameters drawn from ``gen`` on its device (``gen=None``:
    the tree on the meta device, shapes and dtypes only)."""
    dtype = cfg.param_dtype_torch()
    return {
        "embed": embed_init(gen, cfg.vocab_padded, cfg.d_model, dtype),
        "layers": stack_init(lambda g_: init_mamba_layer(g_, cfg), gen, cfg.n_layers),
        "ln_f": rmsnorm_init(cfg.d_model, dtype, init_device(gen)),
        "head": dense_init(gen, cfg.d_model, cfg.vocab_padded, dtype),
    }


def _embed(params: dict, tokens: torch.Tensor, cfg: ArchConfig):
    compute = cfg.compute_dtype_torch()
    h = embed_lookup(params["embed"], tokens).to(compute)
    return h, cast_params_for_compute(params, compute), params["embed"].dim() == 3


def ssm_forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig, *,
                ssd: str = "cuda"):
    h, params, batched = _embed(params, tokens, cfg)
    layers = unstack_layers(params["layers"], batched)
    for i in range(cfg.n_layers):
        h = apply_mamba_layer(layers[i], h, cfg=cfg,
                              ssd=ssd)
    h = apply_norm("rmsnorm", params["ln_f"], h)
    logits = linear(h, params["head"])
    return logits, torch.zeros((), dtype=torch.float32, device=h.device), None


def ssm_init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, *,
                   device: str | torch.device = "cuda") -> dict:
    del max_len  # constant-size state: the whole point
    cache = init_mamba_cache(cfg, cfg.n_layers, batch, dtype, device=device)
    cache["pos"] = torch.zeros((), dtype=torch.int64, device=cache["ssm"].device)
    return cache


def ssm_prefill(params: dict, tokens: torch.Tensor, cfg: ArchConfig, cache: dict) -> dict:
    """Run the chunked scan over the prompt and copy each layer's decode
    state (SSD state + conv tail) into ``cache``, and the prompt's length
    into its ``pos``, all in place; returns ``cache``."""
    h, params, batched = _embed(params, tokens, cfg)
    layers = unstack_layers(params["layers"], batched)
    for i in range(cfg.n_layers):
        h, st = apply_mamba_layer(layers[i], h, cfg=cfg,
                                  return_state=True)
        cache["ssm"][i].copy_(st["ssm"])
        cache["conv"][i].copy_(st["conv"])
    cache["pos"].fill_(tokens.shape[1])
    return cache


def ssm_decode_step(params: dict, cache: dict, tokens: torch.Tensor, cfg: ArchConfig):
    """tokens ``(B, 1)``. Returns (logits (B, 1, V), cache): the same cache
    and tensors, each layer's state written and ``pos`` advanced by one in
    place."""
    h, params, batched = _embed(params, tokens, cfg)
    layers = unstack_layers(params["layers"], batched)
    for i in range(cfg.n_layers):
        h, new_c = decode_mamba_layer(layers[i], h,
                                      {"ssm": cache["ssm"][i], "conv": cache["conv"][i]},
                                      cfg=cfg)
        cache["ssm"][i].copy_(new_c["ssm"])
        cache["conv"][i].copy_(new_c["conv"])
    h = apply_norm("rmsnorm", params["ln_f"], h)
    logits = linear(h, params["head"])
    cache["pos"].add_(1)
    return logits, cache
