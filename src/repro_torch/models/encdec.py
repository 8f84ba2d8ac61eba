"""Whisper-style encoder-decoder transformer backbone [arXiv:2212.04356],
the JAX package's ``models/encdec.py`` function for function.

The audio frontend (mel spectrogram + conv feature extractor) is a stub,
as in JAX: the batch carries precomputed frame embeddings ``frames`` ``(B,
encoder_frames, encoder_d_model)``. The backbone: a bidirectional encoder
(attention ``causal=False`` over all 1,500 frames), a causal decoder with
cross-attention over the encoder's output, and parameter-free sinusoidal
positions.

Attention runs through ``models/attention.attention``: kernel 8 in the
flash modes (``"cuda"``, ``"pallas"``, ``"blocked"``) at whisper's ragged
lengths (1,500 frames; the decoder's own length), ``ref_attention`` in
``"ref"``. The layer stacks keep the JAX package's stacked ``(L, ...)``
leaves and run as Python loops over them (``layers.unstack_layers``), as
``models/transformer.py`` does. The port's families take no ``remat``:
under autograd (the training route, ``registry.build_model(train=True)``)
every layer keeps its activations.

The decode path keeps its position on the device: the cache's ``pos`` is
a 0-dim int64 tensor, the self-attention k/v rows are written into the
cache in place, and the cross-attention cache (``xk``, ``xv``) is filled by
``encdec_prefill_cross`` and read by ``decode_attention`` at ``cur_pos = T
− 1`` (every frame valid), as JAX reads it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import attention, decode_attention
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    cast_params_for_compute,
    dense_init,
    embed_init,
    embed_lookup,
    init_device,
    init_mlp,
    linear,
    rmsnorm_init,
    stack_init,
    unstack_layers,
)


def sinusoidal_positions(length: int, dim: int, offset=0,
                         device: str | torch.device | None = None) -> torch.Tensor:
    """``(length, dim)`` fp32: sin on the even columns, cos on the odd, at
    positions ``arange(length) + offset`` (``offset`` an int or a 0-dim
    device tensor, never read on the host)."""
    if isinstance(offset, torch.Tensor):
        device = offset.device
    pos = (torch.arange(length, device=device)[:, None] + offset).float()
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros((length, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def _init_attn(gen: torch.Generator | None, cfg: ArchConfig, d_model: int) -> dict:
    hd, dtype = cfg.head_dim, cfg.param_dtype_torch()
    return {
        "wq": dense_init(gen, d_model, cfg.n_heads * hd, dtype),
        "wk": dense_init(gen, d_model, cfg.n_kv_heads * hd, dtype),
        "wv": dense_init(gen, d_model, cfg.n_kv_heads * hd, dtype),
        "wo": dense_init(gen, cfg.n_heads * hd, d_model, dtype),
    }


def init_encoder_layer(gen: torch.Generator | None, cfg: ArchConfig) -> dict:
    dtype, dev = cfg.param_dtype_torch(), init_device(gen)
    d = cfg.encoder_d_model or cfg.d_model
    return {
        "ln1": rmsnorm_init(d, dtype, dev),
        "ln2": rmsnorm_init(d, dtype, dev),
        "attn": _init_attn(gen, cfg, d),
        "mlp": init_mlp(gen, d, cfg.d_ff, cfg.act, dtype),
    }


def init_decoder_layer(gen: torch.Generator | None, cfg: ArchConfig) -> dict:
    dtype, dev, d = cfg.param_dtype_torch(), init_device(gen), cfg.d_model
    return {
        "ln1": rmsnorm_init(d, dtype, dev),
        "ln_x": rmsnorm_init(d, dtype, dev),
        "ln2": rmsnorm_init(d, dtype, dev),
        "attn": _init_attn(gen, cfg, d),
        "xattn": _init_attn(gen, cfg, d),
        "mlp": init_mlp(gen, d, cfg.d_ff, cfg.act, dtype),
    }


def init_encdec(gen: torch.Generator | None, cfg: ArchConfig) -> dict:
    """Random parameters drawn from ``gen`` on its device (``gen=None``:
    the tree on the meta device), with the JAX package's keys and shapes;
    ``enc_proj`` when ``encoder_d_model`` differs from ``d_model``."""
    dtype, dev = cfg.param_dtype_torch(), init_device(gen)
    d_enc = cfg.encoder_d_model or cfg.d_model
    params = {
        "enc_layers": stack_init(lambda g: init_encoder_layer(g, cfg), gen,
                                 cfg.encoder_layers),
        "enc_ln": rmsnorm_init(d_enc, dtype, dev),
        "embed": embed_init(gen, cfg.vocab_padded, cfg.d_model, dtype),
        "dec_layers": stack_init(lambda g: init_decoder_layer(g, cfg), gen, cfg.n_layers),
        "dec_ln": rmsnorm_init(cfg.d_model, dtype, dev),
        "head": dense_init(gen, cfg.d_model, cfg.vocab_padded, dtype),
    }
    if d_enc != cfg.d_model:
        params["enc_proj"] = dense_init(gen, d_enc, cfg.d_model, dtype)
    return params


def _mha(p: dict, x_q: torch.Tensor, x_kv: torch.Tensor, cfg: ArchConfig, *,
         causal: bool, mode: str) -> torch.Tensor:
    b, lq, _ = x_q.shape
    lkv, hd = x_kv.shape[1], cfg.head_dim
    q = linear(x_q, p["wq"]).reshape(b, lq, cfg.n_heads, hd)
    k = linear(x_kv, p["wk"]).reshape(b, lkv, cfg.n_kv_heads, hd)
    v = linear(x_kv, p["wv"]).reshape(b, lkv, cfg.n_kv_heads, hd)
    out = attention(q, k, v, mode=mode, causal=causal)
    return linear(out.reshape(b, lq, -1), p["wo"])


def _layers(stacked: dict, params: dict) -> list:
    return unstack_layers(stacked, params["embed"].dim() == 3)


def encode(params: dict, frames: torch.Tensor, cfg: ArchConfig, *,
           attn_mode: str = "cuda") -> torch.Tensor:
    """frames ``(B, T, encoder_d_model)`` stub embeddings -> ``(B, T,
    d_model)`` in the compute dtype."""
    compute = cfg.compute_dtype_torch()
    params = cast_params_for_compute(params, compute)
    h = frames.to(compute)
    h = h + sinusoidal_positions(h.shape[1], h.shape[2], device=h.device).to(compute)
    for lp in _layers(params["enc_layers"], params):
        x = apply_norm("rmsnorm", lp["ln1"], h)
        h = h + _mha(lp["attn"], x, x, cfg, causal=False, mode=attn_mode)
        x2 = apply_norm("rmsnorm", lp["ln2"], h)
        h = h + apply_mlp(lp["mlp"], x2, cfg.act)
    h = apply_norm("rmsnorm", params["enc_ln"], h)
    if "enc_proj" in params:
        h = linear(h, params["enc_proj"])
    return h


def encdec_forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig, *,
                   frames: torch.Tensor, attn_mode: str = "cuda"):
    """Teacher-forced decode over target tokens ``(B, L)``. Returns
    (logits ``(B, L, V)``, aux 0, None)."""
    compute = cfg.compute_dtype_torch()
    enc = encode(params, frames, cfg, attn_mode=attn_mode)
    h = embed_lookup(params["embed"], tokens).to(compute)
    params = cast_params_for_compute(params, compute)
    h = h + sinusoidal_positions(tokens.shape[1], cfg.d_model, device=h.device).to(compute)
    for lp in _layers(params["dec_layers"], params):
        x = apply_norm("rmsnorm", lp["ln1"], h)
        h = h + _mha(lp["attn"], x, x, cfg, causal=True, mode=attn_mode)
        xx = apply_norm("rmsnorm", lp["ln_x"], h)
        h = h + _mha(lp["xattn"], xx, enc, cfg, causal=False, mode=attn_mode)
        x2 = apply_norm("rmsnorm", lp["ln2"], h)
        h = h + apply_mlp(lp["mlp"], x2, cfg.act)
    h = apply_norm("rmsnorm", params["dec_ln"], h)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return linear(h, params["head"]), aux, None


def encdec_init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, *,
                      device: str | torch.device = "cuda") -> dict:
    """Self-attention k/v ``(L_dec, B, max_len, Hkv, hd)``, the
    cross-attention ``xk``/``xv`` ``(L_dec, B, T, Hkv, hd)`` (filled by
    ``encdec_prefill_cross``) and ``pos`` 0."""
    dtype = dtype or cfg.compute_dtype_torch()
    dev = resolve_device(device)
    hd, t = cfg.head_dim, cfg.encoder_frames

    def zeros(length):
        return torch.zeros((cfg.n_layers, batch, length, cfg.n_kv_heads, hd), dtype=dtype,
                           device=dev)

    return {"k": zeros(max_len), "v": zeros(max_len), "xk": zeros(t), "xv": zeros(t),
            "pos": torch.zeros((), dtype=torch.int64, device=dev)}


def encdec_prefill_cross(params: dict, frames: torch.Tensor, cfg: ArchConfig, cache: dict, *,
                         attn_mode: str = "cuda") -> dict:
    """Fill the cross-attention k/v from the encoder's output, in place;
    ``pos`` stays where it is (0 after ``encdec_init_cache``). Returns
    ``cache``."""
    enc = encode(params, frames, cfg, attn_mode=attn_mode)
    params = cast_params_for_compute(params, cfg.compute_dtype_torch())
    b, t, _ = enc.shape
    for i, lp in enumerate(_layers(params["dec_layers"], params)):
        cache["xk"][i] = linear(enc, lp["xattn"]["wk"]).reshape(b, t, cfg.n_kv_heads,
                                                                 cfg.head_dim)
        cache["xv"][i] = linear(enc, lp["xattn"]["wv"]).reshape(b, t, cfg.n_kv_heads,
                                                                 cfg.head_dim)
    return cache


def encdec_decode_step(params: dict, cache: dict, tokens: torch.Tensor, cfg: ArchConfig):
    """tokens ``(B, 1)``. Returns (logits ``(B, 1, V)``, cache): the same
    cache, its self-attention row written and ``pos`` advanced by one in
    place."""
    compute = cfg.compute_dtype_torch()
    b, hd, t = tokens.shape[0], cfg.head_dim, cfg.encoder_frames
    pos = cache["pos"]
    h = embed_lookup(params["embed"], tokens).to(compute)
    params = cast_params_for_compute(params, compute)
    h = h + sinusoidal_positions(1, cfg.d_model, offset=pos).to(compute)
    row = pos.view(1)
    for i, lp in enumerate(_layers(params["dec_layers"], params)):
        x = apply_norm("rmsnorm", lp["ln1"], h)
        q = linear(x, lp["attn"]["wq"]).reshape(b, 1, cfg.n_heads, hd)
        k = linear(x, lp["attn"]["wk"]).reshape(b, 1, cfg.n_kv_heads, hd)
        v = linear(x, lp["attn"]["wv"]).reshape(b, 1, cfg.n_kv_heads, hd)
        kc, vc = cache["k"][i], cache["v"][i]
        kc.index_copy_(1, row, k.to(kc.dtype))
        vc.index_copy_(1, row, v.to(vc.dtype))
        a = decode_attention(q, kc, vc, pos)
        h = h + linear(a.reshape(b, 1, -1), lp["attn"]["wo"])
        # cross-attention against the precomputed encoder k/v (every frame valid)
        xx = apply_norm("rmsnorm", lp["ln_x"], h)
        qx = linear(xx, lp["xattn"]["wq"]).reshape(b, 1, cfg.n_heads, hd)
        ax = decode_attention(qx, cache["xk"][i], cache["xv"][i], t - 1)
        h = h + linear(ax.reshape(b, 1, -1), lp["xattn"]["wo"])
        x2 = apply_norm("rmsnorm", lp["ln2"], h)
        h = h + apply_mlp(lp["mlp"], x2, cfg.act)
    h = apply_norm("rmsnorm", params["dec_ln"], h)
    logits = linear(h, params["head"])
    pos.add_(1)
    return logits, cache
