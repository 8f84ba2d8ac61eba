"""Uniform model bundle: one construction point for the LM model zoo.

The JAX package's ``models/registry.py`` for the families the port has:
``dense``, ``moe`` and ``vlm`` (``models/transformer.py``, MoE layers from
``models/moe.py``), ``ssm`` (``models/ssm.py``) and ``hybrid``
(``models/hybrid.py``). Every bundle offers

    init(gen) -> params                          (drawn on gen's device)
    loss(params, batch) -> scalar                (training objective)
    per_example_loss(params, batch) -> (B,)      (FedSPD clustering step)
    forward(params, batch) -> (logits, aux)      (prefill/eval)
    init_cache(batch, max_len, *, device) -> cache
    prefill(params, batch, cache) -> cache       (fills KV / SSM state in place)
    decode_step(params, cache, tokens) -> (logits, cache)   (in place, pos + 1)

The cache's ``pos`` is a 0-dim int64 tensor on its device, and prefill and
decode write into the tensors of the cache they are given, so a captured
decode step (``serve/server.py``) reads what the last call wrote.

batch: ``{"tokens": (B, L)}``. ``audio`` (whisper, ``models/encdec.py``)
waits for a later slice and raises ``ValueError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models import hybrid, ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import next_token_loss

_LATER = {
    "audio": "the audio slice (models/encdec.py, whisper)",
}


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    init: Callable
    loss: Callable
    per_example_loss: Callable
    forward: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable


def _masked_next_token_loss(logits, tokens, cfg):
    return next_token_loss(tfm._mask_pad_vocab(logits, cfg), tokens)


def build_model(cfg: ArchConfig, *, attn_mode: str = "cuda") -> ModelBundle:
    fam = cfg.family
    if fam in _LATER:
        raise ValueError(
            f"{cfg.name} (family {fam!r}) is not in the port yet: it waits for "
            f"{_LATER[fam]}; the port has the dense, moe, vlm, ssm and hybrid families")

    if fam in ("dense", "moe", "vlm"):
        def init(gen):
            return tfm.init_transformer(gen, cfg)

        def forward(params, batch):
            logits, aux, _ = tfm.forward(params, batch["tokens"], cfg, attn_mode=attn_mode)
            return logits, aux

        def loss(params, batch):
            logits, aux = forward(params, batch)
            return _masked_next_token_loss(logits, batch["tokens"], cfg).mean() + 0.01 * aux

        def init_cache(batch, max_len, *, device="cuda"):
            return tfm.init_cache(cfg, batch, max_len, device=device)

        def prefill(params, batch, cache):
            return tfm.prefill(params, batch["tokens"], cfg, cache, attn_mode=attn_mode)

        def decode_step(params, cache, tokens):
            return tfm.decode_step(params, cache, tokens, cfg)

    elif fam == "ssm":
        def init(gen):
            return ssm.init_ssm_model(gen, cfg)

        def forward(params, batch):
            logits, aux, _ = ssm.ssm_forward(params, batch["tokens"], cfg)
            return logits, aux

        def loss(params, batch):
            logits, _ = forward(params, batch)
            return _masked_next_token_loss(logits, batch["tokens"], cfg).mean()

        def init_cache(batch, max_len, *, device="cuda"):
            return ssm.ssm_init_cache(cfg, batch, max_len, device=device)

        def prefill(params, batch, cache):
            return ssm.ssm_prefill(params, batch["tokens"], cfg, cache)

        def decode_step(params, cache, tokens):
            return ssm.ssm_decode_step(params, cache, tokens, cfg)

    elif fam == "hybrid":
        def init(gen):
            return hybrid.init_hybrid(gen, cfg)

        def forward(params, batch):
            logits, aux, _ = hybrid.hybrid_forward(params, batch["tokens"], cfg,
                                                   attn_mode=attn_mode)
            return logits, aux

        def loss(params, batch):
            logits, _ = forward(params, batch)
            return _masked_next_token_loss(logits, batch["tokens"], cfg).mean()

        def init_cache(batch, max_len, *, device="cuda"):
            return hybrid.hybrid_init_cache(cfg, batch, max_len, device=device)

        def prefill(params, batch, cache):
            return hybrid.hybrid_prefill(params, batch["tokens"], cfg, cache,
                                         attn_mode=attn_mode)

        def decode_step(params, cache, tokens):
            return hybrid.hybrid_decode_step(params, cache, tokens, cfg)

    else:
        raise ValueError(f"unknown family {fam!r}")

    def per_example_loss(params, batch):
        logits, _ = forward(params, batch)
        return _masked_next_token_loss(logits, batch["tokens"], cfg)

    return ModelBundle(cfg=cfg, init=init, loss=loss, per_example_loss=per_example_loss,
                       forward=forward, init_cache=init_cache, prefill=prefill,
                       decode_step=decode_step)


def count_params(cfg: ArchConfig) -> int:
    """Analytic parameter count (no allocation)."""
    d, v = cfg.d_model, cfg.vocab_padded
    hd = cfg.head_dim
    total = v * d  # embed
    if not cfg.tie_embeddings:
        total += d * v  # head
    n_mats = 3 if cfg.act == "silu" else 2
    if cfg.family in ("dense", "moe", "vlm"):
        attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d
        if cfg.n_experts > 0:
            ffn = d * cfg.n_experts + cfg.n_experts * n_mats * d * cfg.d_ff
        else:
            ffn = n_mats * d * cfg.d_ff
        total += cfg.n_layers * (attn + ffn)
    elif cfg.family == "ssm":
        total += cfg.n_layers * _mamba_layer_params(cfg)
    elif cfg.family == "hybrid":
        total += cfg.n_layers * _mamba_layer_params(cfg)
        attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d
        total += attn + n_mats * d * cfg.d_ff  # one shared block
    elif cfg.family == "audio":
        d_enc = cfg.encoder_d_model or d
        attn_e = 4 * d_enc * cfg.n_heads * hd
        enc = cfg.encoder_layers * (attn_e + 2 * d_enc * cfg.d_ff)
        attn_d = 4 * d * cfg.n_heads * hd
        dec = cfg.n_layers * (2 * attn_d + 2 * d * cfg.d_ff)
        total += enc + dec
    return total


def _mamba_layer_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads
    return d * d_in_proj + cfg.ssm_conv * conv_dim + cfg.d_inner * d
