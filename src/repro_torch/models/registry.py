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

FedSPD's client axes. ``per_example_loss`` also takes the FL engine's
form, what the JAX package gets with ``jax.vmap``: params whose leaves
carry leading axes ``*B`` (``(N,)`` for the local steps, ``(S, N)`` for
the clustering forward) against tokens ``(*B', b, L)`` broadcast to
``*B``, returning ``(*B, b)``. Each model runs its own b sequences in a
loop over the flattened axes (``_on_client_axes``), so each client's MoE
routes its own b·L tokens with the capacity they give, as under
``vmap``. Tokens of rank 2 keep the one-model and per-request forms.

The training route. ``build_model(cfg, train=True)``, which only the
train launcher (``launch/train.py``) asks for, runs attention through
``ref_attention`` and the SSD through ``ssm.ssd_chunked``, both under
autograd: the JAX package trains outside its Pallas kernels (``"ref"``
at smoke size, its pure-JAX ``"blocked"`` at full width, its own
``ssd_chunked``), and kernels 8 and 9 have no backward. Every other
caller keeps kernels 8 and 9.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import hybrid, ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import next_token_loss
from repro_torch.utils.pytree import tree_map

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


def _split_models(params: dict, k: int, shape: tuple) -> list:
    """The ``prod(shape)`` models of a tree whose leaves lead with ``k``
    model axes, broadcast to ``shape``: views (``unbind``, whose backward
    stacks the models' gradients into one tensor per leaf)."""
    parts = tree_map(lambda leaf: leaf.expand(*shape, *leaf.shape[k:])
                     .reshape(-1, *leaf.shape[k:]).unbind(0), params)

    def pick(node, i):
        return {key: pick(v, i) for key, v in node.items()} if isinstance(node, dict) \
            else node[i]

    return [pick(parts, i) for i in range(math.prod(shape))]


def _on_client_axes(per_example_loss):
    """``per_example_loss`` on the FL client axes (see the module's
    docstring); tokens of rank 2 go straight through."""
    def on_axes(params, batch):
        tokens = batch["tokens"]
        if tokens.dim() <= 2:
            return per_example_loss(params, batch)
        k = params["embed"].dim() - 2
        shape = tuple(torch.broadcast_shapes(params["embed"].shape[:k], tokens.shape[:-2]))
        seqs = tokens.expand(*shape, *tokens.shape[-2:]).reshape(-1, *tokens.shape[-2:])
        out = [per_example_loss(p, {"tokens": seqs[i]})
               for i, p in enumerate(_split_models(params, k, shape))]
        return torch.stack(out).reshape(*shape, tokens.shape[-2])

    return on_axes


def build_model(cfg: ArchConfig, *, attn_mode: str = "cuda",
                train: bool = False) -> ModelBundle:
    """The family's bundle; ``train=True`` takes the training route (see
    the module's docstring: attention ``"ref"`` whatever ``attn_mode``
    says, the SSD ``"chunked"``)."""
    fam = cfg.family
    ssd = "chunked" if train else "cuda"
    if train:
        attn_mode = "ref"
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
            logits, aux, _ = ssm.ssm_forward(params, batch["tokens"], cfg, ssd=ssd)
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
                                                   attn_mode=attn_mode, ssd=ssd)
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

    @_on_client_axes
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
