"""Attention: the materialized reference, the flash kernel, and decode.

- ``ref_attention``: O(L²) materialized scores, the test oracle (mode
  ``"ref"``).
- ``attention(mode="cuda")``: kernel 8, ``kernels/flash_attention.py``
  (online softmax, fully masked kv tiles never read). ``"pallas"`` and
  ``"blocked"`` are other names for it: in the JAX package they are two
  routes to the same flash function.
- ``decode_attention``: one query token against a KV cache, plain PyTorch
  (the JAX package runs it outside Pallas too), through the stable
  softmax partials (m, l, o). The token's position is a 0-dim device
  tensor (or a Python int) and is never read on the host, so the step can
  be captured into a CUDA graph. With ``axis_name`` the cache is split
  along its length over that dim of the current mesh (each rank holds
  the rows at ``coordinate × local length`` on), and the partials combine
  by all-reduces over the dim's ranks (flash decoding).

All take GQA-layout tensors: q ``(B, Lq, Hq, hd)``, k/v ``(B, Lkv, Hkv,
hd)`` with Hq = G·Hkv. Windows are static Python ints here: the port runs
its layer stack as a Python loop, so a per-layer window (gemma3's
local:global) reaches the kernel as that layer's own static window.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import flash_attention

NEG_INF = -1e30
FLASH_MODES = ("cuda", "pallas", "blocked")


def _split_gqa(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, L, Hq, hd) -> (B, L, Hkv, G, hd)."""
    b, l, hq, hd = q.shape
    return q.reshape(b, l, n_kv, hq // n_kv, hd)


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  q_offset: int = 0) -> torch.Tensor:
    """Materialized attention in fp32, out in q's dtype (softmax over the
    masked scores, as the JAX package's oracle)."""
    b, lq, hq, hd = q.shape
    n_kv = k.shape[2]
    qg = _split_gqa(q, n_kv).float()
    scores = torch.einsum("blkgd,bmkd->bkglm", qg, k.float()) / math.sqrt(hd)
    pos_q = torch.arange(lq, device=q.device)[:, None] + q_offset
    pos_k = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones((lq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos_q >= pos_k
    if window is not None:
        mask &= pos_q - pos_k < window
    probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    out = torch.einsum("bkglm,bmkd->blkgd", probs, v.float())
    return out.reshape(b, lq, hq, hd).to(q.dtype)


def attention(q, k, v, *, mode: str = "cuda", causal: bool = True,
              window: int | None = None) -> torch.Tensor:
    if mode == "ref":
        return ref_attention(q, k, v, causal=causal, window=window)
    if mode in FLASH_MODES:
        return flash_attention(q, k, v, causal=causal, window=window)
    raise ValueError(f"unknown attention mode {mode!r}; have ('ref',) + {FLASH_MODES}")


# --------------------------------------------------------------------------
# Decode (single new token against a KV cache)
# --------------------------------------------------------------------------


def _axis(axis_name):
    """The process group and this rank's index along ``axis_name``, a dim
    of the current mesh (``launch/mesh.use_mesh``)."""
    from repro_torch.launch.mesh import current_mesh

    mesh = current_mesh()
    return mesh.get_group(axis_name), mesh.get_local_rank(axis_name)


def decode_attention_parts(q, k_cache, v_cache, positions, cur_pos,
                           window: int | None = None):
    """Stable-softmax partials (m, l, o) over this cache (shard): q ``(B, 1,
    Hq, hd)``, caches ``(B, Lc, Hkv, hd)``, positions ``(Lc,)`` the cache
    rows' positions, cur_pos the new token's position (a 0-dim tensor on
    the caches' device, or an int).

    Shards combine with: M = max m; l' = Σ l·e^{m−M}; o' = Σ o·e^{m−M}."""
    hd = q.shape[-1]
    n_kv = k_cache.shape[2]
    qg = _split_gqa(q, n_kv)[:, 0].float()                 # (B, Hkv, G, hd)
    s = torch.einsum("bkgd,bmkd->bkgm", qg, k_cache.float()) / math.sqrt(hd)
    valid = positions <= cur_pos
    if window is not None:
        valid &= cur_pos - positions < window
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)                                     # (B, Hkv, G)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bkgm,bmkd->bkgd", p, v_cache.float())
    return m, l, o


def combine_decode_parts(m, l, o, axis_name=None) -> torch.Tensor:
    """Finish decode attention from (m, l, o); with ``axis_name`` (a dim
    of the current mesh) the shards' partials first combine over its
    ranks: M = max m (all-reduce MAX), then the sums of l·e^{m−M} and
    o·e^{m−M}."""
    if axis_name is not None:
        import torch.distributed as dist

        group, _ = _axis(axis_name)
        big = m.clone()
        dist.all_reduce(big, op=dist.ReduceOp.MAX, group=group)
        alpha = torch.exp(m - big)
        l = l * alpha
        o = o * alpha[..., None]
        dist.all_reduce(l, group=group)
        dist.all_reduce(o, group=group)
    out = o / l.clamp_min(1e-30)[..., None]
    b, n_kv, g, hd = out.shape
    return out.reshape(b, 1, n_kv * g, hd)


def decode_attention(q, k_cache, v_cache, cur_pos, *, window: int | None = None,
                     axis_name=None) -> torch.Tensor:
    lc = k_cache.shape[1]
    positions = torch.arange(lc, device=k_cache.device)
    if axis_name is not None:
        positions = positions + _axis(axis_name)[1] * lc
    m, l, o = decode_attention_parts(q, k_cache, v_cache, positions, cur_pos,
                                     window=window)
    return combine_decode_parts(m, l, o, axis_name=axis_name).to(q.dtype)
