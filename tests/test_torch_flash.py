"""Kernel 8's numerics on the CPU: the bf16 tensor-core kernel rounds p to
bf16 before p·v (the mma's A operand) and takes its row sum from the
rounded p; its plain version ``flash_attention_ref`` rounds in the same
place, and fp32 inputs keep the exact fp32 softmax.

- ``_kernel_like`` repeats the bf16 kernel's arithmetic in plain torch,
  block by block and tile by tile (``csrc/flash_attention.cu``): the G
  query heads of a kv head folded into 64-row blocks, kv tiles of 64 keys
  (32 at hd 256) over the range a block can see, exp2 of scores scaled by
  log2 e, the running max per tile with base 0 while a row has seen no
  live key, p rounded to bf16 relative to that running max, alpha
  rescaling, l the sum of the rounded p, out = acc / max(l, 1e-30) in
  bf16.
- Tolerances. bf16: 2e-2 abs at unit-normal inputs (tests/test_kernels.py's
  bf16 bound): each side rounds its output to bf16 (a step of at most
  2^-7 at |o| < 2, 2^-6 below 4) and the rounding of p moves each weight
  by at most 2^-9 of itself, so the output by at most 2^-9 · max|v| ≈
  0.008 before that. fp32: 2e-5 (the same file's fp32 bound).
- The Pallas kernel runs in interpret mode, as tests/test_kernels.py runs
  it. About 10 s on the CPU.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.models.attention import ref_attention

BF16_TOL, FP32_TOL = 2e-2, 2e-5


def _kernel_like(q, k, v, *, causal=True, window=None):
    """The bf16 kernel's arithmetic, block by block, in plain torch."""
    b, lq, hq, hd = q.shape
    lkv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    bk = 32 if hd == 256 else 64
    rows = lq * g
    scale_log2 = math.log2(math.e) / math.sqrt(hd)
    pad = (-lkv) % bk   # keys past Lkv read as zeros, as the kernel's zero-filled copies
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    out = torch.empty((b, lq, hq, hd))
    pos_all = torch.arange(rows) // g
    for bi in range(b):
        for hk in range(hkv):
            qrows = q[bi, :, hk * g:(hk + 1) * g].float().reshape(rows, hd)
            orows = torch.empty((rows, hd))
            for f0 in range(0, rows, 64):
                qb, pos = qrows[f0:f0 + 64], pos_all[f0:f0 + 64]
                n = len(pos)
                k_lo, k_hi = 0, lkv - 1
                if causal:
                    k_hi = min(k_hi, int(pos[-1]))
                if window is not None:
                    k_lo = max(k_lo, int(pos[0]) - window + 1)
                m = torch.full((n,), -math.inf)
                l, acc = torch.zeros(n), torch.zeros((n, hd))
                for t in range(k_lo // bk, k_hi // bk + 1 if k_lo <= k_hi else 0):
                    keys = torch.arange(t * bk, (t + 1) * bk)
                    s = (qb @ kf[bi, t * bk:(t + 1) * bk, hk].T) * scale_log2
                    live = (keys < lkv)[None, :].expand(n, bk)
                    if causal:
                        live = live & (pos[:, None] >= keys[None, :])
                    if window is not None:
                        live = live & (pos[:, None] - keys[None, :] < window)
                    s = torch.where(live, s, -math.inf)
                    mx = torch.maximum(m, s.amax(dim=1))
                    base = torch.where(mx == -math.inf, 0.0, mx)
                    alpha = torch.exp2(m - base)
                    p = torch.exp2(s - base[:, None]).to(torch.bfloat16).float()
                    l = l * alpha + p.sum(dim=1)
                    acc = acc * alpha[:, None] + p @ vf[bi, t * bk:(t + 1) * bk, hk]
                    m = mx
                orows[f0:f0 + n] = acc / l.clamp_min(1e-30)[:, None]
            out[bi, :, hk * g:(hk + 1) * g] = orows.reshape(lq, g, hd)
    return out.to(q.dtype)


def _qkv(b, lq, lkv, hq, hkv, hd, seed=0):
    rng = np.random.default_rng(seed + lq + lkv + hd)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in [(b, lq, hq, hd), (b, lkv, hkv, hd), (b, lkv, hkv, hd)])


def _bf16(*arrays):
    return tuple(torch.from_numpy(a).to(torch.bfloat16) for a in arrays)


# (B, Lq, Lkv, Hq, Hkv, hd, window): hd 64, 80 and 128 under GQA 4/1, the
# plain (no GQA) case and a window, all against the Pallas kernel
PALLAS_CASES = [(1, 128, 128, 4, 1, 64, None), (1, 128, 128, 4, 1, 80, None),
                (1, 128, 128, 4, 1, 128, None), (2, 128, 128, 4, 4, 64, 48),
                (1, 256, 128, 4, 1, 80, 96)]


@pytest.mark.parametrize("b,lq,lkv,hq,hkv,hd,window", PALLAS_CASES)
def test_bf16_rounding_stays_within_the_bound_of_the_pallas_kernel(b, lq, lkv, hq, hkv, hd,
                                                                   window):
    """The plain version (the CPU wrapper) and the kernel's arithmetic,
    both with p rounded to bf16, against the Pallas kernel's fp32 p."""
    q, k, v = _qkv(b, lq, lkv, hq, hkv, hd)
    want = np.asarray(jops.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                           causal=True, window=window), np.float32)
    tq, tk, tv = _bf16(q, k, v)
    got = flash_attention(tq, tk, tv, causal=True, window=window)   # CPU: the plain version
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL)
    like = _kernel_like(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(like.float().numpy(), want, atol=BF16_TOL)


# the kernel's edges: GQA 1, 2, 4, 8; windows shorter than one kv tile
# (16 < 64, 20 < 32 at hd 256); L = 48 and 96; Lq != Lkv both ways; rows
# with no live key (Lq > Lkv + window), folded with GQA
TILING_CASES = [(1, 128, 128, 2, 2, 32, None), (2, 128, 128, 4, 2, 64, None),
                (1, 256, 256, 8, 1, 64, None), (1, 256, 256, 16, 2, 16, 16),
                (1, 128, 128, 4, 1, 256, 20), (2, 48, 48, 4, 1, 64, None),
                (1, 96, 96, 8, 1, 96, 40), (1, 96, 256, 8, 1, 16, None),
                (1, 256, 96, 2, 1, 80, None), (1, 256, 48, 8, 1, 128, 16),
                (1, 96, 48, 4, 2, 32, 8)]


@pytest.mark.parametrize("b,lq,lkv,hq,hkv,hd,window", TILING_CASES)
def test_kernel_arithmetic_matches_the_plain_version(b, lq, lkv, hq, hkv, hd, window):
    tq, tk, tv = _bf16(*_qkv(b, lq, lkv, hq, hkv, hd, seed=1))
    like = _kernel_like(tq, tk, tv, causal=True, window=window)
    want = flash_attention_ref(tq, tk, tv, causal=True, window=window)
    assert like.dtype == torch.bfloat16 and like.shape == tq.shape
    torch.testing.assert_close(like.float(), want.float(), atol=BF16_TOL, rtol=0)
    if window is not None and lq > lkv + window:   # rows with no live key are exactly 0
        assert bool((like[:, lkv + window:] == 0).all())
        assert bool((want[:, lkv + window:] == 0).all())


def test_bf16_plain_version_rounds_p_and_fp32_does_not():
    q, k, v = _qkv(1, 128, 128, 4, 2, 64, seed=2)
    tq, tk, tv = _bf16(q, k, v)
    # by hand: fp32 softmax weights, rounded to bf16, normalised by their sum
    s = torch.einsum("lkgd,mkd->kglm", tq.float()[0].reshape(128, 2, 2, 64),
                     tk.float()[0]) / 8.0
    mask = torch.ones((128, 128), dtype=torch.bool).tril()
    p = torch.exp(s.masked_fill(~mask, -1e30) - s.masked_fill(~mask, -1e30).amax(-1, True))
    p = (p * mask).to(torch.bfloat16).float()
    o = torch.einsum("kglm,mkd->lkgd", p, tv.float()[0]) / p.sum(-1).permute(2, 0, 1)[..., None]
    got = flash_attention_ref(tq, tk, tv)
    torch.testing.assert_close(got[0].float(), o.reshape(128, 4, 64).to(torch.bfloat16).float(),
                               atol=2.0 ** -7, rtol=2.0 ** -7)
    # fp32 keeps the exact softmax: the materialized reference at the fp32 bound
    fq, fk, fv = (torch.from_numpy(a) for a in (q, k, v))
    torch.testing.assert_close(flash_attention_ref(fq, fk, fv), ref_attention(fq, fk, fv),
                               atol=FP32_TOL, rtol=0)
