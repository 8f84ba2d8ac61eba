"""Kernel 8's numerics on the CPU: the bf16 tensor-core kernels round p to
bf16 before p·v (the products' A operand) and take the row sum from the
rounded p; its plain version ``flash_attention_ref`` rounds in the same
place, and fp32 inputs keep the exact fp32 softmax. Then the kv split
(``split_plan``, ``flash_attention_split_ref``) and the route rule.

- ``_kernel_like`` repeats the bf16 kernels' arithmetic in plain torch,
  block by block and tile by tile (``csrc/flash_attention.cu``): the G
  query heads of a kv head folded into blocks of ``rows_per_block`` rows
  (128 on the wgmma route, 64 on mma.sync), kv tiles of 128 keys at hd 64
  and 128 and 64 at hd 256 (wgmma) or 64 (mma.sync) over the range a
  block can see, exp2 of scores scaled by log2 e, the running max per
  tile with base 0 while a row has seen no live key, p rounded to bf16
  relative to that running max, alpha rescaling, l the sum of the rounded
  p, out = acc / max(l, 1e-30) in bf16.
- Tolerances. bf16: 2e-2 abs at unit-normal inputs (tests/test_kernels.py's
  bf16 bound): each side rounds its output to bf16 (a step of at most
  2^-7 at |o| < 2, 2^-6 below 4) and the rounding of p moves each weight
  by at most 2^-9 of itself, so the output by at most 2^-9 · max|v| ≈
  0.008 before that. fp32: 2e-5 (the same file's fp32 bound). Under a kv
  split, bf16 is also held to 2e-2 of the reference's largest |value|
  (``_split_tol``, chip_smoke's ``flash_tol``): a row over thousands of
  keys averages them to a few hundredths, and a split that drops one chunk
  fails that limit where it would pass a fixed 2e-2.
- The split's plain version against ``flash_attention_ref`` at 1e-6
  (fp32: the same sums, merged), against the Pallas kernel at 2e-5 where
  its blocks divide the lengths, and against JAX's blocked and
  materialized attention at ragged lengths at 2e-5.
- The Pallas kernel runs in interpret mode, as tests/test_kernels.py runs
  it; torch runs on one thread. About 15 s on the CPU.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import (HEAD_DIMS, MAX_SPLIT, NUM_SMS, ROUTES,
                                                 SPLIT_ALIGN, WGMMA_HEAD_DIMS,
                                                 flash_attention, flash_attention_ref,
                                                 flash_attention_split_ref, route,
                                                 rows_per_block, sm_count, split_chunks,
                                                 split_plan)
from repro_torch.models.attention import ref_attention

BF16_TOL, FP32_TOL = 2e-2, 2e-5


def _split_tol(want):
    """bf16 under a kv split: 2e-2 of the reference's largest |value|, at
    most ``BF16_TOL`` (one bf16 step at the largest output is 2^-8 of it
    at most, so a right split differs from the plain version by under
    half of this)."""
    return min(BF16_TOL, 2e-2 * float(want.float().abs().max()))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread, as the driver's workers share the
    host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kernel_like(q, k, v, *, causal=True, window=None):
    """The bf16 kernels' arithmetic, block by block, in plain torch."""
    b, lq, hq, hd = q.shape
    lkv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    wgmma = route(hd, q.dtype) == "flash_wgmma_kernel"
    bk = (64 if hd == 256 else 128) if wgmma else 64
    block = rows_per_block(hd, q.dtype)
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
            for f0 in range(0, rows, block):
                qb, pos = qrows[f0:f0 + block], pos_all[f0:f0 + block]
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


# (B, Lq, Lkv, Hq, Hkv, hd, causal): short queries over long keys
# (whisper's cross attention, a decode-length query, GQA 32/8), ragged
# lengths, causal and not, and shapes whose grid fills the card (a window
# does not enter the plan)
PLAN_CASES = [(4, 64, 1500, 8, 8, 64, False), (1, 1, 4096, 32, 8, 128, False),
              (1, 16, 4096, 32, 8, 128, False), (1, 512, 512, 16, 16, 128, True),
              (4, 512, 512, 4, 1, 256, True), (1, 77, 3001, 2, 1, 80, True),
              (1, 300, 2999, 4, 2, 32, False), (2, 13, 1500, 4, 1, 16, True),
              (4, 1500, 1500, 8, 8, 64, False), (1, 512, 4096, 1, 1, 128, False)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,lq,lkv,hq,hkv,hd,causal", PLAN_CASES)
def test_split_plan_is_a_function_of_the_shape_and_covers_the_keys_once(
        b, lq, lkv, hq, hkv, hd, causal, dtype):
    plan = split_plan(b, lq, lkv, hq, hkv, hd, dtype, causal=causal)
    assert plan == split_plan(b, lq, lkv, hq, hkv, hd, str(dtype), causal=causal,
                              num_sms=sm_count(torch.device("cpu")))
    n, chunk = plan
    blocks = -(-lq * (hq // hkv) // rows_per_block(hd, dtype)) * hkv * b
    if n == 1:
        assert chunk == lkv
    else:   # only a grid under half the card splits
        assert 2 * blocks <= NUM_SMS and 2 <= n <= MAX_SPLIT
        assert chunk % SPLIT_ALIGN == 0 and chunk >= 2 * SPLIT_ALIGN
    chunks = split_chunks(lkv, n, chunk)
    assert len(chunks) == n and chunks[0][0] == 0 and chunks[-1][1] == lkv
    assert all(lo < hi for lo, hi in chunks)                  # none empty
    assert all(a[1] == b_[0] for a, b_ in zip(chunks, chunks[1:]))   # no gap, no overlap
    covered = np.zeros(lkv, np.int64)
    for lo, hi in chunks:
        covered[lo:hi] += 1
    assert (covered == 1).all()
    if causal:   # a causal call's row tiles already spread its keys
        assert n == 1


def test_split_plan_splits_short_queries_and_not_full_grids():
    # whisper's cross attention: 32 blocks of 128 rows, 4 chunks of 384 keys
    assert split_plan(4, 64, 1500, 8, 8, 64, torch.bfloat16, causal=False) == (4, 384)
    # a decode-length query over a 4,096 cache: as many chunks as the card wants
    assert split_plan(1, 1, 4096, 32, 8, 128, torch.bfloat16, causal=False) == (16, 256)
    # causal with no offset: 64 queries see 64 keys, whatever Lkv; and a
    # short causal grid (olmoe's B = 1 prefill) keeps its keys whole
    assert split_plan(1, 64, 4096, 32, 8, 128, torch.bfloat16, causal=True) == (1, 4096)
    assert split_plan(1, 512, 512, 16, 16, 128, torch.bfloat16, causal=True) == (1, 512)
    # olmo-1b's and whisper's encoder prefill fill the card
    assert split_plan(4, 512, 512, 16, 16, 128, torch.bfloat16)[0] == 1
    assert split_plan(4, 1500, 1500, 8, 8, 64, torch.float32, causal=False)[0] == 1
    # the plan follows the card's SM count: off the card it is an H100
    # SXM's; a card of 16 SMs leaves whisper's 32 cross blocks whole
    assert sm_count(torch.device("cpu")) == NUM_SMS == 132
    assert split_plan(4, 64, 1500, 8, 8, 64, torch.bfloat16, causal=False,
                      num_sms=16) == (1, 1500)
    assert split_plan(1, 1, 4096, 32, 8, 128, torch.bfloat16, causal=False,
                      num_sms=16) == (2, 2048)


# (B, Lq, Lkv, Hq, Hkv, hd, causal, window, chunks): the plan's chunks and
# hand-made ones, with chunks that some rows (causal, window) or every row
# sees no key of
SPLIT_REF_CASES = [(2, 64, 700, 4, 2, 32, False, None, None),
                   (1, 16, 1500, 4, 1, 64, False, None, None),
                   (1, 300, 700, 4, 2, 32, True, 100, [(0, 256), (256, 512), (512, 700)]),
                   (1, 30, 1000, 4, 2, 16, False, 50, [(0, 384), (384, 1000)]),
                   (1, 200, 600, 2, 2, 80, True, None, [(0, 128), (128, 256), (256, 600)]),
                   (2, 1, 900, 8, 8, 128, False, None, None),
                   (1, 512, 4096, 1, 1, 128, False, 100, None)]


@pytest.mark.parametrize("b,lq,lkv,hq,hkv,hd,causal,window,chunks", SPLIT_REF_CASES)
def test_split_ref_equals_the_plain_version(b, lq, lkv, hq, hkv, hd, causal, window, chunks):
    q, k, v = (torch.from_numpy(a) for a in _qkv(b, lq, lkv, hq, hkv, hd, seed=3))
    if chunks is None:
        assert split_plan(b, lq, lkv, hq, hkv, hd, torch.float32, causal=causal)[0] > 1
    got = flash_attention_split_ref(q, k, v, causal=causal, window=window, chunks=chunks)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    if window is not None and causal and lq > lkv + window:
        assert bool((got[:, lkv + window:] == 0).all())
    # bf16: p rounded per chunk (relative to the chunk's max), as the kernels
    # round per tile: within the split's bf16 limit of the plain version
    bq, bk, bv = _bf16(q.numpy(), k.numpy(), v.numpy())
    want = flash_attention_ref(bq, bk, bv, causal=causal, window=window).float()
    torch.testing.assert_close(
        flash_attention_split_ref(bq, bk, bv, causal=causal, window=window,
                                  chunks=chunks).float(),
        want, atol=_split_tol(want), rtol=0)


# (B, Lq, Lkv, Hq, Hkv, hd, window): chip_smoke's bf16 split rows, 1 and
# 16 queries over 4,096 keys under GQA 32/8 and 512 under a window of 100
DROP_CASES = [(1, 1, 4096, 32, 8, 128, None), (1, 16, 4096, 32, 8, 128, None),
              (1, 512, 4096, 1, 1, 128, 100)]


@pytest.mark.parametrize("drop", ["first", "middle", "last"])
@pytest.mark.parametrize("b,lq,lkv,hq,hkv,hd,window", DROP_CASES)
def test_split_limit_fails_a_split_that_drops_a_chunk(b, lq, lkv, hq, hkv, hd, window, drop):
    """The split's bf16 limit holds the plain split-and-merge of the
    plan and refuses one that leaves out a chunk (a combine that skips or
    mis-weighs a chunk's partial), whichever chunk it is."""
    bq, bk, bv = _bf16(*_qkv(b, lq, lkv, hq, hkv, hd, seed=6))
    chunks = split_chunks(lkv, *split_plan(b, lq, lkv, hq, hkv, hd, torch.bfloat16,
                                           causal=False))
    assert len(chunks) > 2
    want = flash_attention_ref(bq, bk, bv, causal=False, window=window).float()
    tol = _split_tol(want)
    whole = flash_attention_split_ref(bq, bk, bv, causal=False, window=window, chunks=chunks)
    assert float((whole.float() - want).abs().max()) <= tol
    i = {"first": 0, "middle": len(chunks) // 2, "last": len(chunks) - 1}[drop]
    short = flash_attention_split_ref(bq, bk, bv, causal=False, window=window,
                                      chunks=chunks[:i] + chunks[i + 1:])
    assert float((short.float() - want).abs().max()) > tol


# the Pallas kernel's blocks (min(128, L)) divide these lengths; the plan
# splits each
SPLIT_PALLAS_CASES = [(1, 64, 512, 2, 1, 64, False, None), (1, 128, 1024, 4, 2, 32, False, 256),
                      (2, 32, 768, 2, 2, 16, True, None)]


@pytest.mark.parametrize("b,lq,lkv,hq,hkv,hd,causal,window", SPLIT_PALLAS_CASES)
def test_split_ref_matches_the_pallas_kernel(b, lq, lkv, hq, hkv, hd, causal, window):
    q, k, v = _qkv(b, lq, lkv, hq, hkv, hd, seed=4)
    chunks = [(0, 256), (256, lkv)] if causal else None   # causal: Lq keys live
    if chunks is None:
        assert split_plan(b, lq, lkv, hq, hkv, hd, torch.float32, causal=causal)[0] > 1
    want = np.asarray(jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                           causal=causal, window=window), np.float32)
    got = flash_attention_split_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                                    window=window, chunks=chunks)
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_TOL)


# ragged lengths, as tests/test_torch_whisper.py holds the plain version:
# JAX's blocked and materialized attention
SPLIT_RAGGED_CASES = [(2, 64, 1500, 2, 2, 64, False), (1, 13, 1500, 4, 1, 128, False),
                      (1, 77, 1001, 2, 1, 80, True)]


@pytest.mark.parametrize("b,lq,lkv,hq,hkv,hd,causal", SPLIT_RAGGED_CASES)
def test_split_ref_at_ragged_lengths_matches_jax(b, lq, lkv, hq, hkv, hd, causal):
    q, k, v = _qkv(b, lq, lkv, hq, hkv, hd, seed=5)
    plan = split_plan(b, lq, lkv, hq, hkv, hd, torch.float32, causal=causal)
    chunks = split_chunks(lkv, *plan) if plan[0] > 1 else [(0, 256), (256, 512), (512, lkv)]
    got = flash_attention_split_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                                    chunks=chunks).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    np.testing.assert_allclose(got, np.asarray(jattn.blocked_attention(jq, jk, jv,
                                                                       causal=causal)),
                               atol=FP32_TOL)
    np.testing.assert_allclose(got, np.asarray(jattn.ref_attention(jq, jk, jv, causal=causal)),
                               atol=FP32_TOL)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_route_rule_names_one_kernel_per_head_dim_and_dtype(hd):
    bf16, fp32 = route(hd, torch.bfloat16), route(hd, torch.float32)
    assert bf16 in ROUTES and fp32 in ROUTES
    assert bf16 == ("flash_wgmma_kernel" if hd in WGMMA_HEAD_DIMS else "flash_mma_kernel")
    assert fp32 == "flash_tf32_kernel"
    assert route(hd, "bfloat16") == bf16 and route(hd, "float32") == fp32
    assert rows_per_block(hd, torch.bfloat16) == (128 if hd in WGMMA_HEAD_DIMS else 64)
    with pytest.raises(ValueError, match="no kernel"):
        route(hd, torch.float16)


def test_route_rule_refuses_a_head_dim_it_was_not_built_for():
    for hd in (8, 48, 192, 512):
        with pytest.raises(ValueError, match="no kernel"):
            route(hd, torch.bfloat16)
