"""Kernel 9's numerics on the CPU, route by route (``route`` in
``kernels/ssd_scan.py``; the kernels in ``csrc/ssd_scan.cu``).

- bf16 (``ssd_state_wgmma`` + ``ssd_out_wgmma``): x, B and C multiply
  exactly as bf16; each of the three fp32 operands (the weighted input w_q
  x_q, the carried state S_in, the scaled scores) is split into a bf16
  pair, hi = bf16(v) and lo = bf16(v - hi), before its product with an
  exact bf16 operand (so there is no lo·lo term). ``_kernel_like`` repeats
  that arithmetic in plain torch: cum in the kernels' scan order
  (``_scan_like``: 32 runs of ceil(Q/32) tokens, a Hillis–Steele scan of
  the run totals); the state walk, chunk by chunk, publishing S_in as its
  hi/lo pair, then S ← exp(cum_Q)·S and, 64 tokens at a time, S += (w
  x)_hiᵀ·B + (w x)_loᵀ·B; per 64 query rows the carried term C·hiᵀ +
  C·loᵀ times exp(cum_q), then the causal 64-key tiles at or below the
  rows, the raw scores C·Bᵀ formed once for the heads of a B/C group and
  scaled per head by exp(cum_q - cum_k)·dt_k on live pairs, zeroed on dead
  ones, split; y rounded to bf16.
- fp32 (``ssd_state_tf32`` + ``ssd_out_tf32``): 3xTF32, each fp32 operand
  split into hi = v with its 13 low mantissa bits cleared (a tf32 value)
  and lo = v - hi (exact), which the tensor core reads as tf32 by ignoring
  the same bits; each product summed as lo·hi + hi·lo + hi·hi.
  ``_tf32_like`` repeats it: the walk in 32-token tiles, the outputs in 64
  query rows and 32-key tiles.
- Tolerances, those of the kernel's GPU tests and of chip_smoke.py: bf16 y
  within 2e-3 abs + (2e-3 + 2^-7) rel (both sides round y to bf16 from fp32
  sums taken in other orders: one bf16 step is at most 2^-7 of the value),
  fp32 y and every final state within 2e-3 abs + 2e-3 rel. The bf16 split
  leaves about 2^-17 of each term and 3xTF32 about 2^-20; a single bf16
  rounding (2^-9) or a single TF32 truncation (2^-10) breaks the absolute
  bound where |y| is small, which the last two tests record.
- The Pallas kernel runs in interpret mode, as tests/test_torch_lm.py runs
  it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels.ssd_scan import (LAUNCHES_PER_CALL, ROUTE_KERNELS, ROUTES,
                                          heads_per_block, route, smem_bytes, ssd_chunked,
                                          ssd_scan, walk_cols)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the test workers share the host's
    cores, and torch's default thread count in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROWS = 64       # query rows per output tile, keys per key tile, tokens per walk tile (bf16)
TF_TOK = 32     # tokens per walk tile (fp32)
TF_KEYS = 32    # keys per key tile (fp32)


def _scan_like(da: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums over the last axis in the kernels' order: lane
    l of one warp adds its run of r = ceil(Q/32) tokens, a Hillis–Steele
    scan gives the 32 run totals' inclusive sums, each run's prefix sums
    start from the sum of the runs before it (fp32 adds throughout)."""
    q = da.shape[-1]
    r = -(-q // 32)
    runs = torch.nn.functional.pad(da, (0, 32 * r - q)).reshape(*da.shape[:-1], 32, r)
    tot = torch.zeros(runs.shape[:-1])
    for i in range(r):
        tot = tot + runs[..., i]
    inc = tot
    s = 1
    while s < 32:
        shifted = torch.nn.functional.pad(inc[..., :-s], (s, 0))
        inc = torch.where(torch.arange(32) >= s, inc + shifted, inc)
        s *= 2
    run = torch.nn.functional.pad(inc[..., :-1], (1, 0))
    out = torch.empty_like(runs)
    for i in range(r):
        run = run + runs[..., i]
        out[..., i] = run
    return out.reshape(*da.shape[:-1], 32 * r)[..., :q]


def _pair(v: torch.Tensor, split: bool):
    """(hi, lo) of fp32 v as bf16 values held in fp32; lo is 0 without
    the split (a single rounding)."""
    hi = v.to(torch.bfloat16).float()
    lo = (v - hi).to(torch.bfloat16).float() if split else torch.zeros_like(v)
    return hi, lo


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """fp32 v as the tensor core reads a tf32 operand: its 13 low mantissa
    bits ignored (truncated toward zero)."""
    return (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm3(a: torch.Tensor, b: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """a @ b in 3xTF32 as the kernels form it: hi = the truncated value, lo
    = v - hi exactly (which the tensor core reads truncated), lo·hi + hi·lo
    + hi·hi with fp32 sums; ``terms=1`` is a single TF32 product."""
    ahi, bhi = _tf32(a), _tf32(b)
    if terms == 1:
        return ahi @ bhi
    alo, blo = _tf32(a - ahi), _tf32(b - bhi)
    return alo @ bhi + ahi @ blo + ahi @ bhi


def _operands(x, dt, a, bm, cm, chunk):
    b, l, h, p = x.shape
    g = bm.shape[2]
    q = min(chunk, l)
    xf = x.float().permute(0, 2, 1, 3)                           # (b, h, l, p)
    bg = bm.float().permute(0, 2, 1, 3)                          # (b, g, l, n)
    cg = cm.float().permute(0, 2, 1, 3)
    rep = h // g
    bf, cf = (t.repeat_interleave(rep, dim=1) for t in (bg, cg))  # (b, h, l, n)
    dtf = dt.float().permute(0, 2, 1)                            # (b, h, l)
    av = a.float().expand(b, h)[..., None]
    return xf, bg, cg, bf, cf, dtf, av, q, l // q, rep


def _kernel_like(x, dt, a, bm, cm, chunk, s0=None, split=True):
    """The bf16 wgmma kernels' arithmetic, in plain torch."""
    b, l, h, p = x.shape
    n = bm.shape[3]
    xf, bg, cg, bf, cf, dtf, av, q, c, rep = _operands(x, dt, a, bm, cm, chunk)
    s = torch.zeros((b, h, p, n)) if s0 is None else s0.float().clone()
    y = torch.empty((b, h, l, p))
    for ci in range(c):
        tok = slice(ci * q, (ci + 1) * q)
        xc, bc, cc, dtc = xf[:, :, tok], bf[:, :, tok], cf[:, :, tok], dtf[:, :, tok]
        cum = _scan_like(dtc * av)                               # (b, h, q)
        # the walk publishes S_in(ci) as a hi/lo pair
        shi, slo = _pair(s, split)
        # the outputs: per 64 query rows, the carried term, then the key
        # tiles; the raw scores C·Bᵀ once per B/C group, shared by its heads
        raw = (cg[:, :, tok] @ bg[:, :, tok].transpose(-1, -2)).repeat_interleave(rep, dim=1)
        for q0 in range(0, q, ROWS):
            rows = torch.arange(q0, min(q0 + ROWS, q))
            cr, cq = cc[:, :, rows], cum[:, :, rows]
            acc = (cr @ shi.transpose(-1, -2) + cr @ slo.transpose(-1, -2)) \
                * torch.exp(cq)[..., None]
            for k0 in range(0, q0 + 1, ROWS):                    # key tiles 0..qt
                keys = torch.arange(k0, min(k0 + ROWS, q))
                sc = raw[:, :, rows][..., keys]                  # (b, h, rows, keys)
                f = torch.exp(cq[..., :, None] - cum[:, :, keys][..., None, :]) \
                    * dtc[:, :, keys][..., None, :]
                v = torch.where(keys[None, :] <= rows[:, None], sc * f, 0.0)
                vhi, vlo = _pair(v, split)
                acc = acc + vhi @ xc[:, :, keys] + vlo @ xc[:, :, keys]
            y[:, :, ci * q + rows] = acc
        # the walk: S ← exp(cum_Q)·S, then (w x)ᵀ·B split, 64 tokens at a time
        w = torch.exp(cum[..., -1:] - cum) * dtc
        whi, wlo = _pair(xc * w[..., None], split)
        s = s * torch.exp(cum[..., -1])[..., None, None]
        for t0 in range(0, q, ROWS):
            t = slice(t0, min(t0 + ROWS, q))
            s = s + whi[:, :, t].transpose(-1, -2) @ bc[:, :, t] \
                + wlo[:, :, t].transpose(-1, -2) @ bc[:, :, t]
    return y.permute(0, 2, 1, 3).to(x.dtype), s


def _tf32_like(x, dt, a, bm, cm, chunk, s0=None, terms=3):
    """The fp32 3xTF32 kernels' arithmetic, in plain torch (``terms=1``: a
    single TF32 rounding of each operand)."""
    b, l, h, p = x.shape
    n = bm.shape[3]
    xf, _, _, bf, cf, dtf, av, q, c, _ = _operands(x, dt, a, bm, cm, chunk)
    s = torch.zeros((b, h, p, n)) if s0 is None else s0.float().clone()
    y = torch.empty((b, h, l, p))
    for ci in range(c):
        tok = slice(ci * q, (ci + 1) * q)
        xc, bc, cc, dtc = xf[:, :, tok], bf[:, :, tok], cf[:, :, tok], dtf[:, :, tok]
        cum = _scan_like(dtc * av)
        for q0 in range(0, q, ROWS):                              # 64 query rows a block
            rows = torch.arange(q0, min(q0 + ROWS, q))
            cr, cq = cc[:, :, rows], cum[:, :, rows]
            acc = _mm3(cr, s.transpose(-1, -2), terms) * torch.exp(cq)[..., None]
            for k0 in range(0, rows[-1] + 1, TF_KEYS):           # 32-key tiles
                keys = torch.arange(k0, min(k0 + TF_KEYS, q))
                sc = _mm3(cr, bc[:, :, keys].transpose(-1, -2), terms)
                f = torch.exp(cq[..., :, None] - cum[:, :, keys][..., None, :]) \
                    * dtc[:, :, keys][..., None, :]
                v = torch.where(keys[None, :] <= rows[:, None], sc * f, 0.0)
                acc = acc + _mm3(v, xc[:, :, keys], terms)
            y[:, :, ci * q + rows] = acc
        w = torch.exp(cum[..., -1:] - cum) * dtc
        wx = xc * w[..., None]
        s = s * torch.exp(cum[..., -1])[..., None, None]
        for t0 in range(0, q, TF_TOK):
            t = slice(t0, min(t0 + TF_TOK, q))
            s = s + _mm3(wx[:, :, t].transpose(-1, -2), bc[:, :, t], terms)
    return y.permute(0, 2, 1, 3).to(x.dtype), s


def _inputs(b, l, h, g, p, n, seed=0, state=False, per_request=False):
    rng = np.random.default_rng(seed + l + h + p + n)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, l, h)))) * 0.1).astype(np.float32)
    a = -np.exp(rng.uniform(size=(b, h) if per_request else (h,))).astype(np.float32)
    bm, cm = (rng.standard_normal((b, l, g, n)).astype(np.float32) for _ in range(2))
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32) if state else None
    return x, dt, a, bm, cm, s0


def _torch(x, dt, a, bm, cm, s0, dtype=torch.bfloat16):
    tx, tb, tc = (torch.from_numpy(v).to(dtype) for v in (x, bm, cm))
    return (tx, torch.from_numpy(dt), torch.from_numpy(a), tb, tc,
            None if s0 is None else torch.from_numpy(s0))


def _violations(got, want) -> tuple[int, int]:
    """Entries of (y, state) outside the bound (y's rtol takes one bf16
    step more when y is bf16)."""
    (y, s), (yr, sr) = got, want
    rtol = 2e-3 + (2.0 ** -7 if y.dtype == torch.bfloat16 else 0.0)
    y, yr = y.float(), yr.float()
    bad_y = (y - yr).abs() > 2e-3 + rtol * yr.abs()
    bad_s = (s - sr).abs() > 2e-3 + 2e-3 * sr.abs()
    return int(bad_y.sum()), int(bad_s.sum())


# (B, L, H, G, P, N, chunk, initial state): groups < heads, an initial
# state, a ragged Q (L = 80 under chunk 128), P = 64 with N = 128
PALLAS_CASES = [(1, 128, 4, 2, 32, 16, 64, False), (2, 128, 2, 1, 32, 64, 64, True),
                (1, 80, 2, 1, 32, 32, 128, False), (1, 256, 2, 1, 64, 128, 128, False)]


def _pallas(x, dt, a, bm, cm, s0, chunk, dtype):
    js0 = None if s0 is None else jnp.asarray(s0)

    @jax.jit
    def pallas(x, dt, a, bm, cm, s0):
        return jops.ssd_scan(x, dt, a, bm, cm, chunk=chunk, initial_state=s0)

    yj, sj = pallas(jnp.asarray(x, dtype), jnp.asarray(dt), jnp.asarray(a),
                    jnp.asarray(bm, dtype), jnp.asarray(cm, dtype), js0)
    return torch.from_numpy(np.array(yj, np.float32)), torch.from_numpy(np.array(sj))


@pytest.mark.parametrize("b,l,h,g,p,n,chunk,state", PALLAS_CASES)
def test_kernel_arithmetic_matches_the_pallas_kernel(b, l, h, g, p, n, chunk, state):
    x, dt, a, bm, cm, s0 = _inputs(b, l, h, g, p, n, state=state)
    tx, tdt, ta, tb, tc, ts0 = _torch(x, dt, a, bm, cm, s0)
    want = _pallas(x, dt, a, bm, cm, s0, chunk, jnp.bfloat16)
    like = _kernel_like(tx, tdt, ta, tb, tc, chunk, ts0)
    assert like[0].dtype == torch.bfloat16 and like[0].shape == tx.shape
    assert _violations(like, want) == (0, 0)
    # the CPU wrapper (the plain version) at the same bound
    assert _violations(ssd_scan(tx, tdt, ta, tb, tc, chunk=chunk, initial_state=ts0),
                       want) == (0, 0)


@pytest.mark.parametrize("b,l,h,g,p,n,chunk,state", PALLAS_CASES)
def test_tf32_arithmetic_matches_the_pallas_kernel(b, l, h, g, p, n, chunk, state):
    x, dt, a, bm, cm, s0 = _inputs(b, l, h, g, p, n, state=state)
    ops = _torch(x, dt, a, bm, cm, s0, torch.float32)
    want = _pallas(x, dt, a, bm, cm, s0, chunk, jnp.float32)
    like = _tf32_like(*ops[:5], chunk, ops[5])
    assert like[0].dtype == torch.float32 and like[0].shape == ops[0].shape
    assert _violations(like, want) == (0, 0)


# the kernels' edges: Q = 5 (under one 16-row step, two chunks), Q = 16
# with G = H, Q = 80 over two chunks (a ragged second query tile), Q = 192
# (three query and key tiles: a key tile further back than the previous
# one), mamba2-370m's P = 64 and N = 128 with an initial state, and a
# long carry (16 chunks of 64); per-request A in four of them
TILING_CASES = [(1, 10, 4, 2, 32, 16, 5, False, False), (2, 64, 4, 4, 32, 64, 16, True, True),
                (2, 160, 4, 2, 32, 64, 80, False, True), (1, 192, 2, 1, 64, 128, 192, True, False),
                (1, 256, 2, 1, 64, 128, 128, True, True), (1, 1024, 2, 1, 16, 32, 64, True, True)]


@pytest.mark.parametrize("b,l,h,g,p,n,chunk,state,per_request", TILING_CASES)
def test_kernel_arithmetic_matches_the_plain_version(b, l, h, g, p, n, chunk, state,
                                                     per_request):
    ops = _torch(*_inputs(b, l, h, g, p, n, seed=1, state=state, per_request=per_request))
    like = _kernel_like(*ops[:5], chunk, ops[5])
    want = ssd_chunked(*ops[:5], min(chunk, l), ops[5])
    assert like[0].shape == ops[0].shape and like[1].shape == (b, h, p, n)
    assert _violations(like, want) == (0, 0)


@pytest.mark.parametrize("b,l,h,g,p,n,chunk,state,per_request", TILING_CASES)
def test_tf32_arithmetic_matches_the_plain_version(b, l, h, g, p, n, chunk, state,
                                                   per_request):
    ops = _torch(*_inputs(b, l, h, g, p, n, seed=1, state=state, per_request=per_request),
                 torch.float32)
    like = _tf32_like(*ops[:5], chunk, ops[5])
    want = ssd_chunked(*ops[:5], min(chunk, l), ops[5])
    assert like[0].shape == ops[0].shape and like[1].shape == (b, h, p, n)
    assert _violations(like, want) == (0, 0)


@pytest.mark.parametrize("q", [1, 5, 31, 32, 33, 80, 128, 192, 256])
def test_scan_order_gives_the_prefix_sums(q):
    da = torch.from_numpy(-np.random.default_rng(q).uniform(0, 0.3, (3, q)).astype(np.float32))
    got = _scan_like(da)
    torch.testing.assert_close(got, torch.cumsum(da.double(), -1).float(), atol=0, rtol=1e-5)
    assert torch.equal(got[:, 0], da[:, 0])


@pytest.mark.parametrize("v", [1.0, -1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                               -(1.0 + 2.0 ** -11), 3.1415927, 1e-30])
def test_tf32_split_is_exact_in_two_parts(v):
    """The kernels' split: hi keeps 11 significant bits (truncated toward
    zero, within 2^-10 of v), lo = v - hi is exact, and lo read as tf32 is
    within 2^-10 of lo."""
    t = torch.tensor([v], dtype=torch.float32)
    hi = _tf32(t)
    lo = t - hi
    m = np.frexp(abs(float(hi[0])))[0] * 2 ** 11
    assert m == int(m)                       # at most 11 significant bits
    assert abs(float(hi[0])) <= abs(float(t[0]))
    assert abs(float(lo[0])) <= abs(float(t[0])) * 2.0 ** -10
    assert float(hi[0]) + float(lo[0]) == float(t[0])   # exact in fp32 and in float64
    assert abs(float(_tf32(lo)[0]) - float(lo[0])) <= abs(float(lo[0])) * 2.0 ** -10


# (dtype, P, N) -> the route: the configured shapes (mamba2-370m P 64 / N
# 128, zamba2-1.2b P 64 / N 64) on the tensor cores in both dtypes, and
# the shapes each tensor-core route does not take
ROUTE_CASES = [("bfloat16", 64, 128, "ssd_wgmma"), ("bfloat16", 64, 64, "ssd_wgmma"),
               ("bfloat16", 64, 256, "ssd_wgmma"), ("bfloat16", 32, 64, "ssd_cuda_core"),
               ("bfloat16", 128, 64, "ssd_cuda_core"), ("bfloat16", 64, 48, "ssd_cuda_core"),
               ("float32", 64, 128, "ssd_tf32"), ("float32", 64, 64, "ssd_tf32"),
               ("float32", 32, 16, "ssd_tf32"), ("float32", 128, 64, "ssd_tf32"),
               ("float32", 24, 40, "ssd_cuda_core"), ("float32", 64, 40, "ssd_cuda_core")]


@pytest.mark.parametrize("dtype,p,n,want", ROUTE_CASES)
def test_route_gives_one_pair_of_kernels_per_shape(dtype, p, n, want):
    got = route(getattr(torch, dtype), p, n)
    assert got == want == route(dtype, p, n)
    assert got in ROUTES and len(ROUTE_KERNELS[got]) == LAUNCHES_PER_CALL
    # each kernel belongs to one route only
    names = [k for r in ROUTES for k in ROUTE_KERNELS[r]]
    assert len(names) == len(set(names)) == 2 * len(ROUTES)


def test_heads_per_block_weighs_waves_against_heads_and_divides_the_group():
    """mamba2-370m's prefill (B = 4, H = 32) takes 4 heads a block (128
    blocks, one wave of the 132 SMs), zamba2-1.2b's (H = 64) and one
    request at L = 4,096 take 8 (128 blocks); a block never mixes two B/C
    groups, and a call that fits one wave at any hb takes the least."""
    assert heads_per_block(4, 512, 32, 1, 128) == 4
    assert heads_per_block(4, 512, 64, 1, 128) == 8
    assert heads_per_block(1, 4096, 32, 1, 128) == 8
    assert heads_per_block(1, 64, 6, 2, 64) == 1
    for b, l, h, g, q in [(1, 64, 6, 2, 64), (2, 512, 32, 4, 128), (1, 10, 4, 2, 5)]:
        hb = heads_per_block(b, l, h, g, q)
        assert (h // g) % hb == 0 and 1 <= hb <= 8


def test_walk_cols_takes_128_columns_only_with_a_block_for_most_sms():
    """mamba2-370m's prefill (B = 4, H = 32, N = 128) walks 128 columns a
    block (128 blocks); one request (32 heads) keeps 64 (64 blocks, not
    32); N = 64 (zamba2-1.2b) has one panel."""
    assert walk_cols(4, 32, 128) == 128
    assert walk_cols(1, 32, 128) == 64
    assert walk_cols(4, 64, 64) == 64
    assert walk_cols(8, 32, 192) == 64   # 192 % 128 != 0


def test_shared_memory_follows_the_route():
    """The wrapper refuses what the kernels cannot hold: a bf16 chunk of
    512 (8 key tiles of x in a head slot) but not 256; fp32 past a chunk of
    ~12,000 tokens (the walk's dt, cum and w)."""
    assert smem_bytes(128, 64, 128, torch.bfloat16) <= 232448
    assert smem_bytes(256, 64, 128, torch.bfloat16) <= 232448
    assert smem_bytes(512, 64, 128, torch.bfloat16) > 232448
    assert smem_bytes(4096, 64, 128, torch.float32) <= 232448
    assert smem_bytes(16384, 64, 128, torch.float32) > 232448


def test_a_single_bf16_rounding_breaks_the_bound_the_split_keeps():
    """At mamba2-370m's P and N with an initial state, rounding the three
    fp32 operands once to bf16 puts entries of y past the 2e-3 absolute
    bound (where |y| is small); the hi/lo split keeps every entry in it."""
    ops = _torch(*_inputs(1, 256, 2, 1, 64, 128, seed=1, state=True))
    want = ssd_chunked(*ops[:5], 128, ops[5])
    assert _violations(_kernel_like(*ops[:5], 128, ops[5]), want) == (0, 0)
    bad_y, _ = _violations(_kernel_like(*ops[:5], 128, ops[5], split=False), want)
    assert bad_y > 0


def test_a_single_tf32_rounding_breaks_the_bound_3xtf32_keeps():
    """The same in fp32: one TF32 product (operands truncated, 2^-10) puts
    entries of y past the bound; 3xTF32 keeps every entry and the state in
    it."""
    ops = _torch(*_inputs(1, 256, 2, 1, 64, 128, seed=1, state=True), torch.float32)
    want = ssd_chunked(*ops[:5], 128, ops[5])
    assert _violations(_tf32_like(*ops[:5], 128, ops[5]), want) == (0, 0)
    bad_y, _ = _violations(_tf32_like(*ops[:5], 128, ops[5], terms=1), want)
    assert bad_y > 0
