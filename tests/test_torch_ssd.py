"""Kernel 9's bf16 numerics on the CPU: the tensor-core kernels
(``ssd_chunk_state_mma``, ``ssd_chunk_out_mma`` in ``csrc/ssd_scan.cu``)
multiply x, B and C exactly as bf16 and split each of the three fp32
operands (the scaled scores, the carried state S_in, the weighted input
w_q x_q) into a bf16 pair, hi = bf16(v) and lo = bf16(v - hi), before its
product with an exact bf16 operand (so there is no lo·lo term).

- ``_kernel_like`` repeats that arithmetic in plain torch, stage by stage
  and tile by tile: cum in the kernels' scan order (``_scan_like``: 32
  runs of ceil(Q/32) tokens, a Hillis–Steele scan of the run totals); the
  chunk state (w x)ᵀ·B with w x split; the state pass; per 64 query rows
  the carried state's term with S_in split, times exp(cum_q), then the
  causal 64-key tiles at or below the rows, each score scaled by
  exp(cum_q - cum_k)·dt_k on live pairs, zeroed on dead ones and split; y
  rounded to bf16.
- Tolerances, the bf16 bound of the kernel's GPU tests and of
  chip_smoke.py: y within 2e-3 abs + (2e-3 + 2^-7) rel (both sides round
  y to bf16 from fp32 sums taken in other orders: one bf16 step is at
  most 2^-7 of the value), the fp32 final state within 2e-3 abs + 2e-3
  rel. The split leaves about 2^-17 of each term; a single rounding
  (``split=False``) leaves 2^-9 and breaks the absolute bound where |y|
  is small, which the last test records.
- The Pallas kernel runs in interpret mode, as tests/test_torch_lm.py runs
  it. About 20 s on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the test workers share the host's
    cores, and torch's default thread count in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROWS = 64   # query rows per output block, keys per key tile


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


def _kernel_like(x, dt, a, bm, cm, chunk, s0=None, split=True):
    """The bf16 tensor-core kernels' arithmetic, in plain torch."""
    b, l, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    q = min(chunk, l)
    c = l // q
    rep = h // g
    xf = x.float().permute(0, 2, 1, 3)                           # (b, h, l, p)
    bf = bm.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    cf = cm.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    dtf = dt.float().permute(0, 2, 1)                            # (b, h, l)
    av = a.float().expand(b, h)[..., None]
    s = torch.zeros((b, h, p, n)) if s0 is None else s0.float().clone()
    y = torch.empty((b, h, l, p))
    for ci in range(c):
        tok = slice(ci * q, (ci + 1) * q)
        xc, bc, cc, dtc = xf[:, :, tok], bf[:, :, tok], cf[:, :, tok], dtf[:, :, tok]
        cum = _scan_like(dtc * av)                               # (b, h, q)
        # stage 1: S_c = (w x)ᵀ·B, w x split
        w = torch.exp(cum[..., -1:] - cum) * dtc
        whi, wlo = _pair(xc * w[..., None], split)
        s_c = whi.transpose(-1, -2) @ bc + wlo.transpose(-1, -2) @ bc
        # stage 3, per 64 query rows; S_in (the state entering the chunk) split
        shi, slo = _pair(s, split)
        for q0 in range(0, q, ROWS):
            rows = torch.arange(q0, min(q0 + ROWS, q))
            cr, cq = cc[:, :, rows], cum[:, :, rows]
            acc = (cr @ shi.transpose(-1, -2) + cr @ slo.transpose(-1, -2)) \
                * torch.exp(cq)[..., None]
            for k0 in range(0, q0 + 1, ROWS):                    # key tiles 0..qt
                keys = torch.arange(k0, min(k0 + ROWS, q))
                sc = cr @ bc[:, :, keys].transpose(-1, -2)       # (b, h, rows, keys)
                f = torch.exp(cq[..., :, None] - cum[:, :, keys][..., None, :]) \
                    * dtc[:, :, keys][..., None, :]
                v = torch.where(keys[None, :] <= rows[:, None], sc * f, 0.0)
                vhi, vlo = _pair(v, split)
                acc = acc + vhi @ xc[:, :, keys] + vlo @ xc[:, :, keys]
            y[:, :, ci * q + rows] = acc
        # stage 2: the state pass
        s = s * torch.exp(cum[..., -1])[..., None, None] + s_c
    return y.permute(0, 2, 1, 3).to(x.dtype), s


def _inputs(b, l, h, g, p, n, seed=0, state=False, per_request=False):
    rng = np.random.default_rng(seed + l + h + p + n)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, l, h)))) * 0.1).astype(np.float32)
    a = -np.exp(rng.uniform(size=(b, h) if per_request else (h,))).astype(np.float32)
    bm, cm = (rng.standard_normal((b, l, g, n)).astype(np.float32) for _ in range(2))
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32) if state else None
    return x, dt, a, bm, cm, s0


def _torch(x, dt, a, bm, cm, s0):
    bf = (torch.from_numpy(v).to(torch.bfloat16) for v in (x, bm, cm))
    tx, tb, tc = bf
    return (tx, torch.from_numpy(dt), torch.from_numpy(a), tb, tc,
            None if s0 is None else torch.from_numpy(s0))


def _violations(got, want) -> tuple[int, int]:
    """Entries of (y, state) outside the bf16 bound."""
    (y, s), (yr, sr) = got, want
    y, yr = y.float(), yr.float()
    bad_y = (y - yr).abs() > 2e-3 + (2e-3 + 2.0 ** -7) * yr.abs()
    bad_s = (s - sr).abs() > 2e-3 + 2e-3 * sr.abs()
    return int(bad_y.sum()), int(bad_s.sum())


# (B, L, H, G, P, N, chunk, initial state): groups < heads, an initial
# state, a ragged Q (L = 80 under chunk 128), P = 64 with N = 128
PALLAS_CASES = [(1, 128, 4, 2, 32, 16, 64, False), (2, 128, 2, 1, 32, 64, 64, True),
                (1, 80, 2, 1, 32, 32, 128, False), (1, 256, 2, 1, 64, 128, 128, False)]


@pytest.mark.parametrize("b,l,h,g,p,n,chunk,state", PALLAS_CASES)
def test_kernel_arithmetic_matches_the_pallas_kernel(b, l, h, g, p, n, chunk, state):
    x, dt, a, bm, cm, s0 = _inputs(b, l, h, g, p, n, state=state)
    tx, tdt, ta, tb, tc, ts0 = _torch(x, dt, a, bm, cm, s0)
    js0 = None if s0 is None else jnp.asarray(s0)

    @jax.jit
    def pallas(x, dt, a, bm, cm, s0):
        return jops.ssd_scan(x, dt, a, bm, cm, chunk=chunk, initial_state=s0)

    yj, sj = pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(a),
                    jnp.asarray(bm, jnp.bfloat16), jnp.asarray(cm, jnp.bfloat16), js0)
    want = (torch.from_numpy(np.array(yj, np.float32)), torch.from_numpy(np.array(sj)))
    like = _kernel_like(tx, tdt, ta, tb, tc, chunk, ts0)
    assert like[0].dtype == torch.bfloat16 and like[0].shape == tx.shape
    assert _violations(like, want) == (0, 0)
    # the CPU wrapper (the plain version) at the same bound
    assert _violations(ssd_scan(tx, tdt, ta, tb, tc, chunk=chunk, initial_state=ts0),
                       want) == (0, 0)


# the kernels' edges: Q = 5 (under one 16-row step, two chunks), Q = 16
# with G = H, Q = 80 over two chunks (a ragged second query tile), Q = 192
# (three query and key tiles, double-buffered), mamba2-370m's P = 64 and
# N = 128 with an initial state; per-request A in three of them
TILING_CASES = [(1, 10, 4, 2, 32, 16, 5, False, False), (2, 64, 4, 4, 32, 64, 16, True, True),
                (2, 160, 4, 2, 32, 64, 80, False, True), (1, 192, 2, 1, 64, 128, 192, True, False),
                (1, 256, 2, 1, 64, 128, 128, True, True)]


@pytest.mark.parametrize("b,l,h,g,p,n,chunk,state,per_request", TILING_CASES)
def test_kernel_arithmetic_matches_the_plain_version(b, l, h, g, p, n, chunk, state,
                                                     per_request):
    ops = _torch(*_inputs(b, l, h, g, p, n, seed=1, state=state, per_request=per_request))
    like = _kernel_like(*ops[:5], chunk, ops[5])
    want = ssd_chunked(*ops[:5], min(chunk, l), ops[5])
    assert like[0].shape == ops[0].shape and like[1].shape == (b, h, p, n)
    assert _violations(like, want) == (0, 0)


@pytest.mark.parametrize("q", [1, 5, 31, 32, 33, 80, 128, 192, 256])
def test_scan_order_gives_the_prefix_sums(q):
    da = torch.from_numpy(-np.random.default_rng(q).uniform(0, 0.3, (3, q)).astype(np.float32))
    got = _scan_like(da)
    torch.testing.assert_close(got, torch.cumsum(da.double(), -1).float(), atol=0, rtol=1e-5)
    assert torch.equal(got[:, 0], da[:, 0])


def test_a_single_bf16_rounding_breaks_the_bound_the_split_keeps():
    """At mamba2-370m's P and N with an initial state, rounding the three
    fp32 operands once to bf16 puts entries of y past the 2e-3 absolute
    bound (where |y| is small); the hi/lo split keeps every entry in it."""
    ops = _torch(*_inputs(1, 256, 2, 1, 64, 128, seed=1, state=True))
    want = ssd_chunked(*ops[:5], 128, ops[5])
    assert _violations(_kernel_like(*ops[:5], 128, ops[5]), want) == (0, 0)
    bad_y, _ = _violations(_kernel_like(*ops[:5], 128, ops[5], split=False), want)
    assert bad_y > 0
