"""The Mamba2 SSD chunked scan as a CUDA kernel for Hopper.

``ssd_scan`` replaces the Pallas TPU kernel
``src/repro/kernels/ssd_scan.py:ssd_scan`` together with
``kernels/ops.ssd_scan``'s expansion from groups to heads: x ``(B, L, H,
P)``, dt ``(B, L, H)``, A ``(H,)`` (or ``(B, H)``, one row per request),
B/C ``(B, L, G, N)`` with G dividing H, an optional initial state ``(B,
H, P, N)``; returns y ``(B, L, H, P)`` in x's dtype and the final state
``(B, H, P, N)`` in fp32. It runs every prefill layer of mamba2
(``models/ssm.apply_mamba_layer``, the scan at the JAX package's
``ssm.py:203``), the B requests of a batch in one call. On the card it is
three launches (chunk states, the inter-chunk state pass, outputs; see
``csrc/ssd_scan.cu``), each counted in ``ssd_scan.launches``. Which
kernels run the chunk-state and output stages follows from dtype and
shape: bf16 with P and N multiples of 16 (every mamba2-family config) on
the tensor cores (``ssd_chunk_state_mma``, ``ssd_chunk_out_mma``: bf16
``mma.sync`` with each fp32 operand split into a hi/lo bf16 pair), at any
chunk; fp32, and bf16 at other P or N, on the CUDA cores
(``ssd_chunk_state``, ``ssd_chunk_out``).

Beside it: its plain version ``ssd_chunked`` (the JAX package's
``models/ssm.ssd_chunked`` in PyTorch, fp32 math: the intra-chunk dual
form, the chunk states, the inter-chunk recurrence as a loop over chunks,
and the carried state's contribution), which ``models/ssm.py`` re-exports
under its JAX name. The wrapper takes the plain version only for tensors
on the CPU; for CUDA tensors it launches the kernel or raises; for meta
tensors (the dry-run) it returns meta outputs and counts the kernel's
reckoned work (``kernels/common.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.common import count_kernel, on_cpu, on_meta, raise_on

NEG_INF = -1e30
MAX_SMEM = 232448   # the most shared memory one block can opt in to (H100)
SCORE_ROWS = 32     # query rows per score tile in the CUDA-core output stage
MMA_ROWS = 64       # query rows per block, keys per tile (tensor-core output stage)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: ``out[..., i, j] = sum_{k=j+1..i} x[..., k]`` for
    i >= j, -1e30 above the diagonal."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(q, device=x.device)
    return torch.where(i[:, None] >= i[None, :], d, NEG_INF)


def _per_request(a: torch.Tensor) -> torch.Tensor:
    """A ``(H,)`` or ``(B, H)`` -> broadcastable against ``(B, C, Q, H)``."""
    a = a.float()
    return a[:, None, None, :] if a.dim() == 2 else a


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                initial_state: torch.Tensor | None = None):
    """Plain chunked SSD. x ``(B, L, H, P)``, dt ``(B, L, H)``, A ``(H,)``
    or ``(B, H)``, Bm/Cm ``(B, L, G, N)``. Returns ``(y (B, L, H, P) in
    x's dtype, final_state (B, H, P, N) fp32)``."""
    b, l, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    if l % chunk:
        raise ValueError(f"seq {l} not divisible by chunk {chunk}")
    c = l // chunk
    xc = x.reshape(b, c, chunk, h, p).float()
    dtc = dt.reshape(b, c, chunk, h).float()
    bh = Bm.reshape(b, c, chunk, g, n).float().repeat_interleave(rep, dim=3)
    ch = Cm.reshape(b, c, chunk, g, n).float().repeat_interleave(rep, dim=3)

    da = dtc * _per_request(A)                    # (b, c, q, h)
    cum = torch.cumsum(da, dim=2)                 # within-chunk cumulative

    # intra-chunk (diagonal blocks), dual quadratic form
    lmat = torch.exp(_segsum(da.transpose(2, 3)))          # (b, c, h, q, q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", ch, bh)
    xdt = xc * dtc[..., None]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores * lmat, xdt)

    # chunk states
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)      # (b, c, q, h)
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", bh, decay_states * dtc, xc)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])              # (b, c, h)
    s = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    prev = []
    for ci in range(c):
        prev.append(s)
        s = s * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                 # (b, c, h, p, n)

    # off-diagonal contribution of the carried states
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", ch, prev_states, torch.exp(cum))
    y = (y_diag + y_off).reshape(b, l, h, p)
    return y.to(x.dtype), s


def takes_mma(dtype: torch.dtype, p: int, n: int) -> bool:
    """True when the chunk-state and output stages run on the tensor
    cores: bf16 with P and N multiples of 16."""
    return dtype == torch.bfloat16 and p % 16 == 0 and n % 16 == 0


def smem_bytes(chunk: int, p: int, n: int, dtype: torch.dtype = torch.float32) -> int:
    """Shared memory of the larger stage of the kernels that take
    ``(dtype, P, N)`` at a chunk, head dim P and state dim N; the wrapper
    refuses shapes past ``MAX_SMEM``."""
    if takes_mma(dtype, p, n):
        q16 = -(-chunk // 16) * 16
        q64 = -(-chunk // MMA_ROWS) * MMA_ROWS
        state = 2 * q16 * (p + 8 + n + 8) + 8 * q16
        tile = 2 * MMA_ROWS * (n + 8 + 72)           # B and x of one key tile
        out = 2 * MMA_ROWS * (n + 8) + tile + max(tile, 4 * MMA_ROWS * 68) + 8 * q64
        return max(out, state)
    out = chunk * (n + 1) + chunk * p + p * (n + 1) + SCORE_ROWS * n \
        + SCORE_ROWS * chunk + chunk
    state = chunk * p + chunk * n + chunk
    return 4 * max(out, state)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
             initial_state: torch.Tensor | None = None):
    """Mamba2 SSD chunked scan over grouped B/C (``chunk = min(chunk, L)``).
    Returns ``(y (B, L, H, P) in x's dtype, final_state (B, H, P, N)
    fp32)``."""
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 4 or Bm.shape != Cm.shape:
        raise ValueError(
            f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, B {tuple(Bm.shape)}, C "
            f"{tuple(Cm.shape)}: expected (B, L, H, P), (B, L, H), (B, L, G, N) x2")
    b, l, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if tuple(dt.shape) != (b, l, h) or tuple(Bm.shape[:2]) != (b, l) or h % g:
        raise ValueError(
            f"x {tuple(x.shape)}, dt {tuple(dt.shape)} and B {tuple(Bm.shape)} "
            "disagree, or the groups do not divide the heads")
    if tuple(A.shape) not in ((h,), (b, h)):
        raise ValueError(f"A {tuple(A.shape)}: expected ({h},) or ({b}, {h})")
    if initial_state is not None and tuple(initial_state.shape) != (b, h, p, n):
        raise ValueError(f"initial state {tuple(initial_state.shape)} != {(b, h, p, n)}")
    chunk = min(int(chunk), l)
    if l % chunk:
        raise ValueError(f"seq {l} not divisible by chunk {chunk}")
    ops = (x, dt, A, Bm, Cm) + (() if initial_state is None else (initial_state,))
    if on_meta(*ops):
        count_kernel("ssd_scan", b=b, l=l, h=h, g=g, p=p, n=n, chunk=chunk,
                     dtype=str(x.dtype).removeprefix("torch."),
                     state=initial_state is not None)
        return (torch.empty_like(x),
                torch.empty((b, h, p, n), dtype=torch.float32, device="meta"))
    if on_cpu(*ops):
        return ssd_chunked(x, dt, A, Bm, Cm, chunk, initial_state)
    if x.dtype not in (torch.float32, torch.bfloat16) or Bm.dtype != x.dtype \
            or Cm.dtype != x.dtype:
        raise TypeError(f"x/B/C dtypes {x.dtype}/{Bm.dtype}/{Cm.dtype}: the kernel "
                        "takes one of float32, bfloat16")
    need = smem_bytes(chunk, p, n, x.dtype)
    if need > MAX_SMEM:
        raise ValueError(
            f"chunk {chunk}, P {p}, N {n} need {need} bytes of shared memory per "
            f"block; the kernel has {MAX_SMEM}")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} over the grid's 65535")
    for name, t in (("x", x), ("B", Bm), ("C", Cm)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes a contiguous tensor")
        if takes_mma(x.dtype, p, n) and t.data_ptr() % 16:
            raise ValueError(f"{name}: the tensor-core kernels' 16-byte copies need a "
                             "16-byte aligned start")
    dt32 = dt.float().contiguous()
    a32 = A.float().expand(b, h).contiguous()
    s0 = None if initial_state is None else initial_state.float().contiguous()
    c = l // chunk
    y = torch.empty_like(x)
    s_final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    states = torch.empty((b, c, h, p, n), dtype=torch.float32, device=x.device)
    cum_last = torch.empty((b, c, h), dtype=torch.float32, device=x.device)
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for stage in range(3):
        raise_on(lib.ssd_scan_stage(
            x.data_ptr(), dt32.data_ptr(), a32.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            None if s0 is None else s0.data_ptr(), y.data_ptr(), s_final.data_ptr(),
            states.data_ptr(), cum_last.data_ptr(), b, l, h, g, p, n, chunk,
            int(x.dtype == torch.bfloat16), stage, stream), f"ssd_scan (stage {stage})")
        ssd_scan.launches += 1
    return y, s_final


ssd_scan.launches = 0
