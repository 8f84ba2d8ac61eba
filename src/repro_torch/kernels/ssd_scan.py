"""The Mamba2 SSD chunked scan as CUDA kernels for Hopper.

``ssd_scan`` replaces the Pallas TPU kernel
``src/repro/kernels/ssd_scan.py:ssd_scan`` together with
``kernels/ops.ssd_scan``'s expansion from groups to heads: x ``(B, L, H,
P)``, dt ``(B, L, H)``, A ``(H,)`` (or ``(B, H)``, one row per request),
B/C ``(B, L, G, N)`` with G dividing H, an optional initial state ``(B,
H, P, N)``; returns y ``(B, L, H, P)`` in x's dtype and the final state
``(B, H, P, N)`` in fp32. It runs every prefill layer of mamba2
(``models/ssm.apply_mamba_layer``, the scan at the JAX package's
``ssm.py:203``), the B requests of a batch in one call.

On the card a call is ``LAUNCHES_PER_CALL`` = 2 launches, each counted in
``ssd_scan.launches`` (see ``csrc/ssd_scan.cu``): the state walk (a block
per column slice of the state, head and batch walks the chunks in order,
keeps its slice on chip and publishes the state entering each chunk,
written once) and the outputs (the chunks in parallel, each reading its
entering state once). Which kernels run follows from a fixed rule of
(dtype, P, N), ``route``:

- ``"ssd_wgmma"``, bf16 with P = 64 and N a multiple of 64 (mamba2-370m,
  zamba2-1.2b): ``ssd_state_wgmma`` + ``ssd_out_wgmma``, warp-specialised
  ``wgmma`` with TMA-fed tiles in mbarrier rings, every fp32 operand as a
  hi/lo bf16 pair; a walk block takes ``walk_cols`` columns of the state,
  an outputs block ``heads_per_block`` heads of one group, which share B,
  C and the scores C·Bᵀ (both plans functions of the shape and the SM
  count, so a captured call replays them);
- ``"ssd_tf32"``, fp32 with P and N multiples of 16: ``ssd_state_tf32`` +
  ``ssd_out_tf32``, 3xTF32 on ``mma.sync`` (each operand split by a bit
  mask into a tf32 part and an exact residual);
- ``"ssd_cuda_core"``, any other shape in either dtype:
  ``ssd_state_walk`` + ``ssd_chunk_out``, plain FMAs.

Beside it: its plain version ``ssd_chunked`` (the JAX package's
``models/ssm.ssd_chunked`` in PyTorch, fp32 math: the intra-chunk dual
form, the chunk states, the inter-chunk recurrence as a loop over chunks,
and the carried state's contribution), which ``models/ssm.py`` re-exports
under its JAX name. The wrapper takes the plain version only for tensors
on the CPU; for CUDA tensors it launches the kernels or raises; for meta
tensors (the dry-run) it returns meta outputs and counts the kernel's
reckoned work (``kernels/common.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.common import count_kernel, on_cpu, on_meta, raise_on
from repro_torch.kernels.flash_attention import sm_count

NEG_INF = -1e30
MAX_SMEM = 232448   # the most shared memory one block can opt in to (H100)
NUM_SMS = 132       # an H100 SXM's SMs: heads_per_block's count off the card
# the routes, in the order of the C entry point's `route` argument, and
# the two kernels (state walk, outputs) each launches
ROUTES = ("ssd_cuda_core", "ssd_tf32", "ssd_wgmma")
ROUTE_KERNELS = {"ssd_cuda_core": ("ssd_state_walk", "ssd_chunk_out"),
                 "ssd_tf32": ("ssd_state_tf32", "ssd_out_tf32"),
                 "ssd_wgmma": ("ssd_state_wgmma", "ssd_out_wgmma")}
LAUNCHES_PER_CALL = 2   # the state walk, the outputs
MAX_HEADS_PER_BLOCK = 8
# the kernels' tiles (csrc/ssd_scan.cu), which smem_bytes counts
SCORE_ROWS = 32     # query rows per score tile, ssd_chunk_out
TF32_TOKENS = 32    # tokens per tile, ssd_state_tf32
TF32_STAGES = 4     # token tiles in flight, ssd_state_tf32
TF32_KEYS = 32      # keys per tile, ssd_out_tf32
TF32_ROWS = 64      # query rows per block, ssd_out_tf32
WG_STAGES = 4       # token tiles in ssd_state_wgmma's ring
WG_PARAM_SLOTS = 4  # chunk parameter slots in ssd_state_wgmma's ring
WG_TILE = 64 * 128  # bytes of one 128-byte-swizzled 64-row panel


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


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def route(dtype, p: int, n: int) -> str:
    """The kernels that compute a call in ``dtype`` (``torch.bfloat16`` /
    ``torch.float32`` or their names) at head dim P and state dim N: a
    fixed rule, the one place it is made (the C entry point takes its
    index in ``ROUTES``; ``ROUTE_KERNELS`` names its two kernels)."""
    name = str(dtype).removeprefix("torch.")
    if name not in ("bfloat16", "float32"):
        raise ValueError(f"no kernel for {name}")
    if name == "bfloat16":
        return "ssd_wgmma" if p == 64 and n % 64 == 0 else "ssd_cuda_core"
    return "ssd_tf32" if p % 16 == 0 and n % 16 == 0 else "ssd_cuda_core"


def heads_per_block(b: int, l: int, h: int, g: int, chunk: int,
                    num_sms: int = NUM_SMS) -> int:
    """Heads of one B/C group that one block of ``ssd_out_wgmma`` takes
    (they share its B and C tiles and its scores C·Bᵀ): the divisor hb of
    H/G up to MAX_HEADS_PER_BLOCK with the least waves × (hb + 1.5), the
    blocks' time in heads (1.5: a block's own loads and scores, in heads);
    the larger on a tie. A function of the shape and the SM count alone,
    so a captured call replays the same plan."""
    chunk = min(chunk, l)
    row_tiles = -(-chunk // 64)
    pairs = -(-row_tiles // 2)   # a block takes two 64-row query tiles
    best, best_cost = 1, None
    for hb in range(1, min(MAX_HEADS_PER_BLOCK, h // g) + 1):
        if (h // g) % hb:
            continue
        waves = -(-(pairs * (l // chunk) * (h // hb) * b) // num_sms)
        cost = waves * (hb + 1.5)
        if best_cost is None or cost <= best_cost:
            best, best_cost = hb, cost
    return best


def walk_cols(b: int, h: int, n: int, num_sms: int = NUM_SMS) -> int:
    """State columns one block of ``ssd_state_wgmma`` walks: 128 (one
    m64n128 product a k-step, x read once for the head) where N allows it
    and the walk still has a block for most SMs, else 64 (twice the
    blocks). A function of the shape and the SM count alone."""
    return 128 if n % 128 == 0 and 4 * b * h * (n // 128) >= 3 * num_sms else 64


def _wgmma_out_smem(chunk: int, p: int, n: int, slots: int) -> int:
    """ssd_out_wgmma's bytes: C and B tiles, ``slots`` head slots (x tiles,
    the S_in hi/lo images, cum and dt), the pair's three score tiles (in
    B's place where they fit there), mbarriers, 1 KB of alignment."""
    nrt, npn = -(-chunk // 64), n // 64
    slot = _up(nrt * WG_TILE + 4 * p * n + 2 * nrt * 64 * 4, 1024)
    scores = 3 * 64 * 64 * 4   # in B's place at Q <= 128 where B is as large
    own = 0 if nrt <= 2 and nrt * npn * WG_TILE >= scores else scores
    return 1024 + (2 + nrt) * npn * WG_TILE + slots * slot + own + 8 * (1 + 2 * slots)


def smem_bytes(chunk: int, p: int, n: int, dtype: torch.dtype = torch.float32) -> int:
    """Shared memory of the larger stage of the kernels that ``route``
    picks for ``(dtype, P, N)`` at a chunk (``ssd_out_wgmma`` with one head
    slot, the least it runs with); the wrapper refuses shapes past
    ``MAX_SMEM``."""
    r = route(dtype, p, n)
    if r == "ssd_wgmma":
        npn = 2 if n % 128 == 0 else 1   # the walk's widest plan (walk_cols)
        walk = 1024 + (WG_STAGES * (1 + npn) + 4 * npn) * WG_TILE \
            + WG_PARAM_SLOTS * (2 * _up(chunk, 64) + 4) * 4 + 8 * 2 * (WG_STAGES + WG_PARAM_SLOTS)
        return max(walk, _wgmma_out_smem(chunk, p, n, 1))
    if r == "ssd_tf32":
        walk = TF32_STAGES * (2 * TF32_TOKENS * (64 + 8) + chunk) + chunk \
            + _up(chunk, TF32_TOKENS)
        keys = TF32_KEYS * (n + 4) + TF32_KEYS * (p + 4)
        out = TF32_ROWS * (n + 4) + keys + max(keys, p * (n + 4)) + 2 * _up(chunk, TF32_ROWS)
        return 4 * max(walk, out)
    out = chunk * (n + 1) + chunk * p + p * (n + 1) + SCORE_ROWS * n \
        + SCORE_ROWS * chunk + chunk
    walk = chunk * (min(p, 64) + min(n, 128) + 1)
    return 4 * max(out, walk)


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
    rt = route(x.dtype, p, n)
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
        # 16-byte copies and TMA boxes; the rows are multiples of 16 bytes
        if rt != "ssd_cuda_core" and t.data_ptr() % 16:
            raise ValueError(f"{name}: the tensor-core kernels' 16-byte copies and TMA "
                             "need a 16-byte aligned start")
    dt32 = dt.float().contiguous()
    a32 = A.float().expand(b, h).contiguous()
    s0 = None if initial_state is None else initial_state.float().contiguous()
    c = l // chunk
    dev = x.device
    y = torch.empty_like(x)
    s_final = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    # the entering states (fp32, or route ssd_wgmma's hi/lo bf16 images: the
    # same 4 bytes an entry), and the walk's cum and dt for the outputs
    states = torch.empty((b, c, h, p, n), dtype=torch.float32, device=dev)
    cum, dtt = (torch.empty((b, h, l), dtype=torch.float32, device=dev) for _ in range(2))
    hb, cols = 1, 64
    if rt == "ssd_wgmma":
        hb = heads_per_block(b, l, h, g, chunk, sm_count(dev))
        cols = walk_cols(b, h, n, sm_count(dev))
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for stage in range(LAUNCHES_PER_CALL):
        raise_on(lib.ssd_scan_stage(
            x.data_ptr(), dt32.data_ptr(), a32.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            None if s0 is None else s0.data_ptr(), y.data_ptr(), s_final.data_ptr(),
            states.data_ptr(), cum.data_ptr(), dtt.data_ptr(), b, l, h, g, p, n, chunk,
            int(x.dtype == torch.bfloat16), ROUTES.index(rt), hb, cols, stage, stream),
            f"ssd_scan ({ROUTE_KERNELS[rt][stage]})")
        ssd_scan.launches += 1
    return y, s_final


ssd_scan.launches = 0
