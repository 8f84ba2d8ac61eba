"""FedSPD's gossip mix C' = W·C, and its fused-dequant siblings, as CUDA
kernels for Hopper.

Seven kernels, built by ``kernels/build.py``. In ``csrc/gossip_mix.cu``:

- ``gossip_mix_flat`` replaces the Pallas TPU kernel
  ``src/repro/kernels/gossip_mix.py:gossip_mix_flat``: C' = W·C over the
  packed ``(N, X)`` plane, once per round on the main path (and in the
  FedAvg, pFedMe and IFCA baselines' exchange); on the pytree engine
  (``RunConfig(param_plane=False)``) ``gossip_mix_tree`` launches it once
  per leaf of the ``(N, ...)`` tree instead.
- ``gossip_mix_stack`` replaces
  ``src/repro/kernels/gossip_mix.py:gossip_mix_stack``: C'_s = W·C_s for
  every slab of an ``(S, N, X)`` stack in one launch (grid.y = S), the
  FedEM exchange, once per round.
- ``gossip_mix_fused_dp`` replaces
  ``src/repro/kernels/gossip_mix.py:gossip_mix_fused_dp``:
  W·(c_old + scale ⊙ (c_new − c_old) + σ·noise) in one pass, once per DP
  round. The noise is drawn outside the kernel; with σ = 0 there is no
  noise operand.
- ``gossip_mix_sparse`` replaces
  ``src/repro/kernels/gossip_mix.py:gossip_mix_sparse``: W·C for the
  sparse (DisPFL) exchange, C zero on dead columns, given the column
  activity (X,); a block of columns that no client keeps writes exact
  zeros (past the narrow plane without reading C). Twice per sparse round
  without a codec (the numerator W·(M⊙C) and the support count W·M), once
  with int8/int4.
- ``gossip_mix_dequant_masked`` replaces
  ``src/repro/kernels/gossip_mix.py:gossip_mix_dequant_masked``:
  W·(q ⊙ repeat(scale, qblock) ⊙ M) over an int8 payload with the
  per-sender mask ``(N, X)``, X ≤ Xp (columns past X count as 0), the
  sparse exchange's numerator with an int8/int4 codec, once per such
  round; it takes the same column activity as ``gossip_mix_sparse`` and
  skips dead blocks the same way.

All five are memory-bound on an H100 for N below ≈ 80: they move
4·(N² + 2NX) bytes (flat; 4·(N² + 2SNX) for the stack) for 2N²X
(2SN²X) FLOPs. The kernel streams the plane once, one thread per
column, with W staged in shared memory and fp32 FMA accumulation (no
TF32); see the source for the design.

The narrow plane: a square W (M = N ≤ 32) over a plane narrower than
65,536 columns (``kNarrowMaxX`` in the source; the main path's N = 20,
X = 17,226 plane is one) takes a kernel of its own, chosen in C from the
shape alone: ``gossip_mix_flat``, ``gossip_mix_sparse``,
``gossip_mix_fused_dp`` (the DP rounds' exchange),
``gossip_mix_dequant_masked`` and, on the square W,
``gossip_mix_dequant``. A call there takes a few µs and is bound by
latency: every load of a block is issued before its one barrier, and
past 8 rows four threads share a column. Its results are the same bits
as the other kernels' on the same shape.

Wider planes of up to 32 rows take, in two mixes, kernels whose threads
own adjacent columns, so each warp request moves more bytes:
``gossip_mix_dequant_masked`` past the narrow plane, with X, Xp and
qblock multiples of 4 and 16-byte aligned operands (4 columns: a char4
of quanta, a float4 of mask and one scale a row), and
``gossip_mix_fused_dp`` from 49,152 columns (``kDpVecMinX`` in the
source: with three loads a row the narrow kernel loses there already),
with X even and 8-byte aligned planes (2 columns: a float2 each of
c_old, c_new and the noise and one scale a row). Other shapes (an
unaligned view, an odd width or block) take the narrow kernel below
65,536 columns and the one-column kernel past it, with the same bits.

In ``csrc/gossip_mix_dequant.cu``:

- ``gossip_mix_dequant`` replaces
  ``src/repro/kernels/gossip_mix.py:gossip_mix_dequant``:
  W·(q ⊙ repeat(scale, qblock)) over an int8 ``(N, Xp)`` plane with fp32
  per-block scales, W rectangular ``(M, N)``; the int8 serving plane
  (M = B requests, N = S clusters).
- ``mixture_mix_dequant4`` replaces
  ``src/repro/kernels/gossip_mix.py:mixture_mix_dequant4``:
  U·(unpack4(p) ⊙ repeat(scale, qblock)) over the bit-packed int4
  ``(S, Xp/2)`` plane; the int4 serving plane.
``gossip_mix_dequant`` also runs the dense exchange with an int8/int4
codec, on the square W (M = N), once per round: on the narrow plane
through ``csrc/gossip_mix.cu``'s narrow kernel, else through the serving
kernel.

At serving and LM-mix shapes both are bound by their ``(M, Xp)`` fp32
output writes: they move 4·M·N + N·Xp·(1 or ½) + 4·N·Xp/qblock + 4·M·Xp
bytes for 2·M·N·Xp FLOPs. Up to S = 4 clusters, with Xp and qblock
multiples of 4 (every serving plane and LM mix the port builds) and M
not 3 or 4, ``mix_dequant_stream`` gives each thread one group of 4
adjacent columns, which share one scale, for a block of 1, 2 or 4 output
rows (by M): W in registers, no barrier, the scale index found without a
64-bit division, one coalesced 16-byte streaming store a row; the grid
covers the width (striding on past 2^31 columns, as olmoe-1b-7b's plane
does). Other shapes take the earlier template (4, 2 or 1 columns a
thread, W staged in shared memory between barriers, N in chunks of 16
rows); at M = 4, the dense LMs' four-request mix, it measured as fast as
any variant of the stream kernel. Every route sums each output j
ascending from 0, so a row's bits do not depend on M or on the route;
see the source.

Beside each kernel: its plain PyTorch version (``*_ref``, an fp32 einsum
with the prologue written out) and a launch counter (``.launches`` on the
wrapper, raised by one per kernel launch and nowhere else). A wrapper
takes the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.comm.codecs import int4_unpack
from repro_torch.kernels.build import load_library
from repro_torch.kernels.common import check as _check
from repro_torch.kernels.common import on_cpu as _on_cpu
from repro_torch.kernels.common import raise_on as _raise_on
from repro_torch.utils.pytree import tree_map


def gossip_mix_flat_ref(w: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Plain C' = W·C, fp32 accumulation."""
    return torch.einsum("ij,jx->ix", w.float(), c.float())


def gossip_mix_stack_ref(w: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Plain C'_s = W·C_s for every s, fp32 accumulation."""
    return torch.einsum("ij,sjx->six", w.float(), c.float())


def gossip_mix_fused_dp_ref(w, c_old, c_new, scale, noise,
                            sigma: float) -> torch.Tensor:
    """Plain W·(c_old + scale ⊙ (c_new − c_old) [+ σ·noise])."""
    c = c_old + scale.reshape(-1, 1) * (c_new - c_old)
    if sigma > 0.0:
        c = c + sigma * noise
    return gossip_mix_flat_ref(w, c)


def gossip_mix_dequant_ref(w: torch.Tensor, q: torch.Tensor,
                           scales: torch.Tensor, *, qblock: int) -> torch.Tensor:
    """Plain W·(q ⊙ repeat(scale, qblock)): decode to fp32, then an fp32
    einsum."""
    c = q.float() * scales.float().repeat_interleave(qblock, dim=1)
    return torch.einsum("mn,nx->mx", w.float(), c)


def mixture_mix_dequant4_ref(u: torch.Tensor, packed: torch.Tensor,
                             scales: torch.Tensor, *, qblock: int) -> torch.Tensor:
    """Plain U·(unpack4(p) ⊙ repeat(scale, qblock)): decode to fp32, then
    an fp32 einsum."""
    q = int4_unpack(packed, 2 * packed.shape[1])
    return gossip_mix_dequant_ref(u, q, scales, qblock=qblock)


def gossip_mix_sparse_ref(w: torch.Tensor, c: torch.Tensor,
                          col_active: torch.Tensor) -> torch.Tensor:
    """Plain W·C with the inactive columns zero: the sparse mix for a C
    that is zero on them."""
    return torch.where(col_active > 0, gossip_mix_flat_ref(w, c), 0.0)


def gossip_mix_dequant_masked_ref(w: torch.Tensor, q: torch.Tensor,
                                  scales: torch.Tensor, mask: torch.Tensor,
                                  col_active: torch.Tensor, *,
                                  qblock: int) -> torch.Tensor:
    """Plain W·(q ⊙ repeat(scale, qblock) ⊙ M) with the inactive columns
    zero, the mask and the activity zero-padded from X to Xp: decode,
    mask, then an fp32 einsum."""
    pad = q.shape[1] - mask.shape[1]
    c = q.float() * scales.float().repeat_interleave(qblock, dim=1)
    c = c * F.pad(mask.float(), (0, pad))
    return torch.where(F.pad(col_active, (0, pad)) > 0,
                       torch.einsum("mn,nx->mx", w.float(), c), 0.0)


def gossip_mix_flat(w: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """C' = W·C. w ``(N, N)``, c ``(N, X)``, fp32; returns a new ``(N, X)``."""
    if _on_cpu(w, c):
        return gossip_mix_flat_ref(w, c)
    n, x = c.shape
    _check("w", w, (n, n))
    _check("c", c, (n, x))
    out = torch.empty_like(c)
    lib = load_library()
    stream = torch.cuda.current_stream(c.device).cuda_stream
    _raise_on(lib.gossip_mix_flat(w.data_ptr(), c.data_ptr(), out.data_ptr(),
                                  n, x, stream), "gossip_mix_flat")
    gossip_mix_flat.launches += 1
    return out


gossip_mix_flat.launches = 0


def gossip_mix_tree_ref(w: torch.Tensor, c_tree):
    """Plain C' = W·C leaf by leaf over a tree of ``(N, ...)`` leaves
    (``utils/pytree.py``): ``gossip_mix_flat_ref`` of each leaf viewed as
    ``(N, -1)``, cast back to the leaf's dtype."""
    return tree_map(lambda leaf: gossip_mix_flat_ref(w, leaf.reshape(leaf.shape[0], -1))
                    .reshape(leaf.shape).to(leaf.dtype), c_tree)


def gossip_mix_tree(w: torch.Tensor, c_tree):
    """C' = W·C over a tree of ``(N, ...)`` leaves, the pytree engine's
    exchange (``src/repro/kernels/gossip_mix.py:gossip_mix_tree``, which
    the JAX package's ``kernels/ops.gossip_mix`` jits): one
    ``gossip_mix_flat`` launch per leaf, each leaf viewed as ``(N, -1)``
    (copied first when that view is not contiguous, so the kernel never
    reads a wrong stride) and the result cast back to the leaf's dtype. A
    bare ``(N, X)`` tensor is one leaf: one launch, as on the plane."""
    return tree_map(lambda leaf: gossip_mix_flat(w, leaf.reshape(leaf.shape[0], -1)
                                                 .contiguous())
                    .reshape(leaf.shape).to(leaf.dtype), c_tree)


def gossip_mix_stack(w: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """C'_s = W·C_s for every s, in one launch. w ``(N, N)``, c
    ``(S, N, X)``, fp32; returns a new ``(S, N, X)``. Raises on the shape
    errors the JAX kernel refuses."""
    if c.dim() != 3:
        raise ValueError(f"c: shape {tuple(c.shape)}, expected a (S, N, X) stack")
    s, n, x = c.shape
    if tuple(w.shape) != (n, n):
        raise ValueError(f"w: shape {tuple(w.shape)}, expected {(n, n)}")
    if _on_cpu(w, c):
        return gossip_mix_stack_ref(w, c)
    _check("w", w, (n, n))
    _check("c", c, (s, n, x))
    if s > 65535:
        raise ValueError(f"c: {s} slabs, the kernel takes at most 65535")
    out = torch.empty_like(c)
    lib = load_library()
    stream = torch.cuda.current_stream(c.device).cuda_stream
    _raise_on(lib.gossip_mix_stack(w.data_ptr(), c.data_ptr(), out.data_ptr(),
                                   s, n, x, stream), "gossip_mix_stack")
    gossip_mix_stack.launches += 1
    return out


gossip_mix_stack.launches = 0


def gossip_mix_fused_dp(w: torch.Tensor, c_old: torch.Tensor,
                        c_new: torch.Tensor, scale: torch.Tensor,
                        noise: torch.Tensor | None,
                        sigma: float) -> torch.Tensor:
    """W·(c_old + scale ⊙ (c_new − c_old) + σ·noise). scale ``(N, 1)`` or
    ``(N,)``; ``noise`` is ``(N, X)`` when σ > 0 and None when σ = 0."""
    sigma = float(sigma)
    if (noise is None) != (sigma <= 0.0):
        raise ValueError("noise must be given exactly when sigma > 0")
    ops = (w, c_old, c_new, scale) + ((noise,) if noise is not None else ())
    if _on_cpu(*ops):
        return gossip_mix_fused_dp_ref(w, c_old, c_new, scale, noise, sigma)
    n, x = c_old.shape
    scale = scale.reshape(n)
    _check("w", w, (n, n))
    _check("c_old", c_old, (n, x))
    _check("c_new", c_new, (n, x))
    _check("scale", scale, (n,))
    if noise is not None:
        _check("noise", noise, (n, x))
    out = torch.empty_like(c_old)
    lib = load_library()
    stream = torch.cuda.current_stream(c_old.device).cuda_stream
    _raise_on(lib.gossip_mix_fused_dp(
        w.data_ptr(), c_old.data_ptr(), c_new.data_ptr(), scale.data_ptr(),
        noise.data_ptr() if noise is not None else None, sigma,
        out.data_ptr(), n, x, stream), "gossip_mix_fused_dp")
    gossip_mix_fused_dp.launches += 1
    return out


gossip_mix_fused_dp.launches = 0


def gossip_mix_dequant(w: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                       *, qblock: int) -> torch.Tensor:
    """W·(q ⊙ repeat(scale, qblock)). w ``(M, N)`` fp32, q ``(N, Xp)``
    int8, scales ``(N, Xp/qblock)`` fp32; returns a new ``(M, Xp)`` fp32.
    Raises on the shape errors the JAX kernel refuses."""
    n, xp = q.shape
    qblock = int(qblock)
    if w.dim() != 2 or w.shape[1] != n:
        raise ValueError(f"weights {tuple(w.shape)} do not match plane rows {n}")
    if qblock <= 0 or xp % qblock != 0 or tuple(scales.shape) != (n, xp // qblock):
        raise ValueError(
            f"quantized plane {tuple(q.shape)} / scales {tuple(scales.shape)} "
            f"do not tile with qblock={qblock}")
    if _on_cpu(w, q, scales):
        return gossip_mix_dequant_ref(w, q, scales, qblock=qblock)
    m = w.shape[0]
    _check("w", w, (m, n))
    _check("q", q, (n, xp), torch.int8)
    _check("scales", scales, (n, xp // qblock))
    out = torch.empty((m, xp), dtype=torch.float32, device=q.device)
    lib = load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _raise_on(lib.gossip_mix_dequant(w.data_ptr(), q.data_ptr(), scales.data_ptr(),
                                     out.data_ptr(), m, n, xp, qblock, stream),
              "gossip_mix_dequant")
    gossip_mix_dequant.launches += 1
    return out


gossip_mix_dequant.launches = 0


def mixture_mix_dequant4(u: torch.Tensor, packed: torch.Tensor,
                         scales: torch.Tensor, *, qblock: int) -> torch.Tensor:
    """U·(unpack4(p) ⊙ repeat(scale, qblock)). u ``(B, S)`` fp32, packed
    ``(S, Xp/2)`` uint8, scales ``(S, Xp/qblock)`` fp32, qblock even;
    returns a new ``(B, Xp)`` fp32. Raises on the shape errors the JAX
    kernel refuses."""
    s, xh = packed.shape
    xp, qblock = 2 * xh, int(qblock)
    if qblock <= 0 or qblock % 2 or xp % qblock != 0 \
            or tuple(scales.shape) != (s, xp // qblock):
        raise ValueError(
            f"packed plane {tuple(packed.shape)} / scales {tuple(scales.shape)} "
            f"do not tile with an even qblock={qblock}")
    if u.dim() != 2 or u.shape[1] != s:
        raise ValueError(f"mixture weights {tuple(u.shape)} != (B, {s})")
    if _on_cpu(u, packed, scales):
        return mixture_mix_dequant4_ref(u, packed, scales, qblock=qblock)
    b = u.shape[0]
    _check("u", u, (b, s))
    _check("packed", packed, (s, xh), torch.uint8)
    _check("scales", scales, (s, xp // qblock))
    out = torch.empty((b, xp), dtype=torch.float32, device=packed.device)
    lib = load_library()
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    _raise_on(lib.mixture_mix_dequant4(u.data_ptr(), packed.data_ptr(),
                                       scales.data_ptr(), out.data_ptr(), b, s, xp,
                                       qblock, stream),
              "mixture_mix_dequant4")
    mixture_mix_dequant4.launches += 1
    return out


mixture_mix_dequant4.launches = 0

def gossip_mix_sparse(w: torch.Tensor, c: torch.Tensor,
                      col_active: torch.Tensor) -> torch.Tensor:
    """W·C for a C that is zero on the columns where ``col_active`` ``(X,)``
    is 0: all-inactive blocks of columns are written as zeros. From 65,536
    columns (or past 32 rows) such a block never reads C; below it, at
    N ≤ 32, the activity test shares one round trip with the loads of C,
    so a dead block has read its columns and drops them (the plane is in
    L2 there, and a second round trip cost more than those reads). w
    ``(N, N)``, c ``(N, X)``, col_active ``(X,)``, fp32; returns a new
    ``(N, X)``. Raises on the shape errors the JAX kernel refuses."""
    n, x = c.shape
    if tuple(col_active.shape) != (x,):
        raise ValueError(
            f"column activity {tuple(col_active.shape)} does not match plane "
            f"width {x}")
    if _on_cpu(w, c, col_active):
        return gossip_mix_sparse_ref(w, c, col_active)
    _check("w", w, (n, n))
    _check("c", c, (n, x))
    _check("col_active", col_active, (x,))
    out = torch.empty_like(c)
    lib = load_library()
    stream = torch.cuda.current_stream(c.device).cuda_stream
    _raise_on(lib.gossip_mix_sparse(w.data_ptr(), c.data_ptr(), col_active.data_ptr(),
                                    out.data_ptr(), n, x, stream), "gossip_mix_sparse")
    gossip_mix_sparse.launches += 1
    return out


gossip_mix_sparse.launches = 0


def gossip_mix_dequant_masked(w: torch.Tensor, q: torch.Tensor,
                              scales: torch.Tensor, mask: torch.Tensor,
                              col_active: torch.Tensor, *,
                              qblock: int) -> torch.Tensor:
    """W·(q ⊙ repeat(scale, qblock) ⊙ M) for a mask zero on the columns
    where ``col_active`` ``(X,)`` is 0: all-inactive blocks of columns are
    written as zeros without reading the payload (on the narrow plane,
    after reading it, as ``gossip_mix_sparse`` does). w ``(M, N)`` fp32, q
    ``(N, Xp)`` int8, scales ``(N, Xp/qblock)`` fp32, mask ``(N, X)`` fp32
    {0, 1} with X ≤ Xp (columns past X count as 0); returns a new ``(M,
    Xp)`` fp32. Raises on the shape errors the JAX kernel refuses."""
    n, xp = q.shape
    qblock = int(qblock)
    if w.dim() != 2 or w.shape[1] != n:
        raise ValueError(f"weights {tuple(w.shape)} do not match plane rows {n}")
    if qblock <= 0 or xp % qblock != 0 or tuple(scales.shape) != (n, xp // qblock):
        raise ValueError(
            f"quantized plane {tuple(q.shape)} / scales {tuple(scales.shape)} "
            f"do not tile with qblock={qblock}")
    if mask.dim() != 2 or mask.shape[0] != n or mask.shape[1] > xp:
        raise ValueError(
            f"mask {tuple(mask.shape)} does not match quantized plane {tuple(q.shape)}")
    x = mask.shape[1]
    if tuple(col_active.shape) != (x,):
        raise ValueError(
            f"column activity {tuple(col_active.shape)} does not match mask width {x}")
    if _on_cpu(w, q, scales, mask, col_active):
        return gossip_mix_dequant_masked_ref(w, q, scales, mask, col_active, qblock=qblock)
    m = w.shape[0]
    _check("w", w, (m, n))
    _check("q", q, (n, xp), torch.int8)
    _check("scales", scales, (n, xp // qblock))
    _check("mask", mask, (n, x))
    _check("col_active", col_active, (x,))
    if xp >= 2**31:
        raise ValueError(f"quantized plane width {xp}: the kernel takes Xp < 2^31")
    out = torch.empty((m, xp), dtype=torch.float32, device=q.device)
    lib = load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _raise_on(lib.gossip_mix_dequant_masked(
        w.data_ptr(), q.data_ptr(), scales.data_ptr(), mask.data_ptr(),
        col_active.data_ptr(), out.data_ptr(), m, n, x, xp, qblock, stream),
        "gossip_mix_dequant_masked")
    gossip_mix_dequant_masked.launches += 1
    return out


gossip_mix_dequant_masked.launches = 0


def gossip_mix_encoded(w: torch.Tensor, enc: dict, *, qblock: int,
                       x_out: int) -> torch.Tensor:
    """The fused compressed exchange: one ``gossip_mix_dequant`` over an
    int8/int4 payload ``{"q", "scale"}`` (``comm/codecs.quant_encode``),
    cropped to the logical width ``x_out``."""
    return gossip_mix_dequant(w, enc["q"], enc["scale"], qblock=qblock)[:, :x_out]


def gossip_mix_encoded_masked(w: torch.Tensor, enc: dict, mask: torch.Tensor,
                              col_active: torch.Tensor, *, qblock: int) -> torch.Tensor:
    """The sparse exchange's numerator W·(M⊙Ĉ): one
    ``gossip_mix_dequant_masked`` over the payload, cropped to the mask's
    width X."""
    mixed = gossip_mix_dequant_masked(w, enc["q"], enc["scale"], mask, col_active,
                                      qblock=qblock)
    return mixed[:, :mask.shape[1]]


KERNELS = (gossip_mix_flat, gossip_mix_stack, gossip_mix_fused_dp,
           gossip_mix_dequant, mixture_mix_dequant4, gossip_mix_sparse,
           gossip_mix_dequant_masked)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
