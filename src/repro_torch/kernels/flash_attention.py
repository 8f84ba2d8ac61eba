"""GQA flash attention (causal or sliding window) as a CUDA kernel for
Hopper.

``flash_attention`` replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention.py:flash_attention`` (reached through
``kernels/ops.flash_attention``): q ``(B, Lq, Hq, hd)``, k/v ``(B, Lkv,
Hkv, hd)`` in fp32 or bf16, online softmax in fp32, out in q's dtype.
Query head h reads kv head ``h // (Hq / Hkv)``; positions are the row
indices of q and k with no offset; causal keeps ``pos_q >= pos_k``, a
window ``pos_q - pos_k < window``; a row with no live key is 0. It runs
every prefill layer of the dense/VLM transformer (``models/attention.py``
modes ``"cuda"``, ``"pallas"`` and ``"blocked"``): one launch per layer,
the B requests of a batch in one grid. The source is
``csrc/flash_attention.cu``: bf16 runs both products on the tensor cores
(``mma.sync`` m16n8k16, FlashAttention-2 style, the G query heads of a kv
head folded into one block's rows), fp32 on the CUDA cores; its header
says what bounds each and how it is built.

Beside it: its plain version ``flash_attention_ref`` (a materialized fp32
softmax whose masked entries are zeroed, so a fully masked row is 0 as in
the kernel; the counterpart of ``kernels/ref.flash_attention_ref``; for
bf16 inputs it rounds p to bf16 before p·v and sums the rounded p, as the
kernel does) and the launch counter ``flash_attention.launches``. The
wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises; for meta tensors (the dry-run)
it returns a meta output and counts the kernel's reckoned work
(``kernels/common.py``).

Lengths are ragged: any ``Lq, Lkv >= 1``, as the JAX package's pure-JAX
``"blocked"`` mode takes them (its Pallas kernel asserts on a length that
``min(128, L)`` does not divide; whisper's 1,500 encoder frames are one).
The kernel computes the tails in place: rows past ``Lq`` and keys past
``Lkv`` of a tile are zero-filled by its copies and masked, with no
padded copy of q, k or v. It picks its own tiles.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.common import count_kernel, on_cpu, on_meta, raise_on

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)   # the kernel's instantiations


def _mask(lq: int, lkv: int, causal: bool, window: int | None,
          device: torch.device) -> torch.Tensor:
    pos_q = torch.arange(lq, device=device)[:, None]
    pos_k = torch.arange(lkv, device=device)[None, :]
    mask = torch.ones((lq, lkv), dtype=torch.bool, device=device)
    if causal:
        mask &= pos_q >= pos_k
    if window is not None:
        mask &= pos_q - pos_k < window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None) -> torch.Tensor:
    """Plain GQA attention with materialized fp32 ``(Lq, Lkv)`` scores:
    masked scores to -1e30, p = exp(s - rowmax) zeroed where masked, out =
    p·v / max(Σp, 1e-30), in q's dtype. For bf16 inputs p is rounded to
    bf16 first (the kernel's P·V operand on the tensor cores) and the sum
    is of the rounded p; each weight moves by at most 2^-9 of itself."""
    b, lq, hq, hd = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(b, lq, n_kv, hq // n_kv, hd).float()
    s = torch.einsum("blkgd,bmkd->bkglm", qg, k.float()) / math.sqrt(hd)
    mask = _mask(lq, k.shape[1], causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
    if q.dtype == torch.bfloat16:
        p = p.to(torch.bfloat16).float()
    out = torch.einsum("bkglm,bmkd->blkgd", p, v.float())
    den = p.sum(dim=-1).clamp_min(1e-30)                  # (B, Hkv, G, Lq)
    out = out / den.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, lq, hq, hd).to(q.dtype)


def _check_shapes(q, k, v, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: expected "
            "q (B, Lq, Hq, hd) and k = v (B, Lkv, Hkv, hd)")
    b, lq, hq, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or hq % k.shape[2]:
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree in batch or head "
            "dim, or Hq is not a multiple of Hkv")
    if lq < 1 or k.shape[1] < 1:
        raise ValueError(f"Lq = {lq}, Lkv = {k.shape[1]}: both must be >= 1")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None) -> torch.Tensor:
    """GQA flash attention. q ``(B, Lq, Hq, hd)``, k/v ``(B, Lkv, Hkv,
    hd)``, one dtype (fp32 or bf16 on the card); returns a new ``(B, Lq,
    Hq, hd)`` in q's dtype."""
    _check_shapes(q, k, v, window)
    if on_meta(q, k, v):
        count_kernel("flash_attention", b=q.shape[0], lq=q.shape[1], lkv=k.shape[1],
                     hq=q.shape[2], hkv=k.shape[2], hd=q.shape[3], causal=causal,
                     window=window, dtype=str(q.dtype).removeprefix("torch."))
        return torch.empty_like(q)
    if on_cpu(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    b, lq, hq, hd = q.shape
    lkv, hkv = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                        "takes one of float32, bfloat16")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernel is built for {HEAD_DIMS}")
    if b > 65535 or hq > 65535:
        raise ValueError(f"batch {b} or heads {hq} over the grid's 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes a contiguous tensor")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name}: the bf16 kernel's 16-byte copies need a "
                             "16-byte aligned start")
    out = torch.empty_like(q)
    lib = load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    raise_on(lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, lq, lkv, hq, hkv,
        hd, int(causal), -1 if window is None else int(window),
        int(q.dtype == torch.bfloat16), stream), "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
