"""GQA flash attention (causal or sliding window) as CUDA kernels for
Hopper.

``flash_attention`` replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention.py:flash_attention`` (reached through
``kernels/ops.flash_attention``): q ``(B, Lq, Hq, hd)``, k/v ``(B, Lkv,
Hkv, hd)`` in fp32 or bf16, online softmax in fp32, out in q's dtype.
Query head h reads kv head ``h // (Hq / Hkv)``; positions are the row
indices of q and k with no offset; causal keeps ``pos_q >= pos_k``, a
window ``pos_q - pos_k < window``; a row with no live key is 0. It runs
every prefill layer of the dense/VLM transformer (``models/attention.py``
modes ``"cuda"``, ``"pallas"`` and ``"blocked"``): one call per layer,
the B requests of a batch in one grid. The source is
``csrc/flash_attention.cu``; its header says what bounds each route and
what its design does about it.

Routes, a fixed rule of (dtype, hd) (``route``):

- bf16 at hd 64, 128, 256: ``flash_wgmma_kernel``, warp-specialised
  ``wgmma`` with TMA-fed k/v tiles in a ring of mbarrier stages;
- bf16 at hd 16, 32, 80, 96: ``flash_mma_kernel`` (``mma.sync``);
- fp32: ``flash_tf32_kernel``, 3xTF32 on the tensor cores.

The G query heads of a kv head are folded into one block's rows, so a k/v
tile is read once per kv head. A short query range splits its keys
(``split_plan``, a function of the shape alone): each chunk's blocks write
fp32 ``(m, l, acc)`` partials to scratch that the wrapper allocates, and
``flash_combine_kernel`` merges them. One call counts one launch
(``flash_attention.launches``), whatever kernels the split adds.

Beside it: its plain version ``flash_attention_ref`` (a materialized fp32
softmax whose masked entries are zeroed, so a fully masked row is 0 as in
the kernel; the counterpart of ``kernels/ref.flash_attention_ref``; for
bf16 inputs it rounds p to bf16 before p·v and sums the rounded p, as the
kernels do), the plain split-and-merge ``flash_attention_split_ref`` and
the launch counter. The wrapper takes the plain version only for tensors
on the CPU; for CUDA tensors it launches a kernel or raises; for meta
tensors (the dry-run) it returns a meta output and counts the kernel's
reckoned work (``kernels/common.py``).

Lengths are ragged: any ``Lq, Lkv >= 1``, as the JAX package's pure-JAX
``"blocked"`` mode takes them (its Pallas kernel asserts on a length that
``min(128, L)`` does not divide; whisper's 1,500 encoder frames are one).
The kernels compute the tails in place: rows past ``Lq`` and keys past
``Lkv`` of a tile are zero-filled by their copies and masked, with no
padded copy of q, k or v.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.common import count_kernel, on_cpu, on_meta, raise_on

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)   # the kernels' instantiations
WGMMA_HEAD_DIMS = (64, 128, 256)             # bf16 on wgmma; the rest on mma.sync
# the kernels, in the order of the C entry point's `route` argument
ROUTES = ("flash_tf32_kernel", "flash_mma_kernel", "flash_wgmma_kernel")
NUM_SMS = 132          # an H100 SXM's SMs: the plan's count off the card
# the kernels' limits on a plan, which the C entry point checks
SPLIT_ALIGN = 128      # a chunk is a multiple of every kernel's kv tile
MAX_SPLIT = 32         # the combine kernel weighs one chunk per lane


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


def route(hd: int, dtype) -> str:
    """The kernel that computes a call at head dim ``hd`` in ``dtype``
    (``torch.bfloat16`` / ``torch.float32`` or their names): a fixed rule,
    the one place it is made (the C entry point takes its index in
    ``ROUTES``)."""
    name = str(dtype).removeprefix("torch.")
    if hd not in HEAD_DIMS or name not in ("bfloat16", "float32"):
        raise ValueError(f"no kernel for head dim {hd} in {name}")
    if name == "float32":
        return "flash_tf32_kernel"
    return "flash_wgmma_kernel" if hd in WGMMA_HEAD_DIMS else "flash_mma_kernel"


def rows_per_block(hd: int, dtype) -> int:
    """Folded (position, head-in-group) rows of one block of the route
    (the kernels' ``kRows`` / ``kMmaRows``), which ``split_plan`` counts."""
    return 128 if route(hd, dtype) == "flash_wgmma_kernel" else 64


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors a call's plan fills: the card's own
    count for a CUDA device, else ``NUM_SMS``."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return NUM_SMS


def split_plan(b: int, lq: int, lkv: int, hq: int, hkv: int, hd: int, dtype, *,
               causal: bool = True, num_sms: int = NUM_SMS) -> tuple[int, int]:
    """``(n_split, chunk)`` of a call, from its shape and the card's
    ``num_sms`` alone. The grid is ``row tiles × Hkv × B`` blocks of
    ``rows_per_block``; when that fills under half of ``num_sms`` and no
    causal mask applies, the keys split into chunks of a multiple of
    ``SPLIT_ALIGN`` keys, at least two tiles of 128, enough for about one
    block an SM and at most ``MAX_SPLIT``; the last chunk runs to Lkv.
    Under a causal mask (no position offset) a call's live keys never
    outnumber its queries, so its row tiles already spread them, unevenly,
    and the merge's traffic costs more than the chunks gain: it does not
    split. A window does not enter: a window's rows together see every
    key. ``(1, Lkv)``: no split. The C entry point refuses a plan outside
    ``SPLIT_ALIGN`` and ``MAX_SPLIT``; it makes none of its own."""
    blocks = -(-lq * (hq // hkv) // rows_per_block(hd, dtype)) * hkv * b
    if causal or 2 * blocks > num_sms:
        return 1, lkv
    want = min(-(-num_sms // blocks), MAX_SPLIT)
    chunk = max(2 * SPLIT_ALIGN, -(-lkv // (want * SPLIT_ALIGN)) * SPLIT_ALIGN)
    n = -(-lkv // chunk)
    return (n, chunk) if n > 1 else (1, lkv)


def split_chunks(lkv: int, n_split: int, chunk: int) -> list[tuple[int, int]]:
    """The key ranges ``[lo, hi)`` of a plan: chunk c is ``[c·chunk, (c +
    1)·chunk)``, the last one ``[(n - 1)·chunk, Lkv)``."""
    return [(c * chunk, lkv if c == n_split - 1 else (c + 1) * chunk)
            for c in range(n_split)]


def flash_attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool = True, window: int | None = None,
                              chunks: list | None = None) -> torch.Tensor:
    """The split and its merge in plain torch: per key range ``[lo, hi)``
    of ``chunks`` (default: the call's ``split_plan`` on q's device) the
    chunk's masked fp32 scores, m_c = their row max, p = exp(s - m_c)
    zeroed where masked (rounded to bf16 for bf16 inputs), l_c = Σp, acc_c
    = p·v; then M = max m_c, out = Σ e^(m_c - M)·acc_c / max(Σ e^(m_c -
    M)·l_c, 1e-30), as ``flash_combine_kernel`` merges them. A chunk where a row has no live
    key has m_c = -1e30 and weighs 0; a row with none at all is 0."""
    b, lq, hq, hd = q.shape
    lkv, n_kv = k.shape[1], k.shape[2]
    if chunks is None:
        chunks = split_chunks(lkv, *split_plan(b, lq, lkv, hq, n_kv, hd, q.dtype,
                                               causal=causal, num_sms=sm_count(q.device)))
    qg = q.reshape(b, lq, n_kv, hq // n_kv, hd).float()
    mask = _mask(lq, lkv, causal, window, q.device)
    parts = []
    for lo, hi in chunks:
        s = torch.einsum("blkgd,bmkd->bkglm", qg, k[:, lo:hi].float()) / math.sqrt(hd)
        mk = mask[:, lo:hi]
        s = torch.where(mk, s, NEG_INF)
        m = s.amax(dim=-1)                                       # (B, Hkv, G, Lq)
        p = torch.exp(s - m[..., None]) * mk
        if q.dtype == torch.bfloat16:
            p = p.to(torch.bfloat16).float()
        acc = torch.einsum("bkglm,bmkd->bkgld", p, v[:, lo:hi].float())
        parts.append((m, p.sum(dim=-1), acc))
    big = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    den = torch.zeros_like(big)
    out = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.exp(m - big)
        den = den + w * l
        out = out + w[..., None] * acc
    out = out / den.clamp_min(1e-30)[..., None]                  # (B, Hkv, G, Lq, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, lq, hq, hd).to(q.dtype)


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
    Hq, hd)`` in q's dtype. On the card the kernel is ``route(hd,
    dtype)``, with the kv split of ``split_plan``."""
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes a contiguous tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernels' 16-byte copies and TMA boxes need a "
                             "16-byte aligned start")
    n_split, chunk = split_plan(b, lq, lkv, hq, hkv, hd, q.dtype, causal=causal,
                                num_sms=sm_count(q.device))
    out = torch.empty_like(q)
    part = ml = None
    if n_split > 1:
        rows = lq * (hq // hkv)
        part = torch.empty((n_split, b, hkv, rows, hd), dtype=torch.float32,
                           device=q.device)
        ml = torch.empty((n_split, b, hkv, rows, 2), dtype=torch.float32, device=q.device)
    lib = load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    raise_on(lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), None if ml is None else ml.data_ptr(),
        b, lq, lkv, hq, hkv, hd, int(causal), -1 if window is None else int(window),
        ROUTES.index(route(hd, q.dtype)), n_split, chunk, stream), "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
