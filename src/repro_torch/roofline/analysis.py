"""Roofline terms of a dry-run step, counted on the meta device (no card
needed): the JAX package's ``roofline/analysis.py`` for the port.

compute term    = FLOPs a chip / PEAK_FLOPS_BF16
memory term     = bytes a chip / HBM_BW
collective term = collective bytes a chip / ICI_BW (NVLink 4, a direction)

at the H100 constants of ``launch/mesh.py``. JAX reads its counts from
the compiled program (``cost_analysis()`` and the optimized HLO's
collectives); the port has no compiled program, so ``count_work`` counts
one rank's share of the step as it runs on meta tensors:

- **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode`` over the aten
  ops (matmuls, attention einsums, convolutions, under autograd their
  backward too), plus each kernel's reckoned FLOPs (``kernel_work``):
  on meta operands a kernel wrapper returns a meta output and adds its
  work here (``kernels/common.py``), so kernels 1–9 count once each, at
  their own reckoning, never through their plain versions.
- **bytes**: every aten op's operands read once and its results written
  once (a view, and an allocation that writes nothing, is free; an
  expanded operand counts its storage), plus each kernel's reckoned
  bytes: the bytes an eager op-by-op run moves, with no fusion and no
  cache reuse.
- **collective bytes by kind**, per chip: what ``counting_collectives``,
  the dry-run's stand-in for ``torch.distributed``, saw: all-gather (the
  gathered output), all-reduce (the tensor) and collective-permute (the
  bytes received by the send/recv schedule of
  ``launch/steps.make_ppermute_gossip_mix``), as JAX sums each
  collective's output operand; reduce-scatter and all-to-all stay 0 (no
  step of the port calls them).

``kernel_work`` is the one reckoning of kernel work: the dry-run's counts
and ``chip_smoke.py``'s ``bound_ms`` (through ``kernel_bound``) both
read it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_FP32

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# --------------------------------------------------------------------------
# The one reckoning of kernel work
# --------------------------------------------------------------------------


def live_pairs(lq: int, lkv: int, causal: bool = True, window: Optional[int] = None) -> int:
    """The (query, key) pairs kernel 8 computes: key k < Lkv sees query q
    when ``k <= q`` (causal) and ``q - k < window`` (a window), positions
    the plain row indices of q and k."""
    q = np.arange(lq, dtype=np.int64)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(lq, np.int64)
    hi = np.minimum(q, lkv - 1) if causal else np.full(lq, lkv - 1, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def kernel_work(kernel: str, **k) -> tuple[int, int]:
    """(FLOPs, bytes) of one call of a kernel at ``shape``: each input
    read once, each output written once. The shapes, by kernel:

    - ``gossip_mix_flat`` n, x; ``gossip_mix_stack`` s, n, x;
      ``gossip_mix_fused_dp`` n, x, noise (σ > 0);
    - ``gossip_mix_dequant`` / ``mixture_mix_dequant4`` m (output rows),
      n (plane rows), xp (padded width), qblock;
    - ``gossip_mix_sparse`` n, x, live (the columns this run's masks
      keep); ``gossip_mix_dequant_masked`` m, n, xp, qblock, live, width
      (the logical X);
    - ``flash_attention`` b, lq, lkv, hq, hkv, hd, causal, window, dtype:
      4·B·Hq·hd FLOPs a live (q, k) pair (q·k and p·v);
    - ``ssd_scan`` b, l, h, g, p, n, chunk, dtype, state: per (batch,
      chunk, head) the chunked dual form's four products, C·Bᵀ and (C·Bᵀ
      ⊙ L)·(x·dt) over the Q(Q+1)/2 causal pairs, C·S_in and the chunk
      state over Q·P·N each.

    The mixes are fp32; 8 and 9 read and write ``dtype``."""
    if kernel == "gossip_mix_flat":
        n, x = k["n"], k["x"]
        return 2 * n * n * x, 4 * (n * n + 2 * n * x)
    if kernel == "gossip_mix_stack":
        s, n, x = k["s"], k["n"], k["x"]
        return 2 * s * n * n * x, 4 * (n * n + 2 * s * n * x)
    if kernel == "gossip_mix_fused_dp":
        n, x, noise = k["n"], k["x"], k.get("noise", True)
        return (2 * n * n * x + n * x * (5 if noise else 3),
                4 * (n * n + n + 3 * n * x + (n * x if noise else 0)))
    if kernel in ("gossip_mix_dequant", "mixture_mix_dequant4"):
        m, n, xp, qb = k["m"], k["n"], k["xp"], k["qblock"]
        plane = n * xp if kernel == "gossip_mix_dequant" else n * xp // 2
        return 2 * m * n * xp, 4 * m * n + plane + 4 * n * xp // qb + 4 * m * xp
    if kernel == "gossip_mix_sparse":
        # W, the activity vector, the live columns of C, the whole output
        n, x, live = k["n"], k["x"], k["live"]
        return 2 * n * n * live, 4 * (n * n + x + n * live + n * x)
    if kernel == "gossip_mix_dequant_masked":
        # the payload, scales and fp32 mask on the live columns, an
        # activity vector over the width, the whole (M, Xp) output
        m, n, xp, qb, live, width = (k["m"], k["n"], k["xp"], k["qblock"], k["live"],
                                     k["width"])
        return (2 * m * n * live,
                4 * m * n + n * live + 4 * n * live // qb + 4 * n * live + 4 * width
                + 4 * m * xp)
    if kernel == "flash_attention":
        b, lq, lkv, hq, hkv, hd = k["b"], k["lq"], k["lkv"], k["hq"], k["hkv"], k["hd"]
        size = 2 if k.get("dtype", "float32") == "bfloat16" else 4
        live = live_pairs(lq, lkv, k.get("causal", True), k.get("window"))
        return 4 * b * hq * hd * live, size * (2 * b * lq * hq * hd + 2 * b * lkv * hkv * hd)
    if kernel == "ssd_scan":
        b, l, h, g, p, n, q = k["b"], k["l"], k["h"], k["g"], k["p"], k["n"], k["chunk"]
        size = 2 if k.get("dtype", "float32") == "bfloat16" else 4
        nbytes = (size * (2 * b * l * h * p + 2 * b * l * g * n) + 4 * (b * l * h + h)
                  + 4 * b * h * p * n * (2 if k.get("state") else 1))
        pairs = q * (q + 1) // 2
        return b * (l // q) * h * (2 * pairs * (n + p) + 4 * q * p * n), nbytes
    raise ValueError(f"unknown kernel {kernel!r}")


def kernel_bound(kernel: str, **shape) -> tuple[float, str]:
    """(least ms, "bytes" | "operations") of one call: ``kernel_work``'s
    bytes over HBM_BW or its FLOPs over the peak of its type (bf16 on the
    tensor cores for a bf16 ``dtype``, else fp32 outside them), the
    larger."""
    flops, nbytes = kernel_work(kernel, **shape)
    peak = PEAK_FLOPS_BF16 if shape.get("dtype") == "bfloat16" else PEAK_FLOPS_FP32
    t_bytes, t_ops = nbytes / HBM_BW, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------
# Counting a step on the meta device
# --------------------------------------------------------------------------


def _nbytes(t: torch.Tensor) -> int:
    """A tensor's bytes as read: its storage when it is smaller than the
    view (an expanded operand)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _free_ops():
    aten = torch.ops.aten
    return {aten.empty.memory_format, aten.empty_like.default, aten.empty_strided.default,
            aten.new_empty.default, aten.new_empty_strided.default}


class _ByteCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Sums every aten op's operand and result bytes (views and bare
    allocations free)."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.free = _free_ops()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self.free or getattr(func, "is_view", False):
            return out
        flat = torch.utils._pytree.tree_leaves((args, kwargs, out))
        self.total += sum(_nbytes(t) for t in flat if isinstance(t, torch.Tensor))
        return out


class count_work:
    """``with count_work() as w:`` counts what runs inside: ``w.flops``,
    ``w.bytes``, ``w.coll`` (bytes by collective kind, ``count``,
    ``total``) and ``w.kernels`` (name -> launches, FLOPs, bytes of the
    kernels whose wrappers saw meta operands)."""

    def __init__(self):
        self.kernels: dict = {}
        self.coll = {k: 0 for k in _COLLECTIVES}
        self.coll["count"] = 0
        self._flop_mode = None
        self._bytes = _ByteCounter()

    def add_kernel(self, name: str, flops: int, nbytes: int) -> None:
        n, f, b = self.kernels.get(name, (0, 0, 0))
        self.kernels[name] = (n + 1, f + flops, b + nbytes)

    def add_collective(self, kind: str, nbytes: int) -> None:
        self.coll[kind] += int(nbytes)
        self.coll["count"] += 1

    @property
    def flops(self) -> int:
        return int(self._flop_mode.get_total_flops()) + sum(f for _, f, _ in
                                                            self.kernels.values())

    @property
    def bytes(self) -> int:
        return self._bytes.total + sum(b for _, _, b in self.kernels.values())

    @property
    def coll_total(self) -> int:
        return sum(self.coll[k] for k in _COLLECTIVES)

    def __enter__(self):
        from torch.utils.flop_counter import FlopCounterMode

        from repro_torch.kernels import common

        self._flop_mode = FlopCounterMode(display=False)
        self._flop_mode.__enter__()
        self._bytes.__enter__()
        common.COUNTERS.append(self)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import common

        common.COUNTERS.remove(self)
        self._bytes.__exit__(*exc)
        self._flop_mode.__exit__(*exc)
        return False


class _Done:
    def wait(self):
        return True


@contextlib.contextmanager
def counting_collectives(counter: count_work, world: int):
    """The dry-run's stand-in for ``torch.distributed``: inside the block
    the collectives the port's steps call (``all_gather``, ``all_reduce``,
    ``batch_isend_irecv`` of ``P2POp``\\ s) record their bytes in ``counter`` and move
    nothing, leaving their meta outputs as they are; the process-group
    queries answer for rank 0 of a world of ``world`` ranks. Each raises
    on a tensor that is not on the meta device. Only the dry-run installs
    it."""
    import torch.distributed as dist

    def meta(*ts):
        for t in ts:
            if t.device.type != "meta":
                raise RuntimeError(
                    f"the dry-run's collective stand-in takes meta tensors only, got "
                    f"one on {t.device}")

    def isend(*a, **k):
        raise RuntimeError("the dry-run's isend marks a P2POp; it sends nothing")

    def irecv(*a, **k):
        raise RuntimeError("the dry-run's irecv marks a P2POp; it receives nothing")

    class P2POp:
        def __init__(self, op, tensor, peer=None, group=None, tag=0, group_peer=None):
            meta(tensor)
            self.op, self.tensor = op, tensor

    def batch_isend_irecv(ops):
        for o in ops:
            if o.op is irecv:
                counter.add_collective("collective-permute", _nbytes(o.tensor))
        return [_Done() for _ in ops]

    def all_gather(parts, t, group=None, async_op=False):
        meta(t, *parts)
        counter.add_collective("all-gather", sum(_nbytes(p) for p in parts))

    def all_reduce(t, op=None, group=None, async_op=False):
        meta(t)
        counter.add_collective("all-reduce", _nbytes(t))

    stand_in = {
        "isend": isend, "irecv": irecv, "P2POp": P2POp,
        "batch_isend_irecv": batch_isend_irecv, "all_gather": all_gather,
        "all_reduce": all_reduce,
        "get_world_size": lambda group=None: world, "get_rank": lambda group=None: 0,
        "is_initialized": lambda: True,
        "new_group": lambda ranks=None, **kw: ("dry-run group", tuple(ranks or ())),
    }
    saved = {name: getattr(dist, name) for name in stand_in}
    for name, fn in stand_in.items():
        setattr(dist, name, fn)
    try:
        yield counter
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


# --------------------------------------------------------------------------
# The roofline row
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    step_kind: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_breakdown: dict
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float          # 6·N_active·D (global)
    useful_ratio: float         # MODEL_FLOPS / global FLOPs (chips × a chip's)
    peak_fraction: float        # compute_s / max(term)
    memory_per_chip: Optional[dict] = None
    note: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def dominant_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def analyze(*, arch: str, shape: str, step_kind: str, mesh_name: str, chips: int,
            counts: count_work, model_flops: float = 0.0, memory: Optional[dict] = None,
            note: str = "") -> Roofline:
    """The roofline row of one rank's share of a step, from ``counts``
    (a finished ``count_work``, per chip); ``memory`` the chip's argument
    and output bytes (the counterpart of JAX's ``memory_analysis``)."""
    flops, bytes_acc = float(counts.flops), float(counts.bytes)
    coll = dict(counts.coll)
    coll["total"] = counts.coll_total
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = bytes_acc / HBM_BW
    collective_s = coll["total"] / ICI_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    global_flops = flops * chips
    dom = max(terms.values())
    return Roofline(
        arch=arch, shape=shape, step_kind=step_kind, mesh=mesh_name, chips=chips,
        flops_per_chip=flops, bytes_per_chip=bytes_acc,
        coll_bytes_per_chip=float(coll["total"]), coll_breakdown=coll,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck, model_flops=model_flops,
        useful_ratio=(model_flops / global_flops) if global_flops else 0.0,
        peak_fraction=(compute_s / dom) if dom > 0 else 0.0,
        memory_per_chip=memory, note=note,
    )


def model_flops_for(cfg, shape, step_kind: str) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); decode counts one
    token per request, forward-only shapes use 2·N·D."""
    from repro_torch.models.registry import active_params

    n_active = active_params(cfg)
    if cfg.family == "audio":
        # whisper: prefill runs the ENCODER over 1500 stub frames (+ cross-KV
        # projections), decode/train run the decoder; approximate per-branch
        d_enc = cfg.encoder_d_model or cfg.d_model
        enc_p = cfg.encoder_layers * (4 * d_enc * d_enc + 2 * d_enc * cfg.d_ff)
        dec_p = n_active - enc_p
        if step_kind == "prefill":
            return 2.0 * enc_p * shape.global_batch * cfg.encoder_frames
        if step_kind == "decode":
            return 2.0 * dec_p * shape.global_batch
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * dec_p * tokens + 2.0 * enc_p * shape.global_batch * cfg.encoder_frames
    if step_kind in ("fedspd", "plain"):
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if step_kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    if step_kind == "decode":
        return 2.0 * n_active * shape.global_batch  # one token each
    raise ValueError(step_kind)


def format_table(rows: list[Roofline]) -> str:
    hdr = (
        f"{'arch':24s} {'shape':12s} {'step':8s} {'mesh':10s} "
        f"{'compute_s':>10s} {'memory_s':>10s} {'coll_s':>10s} "
        f"{'bottleneck':>10s} {'useful':>7s}"
    )
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:24s} {r.shape:12s} {r.step_kind:8s} {r.mesh:10s} "
            f"{r.compute_s:10.3e} {r.memory_s:10.3e} {r.collective_s:10.3e} "
            f"{r.bottleneck:>10s} {r.useful_ratio:7.3f}"
        )
    return "\n".join(lines)


def save_rows(rows: list[Roofline], path: str) -> None:
    with open(path, "w") as f:
        json.dump([r.to_json() for r in rows], f, indent=1)


# --------------------------------------------------------------------------
# Two-point trip-count correction
# --------------------------------------------------------------------------
#
# JAX's cost analysis counts a while-loop body once whatever its trip
# count, so its dry-run compiles each case at scan_unroll=1 and 2 and
# extrapolates exact = m1 + r·(m2 − m1). The port's layer stacks are
# Python loops: one count on the meta device covers every layer, so there
# is nothing to extrapolate and no analyze_two_point. scan_trip_ratio and
# two_point stay, equal to JAX's, and a test holds the count of a 6-layer
# model to two_point of its 1- and 2-layer counts.


def scan_trip_ratio(cfg) -> float:
    """r for the two-point correction, derived from the arch's scan sites."""
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import segment_sizes

        sizes = segment_sizes(cfg)
        return (sum(sizes) - len(sizes)) / len(sizes)
    if cfg.family == "audio":
        # sites: encoder scan (enc_layers) + decoder scan (n_layers)
        total = cfg.encoder_layers + cfg.n_layers
        return (total - 2) / 2
    return float(cfg.n_layers - 1)


def two_point(v1: float, v2: float, r: float) -> float:
    return max(v1, v1 + r * (v2 - v1))
