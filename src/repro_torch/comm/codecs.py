"""Wire codecs for the packed parameter plane: what crosses an edge when
a round exchanges its ``(N, X)`` slab, and the exact bytes it costs.

The JAX package's ``comm/codecs.py``:

- ``fp32``: the uncompressed exchange; ``make_channel`` returns ``None``
  for it, so every call site keeps its uncompressed code path.
- ``int8`` / ``int4``: per-block scales along the flat X axis
  (``max|x| / qmax`` per ``block`` columns), rounding ``"nearest"``
  (``floor(y + 1/2)``, what a one-time export uses) or ``"stochastic"``
  (``floor(y + u)``, u uniform in [0, 1), unbiased). The wire image of an
  encoded batch (``Channel.serialize_payload``) is int8 quanta as raw
  bytes, or int4 as paired two's-complement nibbles (element 2i in the
  low nibble), followed by the scales in fp32 (int8) or fp16 (int4). The
  bytes equal the JAX package's for the same input, so an artifact
  written by either package loads in the other.
- ``topk``: the k largest-|x| entries of each message as (value, index)
  pairs, 8k bytes; ties go to the lower index, as ``jax.lax.top_k``
  breaks them, on the CPU and on the card alike.

Error feedback: the channel carries a per-client residual e; each round
sends encode(x + e) and keeps e' = (x + e) − decode(encode(x + e)).

Stochastic rounding takes its uniform draw as a ``torch.Generator`` or as
an injected tensor of the blocked shape ``(..., Xp / block, block)``, so
a test can feed both packages the same draw.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.sparse import top_k

CODECS = ("fp32", "int8", "int4", "topk")


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Communication-compression knob (``RunConfig(comm=...)``).

    ``block`` is the quantization-scale granularity along X (one scale per
    block); ``k`` the survivors per message for ``topk`` (default X // 16);
    ``error_feedback`` carries the residual through the round loop."""

    codec: str = "fp32"
    block: int = 256
    k: Optional[int] = None
    error_feedback: bool = False

    def __post_init__(self):
        if self.codec not in CODECS:
            raise ValueError(
                f"unknown codec {self.codec!r}; expected one of {CODECS}")
        if self.block <= 0:
            raise ValueError(f"block must be positive, got {self.block}")
        if self.k is not None and self.k <= 0:
            raise ValueError(f"k must be positive, got {self.k}")


def _quant_bits(codec: str) -> int:
    return {"int8": 8, "int4": 4}[codec]


def _pad_width(x_width: int, block: int) -> tuple[int, int]:
    nq = -(-x_width // block)
    return nq, nq * block


def quant_encode(x: torch.Tensor, key=None, *, bits: int, block: int,
                 scale_dtype: torch.dtype = torch.float32,
                 rounding: str = "stochastic") -> dict:
    """x ``(..., X)`` -> {"q": ``(..., Xp)`` int8, "scale": ``(..., Xp/block)``
    fp32}, Xp = X padded up to whole blocks (the tail quantizes to exact
    zeros). ``scale_dtype`` rounds the scales through a narrower wire
    dtype (int4 ships fp16) before the division, so a receiver that
    decodes the serialized payload gets these values bit for bit.
    ``key``: for ``rounding="stochastic"``, a ``torch.Generator`` or the
    uniform draw itself, shape ``(..., Xp/block, block)``; unused for
    ``"nearest"``."""
    x_width = x.shape[-1]
    nq, xp = _pad_width(x_width, block)
    qmax = float(2 ** (bits - 1) - 1)
    xb = F.pad(x.float(), (0, xp - x_width)).reshape(x.shape[:-1] + (nq, block))
    scale = xb.abs().amax(dim=-1) / qmax                   # (..., nq)
    if scale_dtype != torch.float32:
        scale = scale.to(scale_dtype).float()
    y = xb / scale.clamp_min(1e-12)[..., None]             # |y| <= qmax
    if rounding == "nearest":
        u = 0.5
    elif rounding == "stochastic":
        if isinstance(key, torch.Generator):
            u = torch.rand(xb.shape, generator=key, device=x.device)
        elif isinstance(key, torch.Tensor):
            u = key.to(device=x.device, dtype=torch.float32).reshape(xb.shape)
        else:
            raise ValueError(
                "stochastic rounding needs key= (a torch.Generator or the "
                f"uniform draw of shape {tuple(xb.shape)})")
    else:
        raise ValueError(f"unknown rounding {rounding!r}")
    q = torch.floor(y + u).clamp(-qmax, qmax).to(torch.int8)
    return {"q": q.reshape(x.shape[:-1] + (xp,)), "scale": scale}


def quant_decode(enc: dict, *, block: int, x_width: int) -> torch.Tensor:
    q, scale = enc["q"], enc["scale"]
    xb = q.reshape(q.shape[:-1] + (scale.shape[-1], block))
    out = xb.float() * scale[..., None].float()
    return out.reshape(q.shape)[..., :x_width]


def int4_pack(q: torch.Tensor) -> torch.Tensor:
    """``(..., W)`` int8 values in [-8, 7] -> ``(..., ceil(W/2))`` uint8:
    element 2i in the low nibble and 2i+1 in the high one, both as
    two's-complement 4-bit values; an odd width pads one zero nibble."""
    q = torch.as_tensor(q)
    if q.shape[-1] % 2:
        q = F.pad(q, (0, 1))
    nib = q.to(torch.int32) & 0xF
    return (nib[..., 0::2] | (nib[..., 1::2] << 4)).to(torch.uint8)


def int4_unpack(packed: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of ``int4_pack``: ``(..., ceil(W/2))`` uint8 -> ``(..., W)``
    int8."""
    p = torch.as_tensor(packed).to(torch.int32)
    v = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1)
    v = v.reshape(p.shape[:-1] + (2 * p.shape[-1],))
    v = v - 16 * (v > 7).to(torch.int32)
    return v[..., :width].to(torch.int8)


def topk_encode(x: torch.Tensor, k: int) -> dict:
    """x ``(..., X)`` -> {"v": ``(..., k)`` fp32, "i": ``(..., k)`` int32}:
    the k largest |x| per message, ties to the lower index."""
    x = x.float()
    idx = top_k(x.abs(), k)
    return {"v": torch.gather(x, -1, idx), "i": idx.to(torch.int32)}


def topk_decode(enc: dict, *, x_width: int) -> torch.Tensor:
    """Scatter the (value, index) pairs into zeros of width ``x_width``."""
    v = enc["v"].float()
    out = torch.zeros(v.shape[:-1] + (x_width,), dtype=torch.float32,
                      device=v.device)
    return out.scatter_(-1, enc["i"].long(), v)


@dataclasses.dataclass(frozen=True)
class Channel:
    """One codec bound to a flat message width X. ``wire_model_bytes`` is
    the exact physical payload of one message (for int8/int4: what
    ``serialize_payload`` emits per row). ``fused`` marks the codecs whose
    encoded payload the fused dequantize+mix kernel reads directly."""

    cfg: CommConfig
    x: int  # logical flat message width

    @property
    def has_ef(self) -> bool:
        return self.cfg.error_feedback

    @property
    def fused(self) -> bool:
        return self.cfg.codec in ("int8", "int4")

    @property
    def k(self) -> int:
        return self.cfg.k if self.cfg.k is not None else max(1, self.x // 16)

    @property
    def scale_wire_dtype(self) -> torch.dtype:
        """The scales' wire dtype: fp16 for int4, fp32 otherwise. Encode
        rounds through it, so device and wire decodes agree bit for bit."""
        return torch.float16 if self.cfg.codec == "int4" else torch.float32

    @property
    def scale_bytes(self) -> int:
        """Per-message scale payload: one scale per quantization block."""
        nq, _ = _pad_width(self.x, self.cfg.block)
        return int(torch.empty((), dtype=self.scale_wire_dtype).element_size() * nq)

    @property
    def wire_model_bytes(self) -> int:
        c = self.cfg
        if c.codec == "fp32":
            return 4 * self.x
        if c.codec == "int8":
            return int(self.x + self.scale_bytes)
        if c.codec == "int4":
            return int(-(-self.x // 2) + self.scale_bytes)   # paired nibbles
        return int(8 * min(self.k, self.x))  # topk: fp32 value + int32 index

    def wire_ratio(self, logical_model_bytes: int) -> float:
        """Wire over logical bytes per message (exact, static per model)."""
        return self.wire_model_bytes / float(logical_model_bytes)

    def encode(self, x: torch.Tensor, key=None, *,
               rounding: str = "stochastic") -> dict:
        """int8/int4: ``key`` is the stochastic rounding's draw (see
        ``quant_encode``); topk takes none."""
        c = self.cfg
        if c.codec in ("int8", "int4"):
            return quant_encode(x, key, bits=_quant_bits(c.codec),
                                block=c.block,
                                scale_dtype=self.scale_wire_dtype,
                                rounding=rounding)
        if c.codec == "topk":
            return topk_encode(x, min(self.k, self.x))
        raise ValueError(f"codec {c.codec!r} has no encoded form")

    def decode(self, enc: dict) -> torch.Tensor:
        if self.cfg.codec == "topk":
            return topk_decode(enc, x_width=self.x)
        return quant_decode(enc, block=self.cfg.block, x_width=self.x)

    def serialize_payload(self, enc: dict) -> bytes:
        """The exact wire/disk image of an encoded message batch: the
        quanta (int4: paired nibbles, int8: raw bytes) cropped to the
        logical width X, then the per-block scales in
        ``scale_wire_dtype``. ``len(...) == n_messages ×
        wire_model_bytes``."""
        c = self.cfg
        if c.codec not in ("int8", "int4"):
            raise ValueError(
                f"codec {c.codec!r} has no plane wire format (quantized "
                "codecs only)")
        q = torch.as_tensor(enc["q"]).detach().cpu()[..., : self.x]
        sc = torch.as_tensor(enc["scale"]).detach().cpu().to(self.scale_wire_dtype)
        payload = int4_pack(q) if c.codec == "int4" else q.to(torch.int8)
        return (np.ascontiguousarray(payload.numpy()).tobytes()
                + np.ascontiguousarray(sc.numpy()).tobytes())

    def deserialize_payload(self, data: bytes, batch_prefix: tuple = ()) -> dict:
        """Inverse of ``serialize_payload`` for a ``batch_prefix``-shaped
        message batch: {"q" int8 padded to whole scale blocks, "scale"
        fp32}, CPU tensors, such that ``decode`` of it equals ``decode``
        of the encoding that was serialized, bit for bit."""
        c = self.cfg
        nq, xp = _pad_width(self.x, c.block)
        batch = tuple(int(b) for b in batch_prefix)
        n_msgs = int(np.prod(batch)) if batch else 1
        if len(data) != n_msgs * self.wire_model_bytes:
            raise ValueError(
                f"payload is {len(data)} bytes; {batch} × "
                f"{self.cfg.codec} messages of width {self.x} need "
                f"{n_msgs * self.wire_model_bytes}")
        qw = -(-self.x // 2) if c.codec == "int4" else self.x
        split = n_msgs * qw
        raw = np.frombuffer(data[:split], dtype=np.uint8).reshape(batch + (qw,))
        if c.codec == "int4":
            q = int4_unpack(torch.from_numpy(raw.copy()), self.x)
        else:
            q = torch.from_numpy(raw.view(np.int8).copy())
        q = F.pad(q, (0, xp - self.x))
        wire = np.float16 if c.codec == "int4" else np.float32
        sc = np.frombuffer(data[split:], dtype=wire).reshape(batch + (nq,))
        return {"q": q, "scale": torch.from_numpy(sc.astype(np.float32))}

    def init_residual(self, batch_prefix: tuple, *,
                      device: str | torch.device) -> Optional[torch.Tensor]:
        """The error-feedback residual carried in the round loop: fp32 zeros
        of shape ``batch_prefix + (X,)`` on ``device``, or None without
        error feedback."""
        if not self.has_ef:
            return None
        return torch.zeros(tuple(batch_prefix) + (self.x,), dtype=torch.float32,
                           device=device)

    def encode_stream(self, x: torch.Tensor, key,
                      ef: Optional[torch.Tensor], *, need_hat: bool = False):
        """One channel use: returns (enc, x_hat or None, ef'). The decode
        ``x_hat`` is made only when error feedback or the caller
        (``need_hat``) needs it: the fused kernel path without error
        feedback never decodes outside the kernel."""
        msg = x.float() + ef if ef is not None else x
        enc = self.encode(msg, key)
        x_hat = self.decode(enc) if self.has_ef or need_hat else None
        if self.has_ef:
            ef = msg.float() - x_hat
        return enc, x_hat, ef

    def roundtrip(self, x: torch.Tensor, key, ef: Optional[torch.Tensor]):
        """decode(encode(x + ef)) and the residual update: what the
        receivers see, and what the sender keeps. Returns (x_hat, ef')."""
        _, x_hat, ef = self.encode_stream(x, key, ef, need_hat=True)
        return x_hat, ef


def sparse_wire_model_bytes(cfg: Optional[CommConfig], x: int,
                            k_active: int) -> int:
    """Exact bytes of one sparse (DisPFL) message: the ``k_active`` active
    values gathered into a compact run and encoded (scales cover the run,
    never dead columns), after a ``ceil(X/8)``-byte support bitmap:

    - fp32: ``4·k + ceil(X/8)``
    - int8: ``k + 4·ceil(k/block) + ceil(X/8)``
    - int4: ``ceil(k/2) + 2·ceil(k/block) + ceil(X/8)``
    - topk: ``8·min(topk_k, k)``, no bitmap (the pairs carry indices)."""
    bitmap = -(-x // 8)
    if cfg is None or cfg.codec == "fp32":
        return int(4 * k_active + bitmap)
    if cfg.codec == "int8":
        return int(k_active + 4 * -(-k_active // cfg.block) + bitmap)
    if cfg.codec == "int4":
        return int(-(-k_active // 2) + 2 * -(-k_active // cfg.block) + bitmap)
    k_top = cfg.k if cfg.k is not None else max(1, x // 16)
    return int(8 * min(k_top, k_active))


def make_channel(cfg: Optional[CommConfig], x_width: int) -> Optional[Channel]:
    """The channel for a flat message width, or None for no compression
    (``codec="fp32"`` included: the uncompressed exchange keeps its own
    code path, with no residual and no draw)."""
    if cfg is None or cfg.codec == "fp32":
        return None
    return Channel(cfg=cfg, x=int(x_width))


class WithEF(NamedTuple):
    """A bare-tensor state and its error-feedback residual, carried
    together through the round loop."""

    x: Any
    ef: Any


def split_ef(state, channel: Optional[Channel]):
    """(payload, residual) from a state that may be ``WithEF``-wrapped."""
    if channel is not None and channel.has_ef:
        return state.x, state.ef
    return state, None


def join_ef(x, ef, channel: Optional[Channel]):
    """Inverse of ``split_ef``: wrap only when the channel carries error
    feedback."""
    if channel is not None and channel.has_ef:
        return WithEF(x, ef)
    return x


def exchange(channel: Optional[Channel], x: torch.Tensor, mix, key,
             ef: Optional[torch.Tensor]):
    """The reference compressed exchange, mix(decode(encode(x + ef))):
    ``mix`` is any callable on the decoded slab. With ``channel=None`` it
    is exactly ``mix(x)``. Returns (mixed, ef')."""
    if channel is None:
        return mix(x), ef
    x_hat, ef = channel.roundtrip(x, key, ef)
    return mix(x_hat), ef
