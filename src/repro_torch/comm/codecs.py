"""Quantized wire codecs for the packed parameter plane: the subset that
ships a plane.

The JAX package's ``comm/codecs.py`` for the ``int8`` and ``int4``
codecs: per-block scales along the flat X axis (``max|x| / qmax`` per
``block`` columns), rounding ``"nearest"`` (``floor(y + 1/2)``, what a
one-time export uses) or ``"stochastic"`` (``floor(y + u)``, u uniform in
[0, 1), unbiased), and the exact wire image of an encoded batch
(``Channel.serialize_payload``): int8 quanta as raw bytes, or int4 as
paired two's-complement nibbles (element 2i in the low nibble), followed
by the scales in fp32 (int8) or fp16 (int4). The bytes equal the JAX
package's for the same input, so an artifact written by either package
loads in the other.

Stochastic rounding takes its uniform draw as a ``torch.Generator`` or as
an injected tensor of the blocked shape ``(..., Xp / block, block)``, so
a test can feed both packages the same draw.

Not ported yet (each raises ``ValueError`` naming itself): the ``topk``
codec, error feedback (``init_residual``, ``encode_stream``,
``split_ef``/``join_ef``), ``exchange``, ``make_channel`` and
``sparse_wire_model_bytes``. They arrive with the comm slice, when
``RunConfig.comm`` runs the round's exchange through the codecs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

CODECS = ("fp32", "int8", "int4")


def _unported(what: str):
    raise ValueError(
        f"{what} is not ported yet; the port's comm/codecs.py has the "
        "plane-shipping subset (int8/int4 quantization and its wire format)")


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Communication-compression knob: ``codec`` and ``block``, the
    quantization-scale granularity along X (one scale per block)."""

    codec: str = "fp32"
    block: int = 256
    k: Optional[int] = None
    error_feedback: bool = False

    def __post_init__(self):
        if self.codec == "topk":
            _unported("codec 'topk' (top-k sparsification)")
        if self.codec not in CODECS:
            raise ValueError(
                f"unknown codec {self.codec!r}; expected one of {CODECS}")
        if self.block <= 0:
            raise ValueError(f"block must be positive, got {self.block}")
        if self.k is not None:
            _unported("CommConfig.k (top-k sparsification)")
        if self.error_feedback:
            _unported("CommConfig.error_feedback (error-feedback residuals)")


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


def topk_encode(x, k):
    _unported("topk_encode (the topk codec)")


def topk_decode(enc, *, x_width):
    _unported("topk_decode (the topk codec)")


@dataclasses.dataclass(frozen=True)
class Channel:
    """One quantized codec bound to a flat message width X.
    ``wire_model_bytes`` is the exact physical payload of one message:
    what ``serialize_payload`` emits per row."""

    cfg: CommConfig
    x: int  # logical flat message width

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
        return int(-(-self.x // 2) + self.scale_bytes)   # int4: paired nibbles

    def encode(self, x: torch.Tensor, key=None, *,
               rounding: str = "stochastic") -> dict:
        c = self.cfg
        if c.codec not in ("int8", "int4"):
            raise ValueError(f"codec {c.codec!r} has no encoded form")
        return quant_encode(x, key, bits=_quant_bits(c.codec), block=c.block,
                            scale_dtype=self.scale_wire_dtype,
                            rounding=rounding)

    def decode(self, enc: dict) -> torch.Tensor:
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

    def init_residual(self, batch_prefix: tuple):
        _unported("Channel.init_residual (error feedback)")

    def encode_stream(self, x, key, ef, *, need_hat: bool = False):
        _unported("Channel.encode_stream (error feedback)")


def sparse_wire_model_bytes(cfg, x, k_active):
    _unported("sparse_wire_model_bytes (sparse wire accounting)")


def make_channel(cfg, x_width):
    _unported("make_channel (codecs in the round's exchange)")


def split_ef(state, channel):
    _unported("split_ef (error feedback)")


def join_ef(x, ef, channel):
    _unported("join_ef (error feedback)")


def exchange(channel, x, mix, key, ef):
    _unported("exchange (codecs in the round's exchange)")
