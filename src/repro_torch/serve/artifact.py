"""Servable artifact: the ``(S, X)`` cluster plane in its shipping format.

A finished FedSPD run owns N·S cluster-center copies; a server needs the
S consensus cluster models as one ``(S, X)`` plane, the trained ``(N, S)``
mixture table, and the PackSpec identity. The artifact is the JAX
package's ``.npz`` (``checkpoint/ckpt.py``), byte for byte:

  fp32   the raw ``(S, X)`` float32 plane under ``['plane']``
  int8   the exact wire bytes of ``Channel.serialize_payload`` under
         ``['plane_wire']``: S · wire_model_bytes of int8 quanta and fp32
         per-block scales
  int4   the same at S · (ceil(X/2) + 2·nq) bytes: paired two's-complement
         nibbles and fp16 scales

Quantized planes are encoded with ``rounding="nearest"`` (a one-time
deterministic export) and load back into the forms the serving kernels
take: int8 quanta for ``gossip_mix_dequant``, bit-packed uint8 for
``mixture_mix_dequant4``. The manifest pins arch, plane shape, PackSpec
digest and codec, so a server cannot unpack a plane through the wrong
layout. An artifact written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.comm.codecs import Channel, CommConfig, int4_pack
from repro_torch.core.packing import PackSpec
from repro_torch.device import resolve_device


@dataclasses.dataclass
class ServableArtifact:
    """A loaded servable plane, already in serving form, on one device."""

    manifest: ckpt.CkptManifest
    u_table: Optional[torch.Tensor] = None       # (N, S) trained mixtures
    plane: Optional[torch.Tensor] = None         # (S, X) fp32: codec fp32
    plane_q: Optional[torch.Tensor] = None       # (S, Xp) int8 quanta
    plane_scale: Optional[torch.Tensor] = None   # (S, Xp // qblock) fp32
    plane_packed: Optional[torch.Tensor] = None  # (S, Xp // 2) uint8: int4

    @property
    def n_clusters(self) -> int:
        return int(self.manifest.need("n_clusters").n_clusters)

    @property
    def codec(self) -> str:
        return self.manifest.codec


def _host_f32(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(a, dtype=np.float32))


def save_servable(path: str, plane, spec: PackSpec, *, arch: str, u=None,
                  codec: str = "fp32", qblock: int = 64) -> ckpt.CkptManifest:
    """Write the ``(S, X)`` cluster plane (tensor on any device, or numpy)
    as a servable .npz in ``codec`` shipping form; returns the manifest
    written with it."""
    plane = _host_f32(plane)
    if plane.dim() != 2 or plane.shape[1] != spec.size:
        raise ValueError(
            f"plane {tuple(plane.shape)} is not (S, X={spec.size}) for this spec")
    s = plane.shape[0]
    tree = {}
    if u is not None:
        u = _host_f32(u)
        if u.dim() != 2 or u.shape[1] != s:
            raise ValueError(f"u table {tuple(u.shape)} is not (N, S={s})")
        tree["u"] = u.numpy()
    if codec == "fp32":
        tree["plane"] = plane.numpy()
    elif codec in ("int8", "int4"):
        ch = Channel(CommConfig(codec=codec, block=qblock), spec.size)
        wire = ch.serialize_payload(ch.encode(plane, rounding="nearest"))
        if len(wire) != s * ch.wire_model_bytes:   # the shipping-size contract
            raise AssertionError(
                f"{codec} plane is {len(wire)} bytes, not S · wire_model_bytes "
                f"= {s * ch.wire_model_bytes}")
        tree["plane_wire"] = np.frombuffer(wire, dtype=np.uint8)
    else:
        raise ValueError(f"codec {codec!r} is not a plane shipping format")
    manifest = ckpt.CkptManifest(
        kind="servable", arch=arch,
        n_clients=None if u is None else int(u.shape[0]), n_clusters=s,
        plane_shape=tuple(plane.shape), pack_digest=spec.digest, codec=codec,
        qblock=qblock if codec != "fp32" else None,
    )
    ckpt.save(path, tree, manifest=manifest)
    return manifest


def load_servable(path: str, spec: Optional[PackSpec] = None, *,
                  device: str | torch.device = "cuda") -> ServableArtifact:
    """Load a servable artifact into serving form on ``device`` (the card
    by default; raises without one unless ``device="cpu"``), checking the
    manifest (kind, plane shape, PackSpec digest) field by field."""
    dev = resolve_device(device)
    manifest = ckpt.read_manifest(path)
    manifest.check(kind="servable")
    manifest.need("arch", "n_clusters", "plane_shape", "codec")
    s, x = manifest.plane_shape
    if spec is not None:
        manifest.need("pack_digest").check(pack_digest=spec.digest)
        if x != spec.size:
            raise ValueError(f"plane width {x} != PackSpec X {spec.size}")
    like = {}
    if manifest.n_clients is not None:
        like["u"] = np.zeros((manifest.n_clients, s), np.float32)
    ch = None
    if manifest.codec == "fp32":
        like["plane"] = np.zeros((s, x), np.float32)
    else:
        manifest.need("qblock")
        ch = Channel(CommConfig(codec=manifest.codec, block=manifest.qblock), x)
        like["plane_wire"] = np.zeros((s * ch.wire_model_bytes,), np.uint8)
    tree, _ = ckpt.restore(path, like)
    art = ServableArtifact(manifest=manifest)
    if "u" in tree:
        art.u_table = torch.from_numpy(tree["u"]).to(dev)
    if manifest.codec == "fp32":
        art.plane = torch.from_numpy(tree["plane"]).to(dev)
    else:
        enc = ch.deserialize_payload(tree["plane_wire"].tobytes(), batch_prefix=(s,))
        art.plane_q = enc["q"].to(dev)
        art.plane_scale = enc["scale"].to(dev)
        if manifest.codec == "int4":
            art.plane_packed = int4_pack(enc["q"]).to(dev)
    return art
