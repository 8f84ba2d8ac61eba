"""ClusterPlaneServer: batched personalized inference off one resident plane.

FedSPD's product is Eq. (2)'s per-user soft mixture of S cluster models.
The server keeps the packed ``(S, X)`` cluster plane on the card for its
whole life and answers a batch of B requests, each a ``(S,)`` mixture row
and an input, by contracting the rows with the plane:

  fp32   ``torch.matmul(u, plane)``      (a plain product)
  int8   kernels ``gossip_mix_dequant``   (fused dequant + mix, int8 read)
  int4   kernels ``mixture_mix_dequant4`` (fused nibble unpack + dequant +
                                          mix, half a byte per parameter)

The ``(B, X)`` personalized parameters are unpacked through PackSpec views
into ``(B, ...)`` leaves and go straight into one batched forward of the
classifier (the counterpart of the JAX package's ``jax.vmap``). Each call
is one mix launch and one forward, eager; ``n_dispatches`` counts calls
and ``dequant_calls`` the calls that ran a dequant kernel.

``generate`` and ``serve_client`` decode with a language model and wait
for the LM model zoo; they, and ``bundle=``, raise ``ValueError``.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.packing import PackSpec, unpack
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels.gossip_mix import gossip_mix_dequant, mixture_mix_dequant4
from repro_torch.serve.artifact import ServableArtifact
from repro_torch.telemetry.counters import LatencyStats

_LM_ZOO = ("needs the LM model zoo (models/registry.py bundles), which is not "
           "ported yet (ROADMAP queue 1 item 16)")


class ClusterPlaneServer:
    """Serve personalized mixtures from one resident cluster plane on
    ``device`` (the card by default; raises without one unless
    ``device="cpu"``).

    Construct from a loaded artifact (``from_artifact``) or from a plane
    in one of the shipping forms. ``apply_fn`` (a batched forward such as
    smallnets' ``apply_mlp_classifier``: leaves ``(B, ...)``, inputs
    ``(B, 1, ...)``) enables ``predict``.
    """

    def __init__(self, spec: PackSpec, *, codec: str = "fp32", qblock: int = 64,
                 plane=None, plane_q=None, plane_scale=None, plane_packed=None,
                 u_table=None, bundle=None, apply_fn: Optional[Callable] = None,
                 device: str | torch.device = "cuda"):
        if bundle is not None:
            raise ValueError(f"bundle= (LM generation) {_LM_ZOO}")
        self.device = resolve_device(device)
        self.spec = spec
        self.codec = codec
        self.qblock = int(qblock)
        self.apply_fn = apply_fn
        self.u_table = None if u_table is None else self._tensor(u_table, torch.float32)
        x = spec.size
        if codec == "fp32":
            if plane is None:
                raise ValueError("codec='fp32' needs plane=(S, X)")
            self.plane = self._tensor(plane, torch.float32)
            if self.plane.dim() != 2 or self.plane.shape[1] != x:
                raise ValueError(f"plane {tuple(self.plane.shape)} is not (S, X={x})")
            self.n_clusters = int(self.plane.shape[0])
        elif codec == "int8":
            if plane_q is None or plane_scale is None:
                raise ValueError("codec='int8' needs plane_q + plane_scale")
            self.plane_q = self._tensor(plane_q, torch.int8)
            self.plane_scale = self._tensor(plane_scale, torch.float32)
            self.n_clusters = int(self.plane_q.shape[0])
        elif codec == "int4":
            if plane_packed is None or plane_scale is None:
                raise ValueError("codec='int4' needs plane_packed + plane_scale")
            self.plane_packed = self._tensor(plane_packed, torch.uint8)
            self.plane_scale = self._tensor(plane_scale, torch.float32)
            self.n_clusters = int(self.plane_packed.shape[0])
        else:
            raise ValueError(f"codec {codec!r} is not a plane shipping format")
        self.n_dispatches = 0
        self.dequant_calls = 0
        self.latency = LatencyStats()

    def _tensor(self, a, dtype: torch.dtype) -> torch.Tensor:
        """``a`` (tensor on any device, or numpy) as a contiguous tensor of
        ``dtype`` on the server's device."""
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
        return t.to(device=self.device, dtype=dtype).contiguous()

    def _timed(self, fn, batch: int):
        """Run one entry-point batch and record its latency: dispatch plus
        device completion (the device is synchronized before the clock is
        read), what a caller waits for."""
        self.n_dispatches += 1
        if self.codec != "fp32":
            self.dequant_calls += 1
        t0 = time.perf_counter()
        out = fn()
        synchronize(self.device)
        self.latency.record(time.perf_counter() - t0, batch=batch)
        return out

    @classmethod
    def from_artifact(cls, artifact: ServableArtifact, spec: PackSpec, *,
                      bundle=None, apply_fn: Optional[Callable] = None,
                      device: str | torch.device = "cuda") -> "ClusterPlaneServer":
        m = artifact.manifest
        if m.pack_digest is not None and m.pack_digest != spec.digest:
            raise ValueError(
                f"artifact pack_digest {m.pack_digest!r} != spec "
                f"{spec.digest!r} — wrong architecture for this plane")
        return cls(
            spec, codec=m.codec, qblock=m.qblock or 64, plane=artifact.plane,
            plane_q=artifact.plane_q, plane_scale=artifact.plane_scale,
            plane_packed=artifact.plane_packed, u_table=artifact.u_table,
            bundle=bundle, apply_fn=apply_fn, device=device,
        )

    # -- the Eq. (2) contraction over the resident plane ------------------

    def _mix(self, u: torch.Tensor) -> torch.Tensor:
        """``(B, S)`` mixture weights -> ``(B, X)`` personalized flat
        params (a view cropped from the kernels' ``(B, Xp)``)."""
        if self.codec == "fp32":
            return torch.matmul(u, self.plane)
        if self.codec == "int8":
            out = gossip_mix_dequant(u, self.plane_q, self.plane_scale,
                                     qblock=self.qblock)
        else:
            out = mixture_mix_dequant4(u, self.plane_packed, self.plane_scale,
                                       qblock=self.qblock)
        return out[:, :self.spec.size]

    # -- entry points ------------------------------------------------------

    def personalized(self, u) -> dict:
        """``(B, S)`` -> personalized params, leaves ``(B, ...)``."""
        u = self._tensor(u, torch.float32)

        def run():
            with torch.no_grad():
                return unpack(self._mix(u), self.spec)

        return self._timed(run, u.shape[0])

    def predict(self, u, inputs) -> torch.Tensor:
        """Personalized forward: request i's input through request i's
        mixture (mix, unpack, one batched forward). u ``(B, S)``, inputs
        ``(B, ...)``; returns ``(B, C)`` on the server's device."""
        if self.apply_fn is None:
            raise ValueError("predict needs apply_fn= at construction")
        u = self._tensor(u, torch.float32)
        x = self._tensor(inputs, torch.float32)

        def run():
            with torch.no_grad():
                params = unpack(self._mix(u), self.spec)
                return self.apply_fn(params, x.unsqueeze(1))[:, 0]

        return self._timed(run, u.shape[0])

    def generate(self, u, prompts, *, gen: int, temperature: float = 0.0, key=None):
        raise ValueError(f"generate {_LM_ZOO}")

    def serve_client(self, client: int, prompts, *, gen: int,
                     temperature: float = 0.0, key=None):
        raise ValueError(f"serve_client {_LM_ZOO}")

    # -- accounting ----------------------------------------------------------

    @property
    def n_compiles(self) -> int:
        """0: the port runs eagerly and captures no program yet (the JAX
        server counts its jit cache here)."""
        return 0

    @property
    def plane_bytes(self) -> int:
        """Resident device bytes of the plane (weights + scales)."""
        if self.codec == "fp32":
            return self.plane.numel() * 4
        if self.codec == "int8":
            return self.plane_q.numel() + self.plane_scale.numel() * 4
        return self.plane_packed.numel() + self.plane_scale.numel() * 4

    def telemetry_snapshot(self) -> dict:
        """One JSON-able dict of the serve-path counters, with the JAX
        package's keys: codec, plane residency, compile/dispatch/dequant
        counts, per-batch latency percentiles and QPS."""
        return {
            "codec": self.codec,
            "n_clusters": self.n_clusters,
            "plane_bytes": self.plane_bytes,
            "n_compiles": self.n_compiles,
            "n_dispatches": self.n_dispatches,
            "dequant_calls": self.dequant_calls,
            **self.latency.snapshot(),
        }
