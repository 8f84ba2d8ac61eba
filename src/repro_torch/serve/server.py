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
into ``(B, ...)`` leaves and go straight into one batched forward (the
counterpart of the JAX package's ``jax.vmap``): ``predict`` runs a
classifier (``apply_fn``), ``generate`` and ``serve_client`` decode with a
language model (``bundle``, a ``models/registry`` ModelBundle of the
dense, vlm or ssm family). Each call is one mix launch and eager work
after it; ``n_dispatches`` counts calls and ``dequant_calls`` the calls
that ran a dequant kernel.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.packing import PackSpec, unpack
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels.gossip_mix import gossip_mix_dequant, mixture_mix_dequant4
from repro_torch.models.layers import cast_params_for_compute
from repro_torch.serve.artifact import ServableArtifact
from repro_torch.telemetry.counters import LatencyStats


class ClusterPlaneServer:
    """Serve personalized mixtures from one resident cluster plane on
    ``device`` (the card by default; raises without one unless
    ``device="cpu"``).

    Construct from a loaded artifact (``from_artifact``) or from a plane
    in one of the shipping forms. ``bundle`` (a models/registry
    ModelBundle) enables ``generate``; ``apply_fn`` (a batched forward
    such as smallnets' ``apply_mlp_classifier``: leaves ``(B, ...)``,
    inputs ``(B, 1, ...)``) enables ``predict``.
    """

    def __init__(self, spec: PackSpec, *, codec: str = "fp32", qblock: int = 64,
                 plane=None, plane_q=None, plane_scale=None, plane_packed=None,
                 u_table=None, bundle=None, apply_fn: Optional[Callable] = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.spec = spec
        self.codec = codec
        self.qblock = int(qblock)
        self.apply_fn = apply_fn
        self.bundle = bundle
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

    def generate(self, u, prompts, *, gen: int, temperature: float = 0.0, key=None,
                 noise=None) -> torch.Tensor:
        """Batched personalized generation: B requests, each decoded with
        its own mixture row's weights. u ``(B, S)``, prompts ``(B, Lp)``
        token ids; returns ``(B, gen)`` int32 tokens on the server's
        device.

        The JAX server's steps: mix and unpack to ``(B, ...)`` leaves; one
        prefill of the B prompts, each through its own weights; ``pos`` set
        back to ``Lp - 1`` and the last prompt token re-scored; then
        ``gen`` tokens, each the argmax of the logits cut to the vocab
        (greedy), or at ``temperature > 0`` the argmax of ``logits /
        temperature + g`` with Gumbel draws g (Gumbel-max sampling, as
        ``jax.random.categorical``). ``noise`` ``(gen, B, vocab)`` gives
        the draws (a test injects the JAX ones); otherwise they come from
        ``key``, a ``torch.Generator`` on the server's device or an int
        seed (default 0). The caches hold ``Lp + gen + 1`` positions. The
        step that would follow the last token is not run (its logits
        would be dropped)."""
        if self.bundle is None:
            raise ValueError("generate needs bundle= at construction")
        u = self._tensor(u, torch.float32)
        prompts = self._tensor(prompts, torch.int64)
        gen, temperature = int(gen), float(temperature)
        b, lp = prompts.shape
        vocab = self.bundle.cfg.vocab
        if temperature > 0:
            noise = self._gumbel(noise, key, (gen, b, vocab))

        def run():
            with torch.no_grad():
                return self._generate(u, prompts, gen, temperature, noise, lp + gen + 1)

        return self._timed(run, b)

    def _gumbel(self, noise, key, shape: tuple) -> torch.Tensor:
        if noise is not None:
            noise = self._tensor(noise, torch.float32)
            if tuple(noise.shape) != shape:
                raise ValueError(f"noise {tuple(noise.shape)} != (gen, B, vocab) {shape}")
            return noise
        if not isinstance(key, torch.Generator):
            key = torch.Generator(device=self.device).manual_seed(int(key or 0))
        uni = torch.rand(shape, generator=key, device=self.device).clamp_min(1e-20)
        return -torch.log(-torch.log(uni))

    def _generate(self, u, prompts, gen, temperature, noise, max_len):
        bundle, vocab = self.bundle, self.bundle.cfg.vocab
        params = unpack(self._mix(u), self.spec)
        # cast once for the prefill and every decode step (the model's own
        # cast of an already cast leaf is then no copy)
        compute = bundle.cfg.compute_dtype_torch()
        params = cast_params_for_compute(params, compute)
        b, lp = prompts.shape
        cache = bundle.init_cache(b, max_len, device=self.device)
        cache = bundle.prefill(params, {"tokens": prompts}, cache)
        cache["pos"] = lp - 1
        logits, cache = bundle.decode_step(params, cache, prompts[:, -1:])
        toks = []
        for i in range(gen):
            lg = logits[:, -1, :vocab]
            if temperature > 0:
                lg = lg / temperature + noise[i].to(lg.dtype)
            tok = lg.argmax(dim=-1)
            toks.append(tok)
            if i + 1 < gen:
                logits, cache = bundle.decode_step(params, cache, tok[:, None])
        return torch.stack(toks, dim=1).to(torch.int32)

    def serve_client(self, client: int, prompts, *, gen: int, temperature: float = 0.0,
                     key=None, noise=None) -> torch.Tensor:
        """Generate for one trained client: its u-table row broadcast over
        the request batch."""
        if self.u_table is None:
            raise ValueError("serve_client needs u_table= at construction")
        row = self.u_table[int(client)]
        u = row.expand(len(prompts), row.shape[0])
        return self.generate(u, prompts, gen=gen, temperature=temperature, key=key,
                             noise=noise)

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
