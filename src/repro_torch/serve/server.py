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
dense, moe, vlm, ssm or hybrid family; an MoE routes each request alone,
as the JAX server's ``vmap`` does). ``n_dispatches`` counts calls and
``dequant_calls`` the calls that ran a dequant kernel.

``generate`` is the counterpart of the JAX server's one jitted program. Per
call it runs eagerly: the mix (one kernel 4 / 7 launch, or the fp32
``torch.matmul``), the copy of the personalized leaves into static
compute-dtype buffers (one set per B), and one prefill of the B prompts
into a static cache (kernels 8 / 9). The per-token work, decode step and
sample, runs as replays of one CUDA graph captured over static buffers
(the cache with its device position, the token, the logits, a step
counter, the noise tape and the output), one graph per shape key ``(B,
Lp, gen, temperature)``, the jit's static arguments; the host only
launches the replays. On the CPU the same closure over the same buffers
is called directly. ``n_compiles`` counts the decode programs built.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.packing import PackSpec, unpack
from repro_torch.device import capture, resolve_device, synchronize, warm_up
from repro_torch.kernels.gossip_mix import gossip_mix_dequant, mixture_mix_dequant4
from repro_torch.serve.artifact import ServableArtifact
from repro_torch.telemetry.counters import LatencyStats, compile_count

# the profiler span around each decode token of ``generate`` (one replay
# on the card), by which a trace's kernels are counted per token
DECODE_SPAN = "repro_torch.decode_token"


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
        # generate's static state: the compute-dtype leaves for each batch
        # size B, and the decode engine for each shape key (B, Lp, gen,
        # temperature), kept for the server's life as the JAX jit cache is
        self.leaves: dict = {}
        self.engines: dict = {}

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
        seed (default 0), drawn before the decode and outside its graph.
        The caches hold ``Lp + gen + 1`` positions. The step that would
        follow the last token is not run (its logits would be dropped).

        The first call of a shape key ``(B, Lp, gen, temperature)`` builds
        its decode engine: on the card it warms the per-token step up and
        captures it into a CUDA graph, and raises ``RuntimeError`` if the
        capture fails (there is no eager fallback)."""
        if self.bundle is None:
            raise ValueError("generate needs bundle= at construction")
        u = self._tensor(u, torch.float32)
        prompts = self._tensor(prompts, torch.int64)
        gen, temperature = int(gen), float(temperature)
        if gen < 1:
            raise ValueError(f"gen={gen}: generate makes at least one token")
        b, lp = prompts.shape
        vocab = self.bundle.cfg.vocab
        if temperature > 0:
            noise = self._gumbel(noise, key, (gen, b, vocab))

        def run():
            with torch.no_grad():
                engine = self._engine((b, lp, gen, temperature))
                # the mix, cast into the static leaves as it is copied (the
                # (B, X) mix output is freed after)
                _copy_tree(engine.params, unpack(self._mix(u), self.spec))
                return engine(prompts, noise)

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

    def _engine(self, key: tuple) -> "_DecodeEngine":
        """The decode engine of ``key``, built (and on the card captured)
        at its first call, before the call fills its buffers."""
        if key not in self.engines:
            b = key[0]
            if b not in self.leaves:
                self.leaves[b] = _static_leaves(self.spec, b, self.bundle.cfg,
                                                self.device)
            self.engines[key] = _DecodeEngine(self.bundle, self.leaves[b], key,
                                              self.device)
        return self.engines[key]

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
        """The decode programs ``generate`` has built, one per shape key
        ``(B, Lp, gen, temperature)``: a CUDA graph of the per-token step
        on the card, its closure on the CPU (the JAX server counts its jit
        cache here). The mix and the prefill run eagerly and build none."""
        return compile_count(self.engines)

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


# --------------------------------------------------------------------------
# The decode engine
# --------------------------------------------------------------------------


def _static_leaves(spec: PackSpec, b: int, cfg, device: torch.device) -> dict:
    """Empty ``(b, ...)`` buffers for the personalized leaves in the dtypes
    ``cast_params_for_compute`` gives them: every float leaf in the compute
    dtype, the embed table in its own (fp32) dtype, as the model casts its
    rows after the lookup."""
    compute = cfg.compute_dtype_torch()
    tree: dict = {}
    for path, shape, dt in zip(spec.paths, spec.shapes, spec.dtypes):
        if path[0] != "embed" and dt.is_floating_point:
            dt = compute
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.empty((b, *shape), dtype=dt, device=device)
    return tree


def _copy_tree(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_tree(dst[k], v)
        else:
            dst[k].copy_(v)


class _DecodeEngine:
    """``generate``'s per-token work for one shape key ``(B, Lp, gen,
    temperature)`` over static buffers: the shared per-B leaves
    (``params``), the cache of ``bundle.init_cache`` (``Lp + gen + 1``
    positions, its ``pos`` a device tensor), the ``(B, 1)`` token, the
    ``(B, vocab)`` logits, the device step counter, the ``(gen, B, vocab)``
    noise tape (temperature > 0) and the ``(B, gen)`` int32 output.

    One token (``_token``): decode ``tokens`` at ``pos``, keep the logits
    cut to the vocab, sample from them (with ``noise[step]`` at
    temperature > 0), write the sample into ``out[:, step]`` and
    ``tokens``, and advance ``step``. A call runs it ``gen`` times after the
    prefill, the first on the last prompt token (the re-score), so the step
    after the last sample is never run. On the card the token is captured
    once into a CUDA graph, after a warm-up, and each token is a replay;
    on the CPU the closure runs."""

    def __init__(self, bundle, params: dict, key: tuple, device: torch.device):
        b, lp, gen, temperature = key
        cfg = bundle.cfg
        self.bundle, self.params, self.key = bundle, params, key
        self.cache = bundle.init_cache(b, lp + gen + 1, device=device)
        self.tokens = torch.zeros((b, 1), dtype=torch.int64, device=device)
        self.logits = torch.zeros((b, cfg.vocab), dtype=cfg.compute_dtype_torch(),
                                  device=device)
        self.step = torch.zeros((), dtype=torch.int64, device=device)
        self.noise = (torch.zeros((gen, b, cfg.vocab), dtype=torch.float32, device=device)
                      if temperature > 0 else None)
        self.out = torch.zeros((b, gen), dtype=torch.int32, device=device)
        self.graph, self.capture_ms = None, 0.0
        if device.type != "cuda":
            return
        t0 = time.perf_counter()
        try:
            # the warm-up writes only buffers that every call resets first
            warm_up(self._token, device)
            self.graph = capture(self._token, ())
        except Exception as e:
            cc = "sm_%d%d" % torch.cuda.get_device_capability(device)
            raise RuntimeError(
                f"generate: {cfg.name}'s decode step for (B, Lp, gen, temperature) = "
                f"{key} could not be captured into a CUDA graph on "
                f"{torch.cuda.get_device_name(device)} ({cc}): {e}") from e
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def _token(self) -> None:
        vocab, temperature = self.bundle.cfg.vocab, self.key[3]
        logits, _ = self.bundle.decode_step(self.params, self.cache, self.tokens)
        self.logits.copy_(logits[:, -1, :vocab])
        lg = self.logits
        at = self.step.view(1)
        if temperature > 0:
            lg = lg / temperature + self.noise.index_select(0, at)[0].to(lg.dtype)
        tok = lg.argmax(dim=-1)
        self.out.index_copy_(1, at, tok.to(torch.int32)[:, None])
        self.tokens.copy_(tok[:, None])
        self.step.add_(1)

    def __call__(self, prompts: torch.Tensor, noise) -> torch.Tensor:
        """Prefill ``prompts`` (eager), then ``gen`` tokens; returns a copy
        of the output (the next call overwrites the buffer)."""
        lp = self.key[1]
        for t in self.cache.values():
            t.zero_()          # JAX's fresh init_cache
        self.bundle.prefill(self.params, {"tokens": prompts}, self.cache)
        self.cache["pos"].fill_(lp - 1)
        self.step.zero_()
        self.tokens.copy_(prompts[:, -1:])
        if self.noise is not None:
            self.noise.copy_(noise)
        for _ in range(self.key[2]):
            with torch.profiler.record_function(DECODE_SPAN):
                if self.graph is None:
                    self._token()
                else:
                    self.graph.replay()
        return self.out.clone()


def decode_eager(bundle, params: dict, prompts: torch.Tensor, *, gen: int,
                 temperature: float = 0.0, noise=None):
    """The plain version of ``generate``'s decode, the reference its engine
    is held to: the prefill, then ``gen`` tokens stepped from Python, each
    step's ops launched one by one (as the server ran them before its
    decode was captured), each token inside a ``DECODE_SPAN`` as the
    engine's. ``params`` are compute-cast ``(B, ...)`` leaves; ``noise``
    ``(gen, B, vocab)`` at temperature > 0. Returns the ``(B, gen)`` int32
    tokens and the ``(B, vocab)`` logits the last token was drawn from."""
    vocab = bundle.cfg.vocab
    b, lp = prompts.shape
    cache = bundle.init_cache(b, lp + gen + 1, device=prompts.device)
    cache = bundle.prefill(params, {"tokens": prompts}, cache)
    cache["pos"].fill_(lp - 1)
    tok, toks = prompts[:, -1:], []
    for i in range(gen):
        with torch.profiler.record_function(DECODE_SPAN):
            logits, cache = bundle.decode_step(params, cache, tok)
            last = logits[:, -1, :vocab]
            lg = last / temperature + noise[i].to(last.dtype) if temperature > 0 else last
            toks.append(lg.argmax(dim=-1))
            tok = toks[-1][:, None]
    return torch.stack(toks, dim=1).to(torch.int32), last
