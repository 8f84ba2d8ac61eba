"""RunConfig: how a run of the port executes.

The JAX package's ``RunConfig`` fields, less ``donate`` (the port always
updates the plane in place), plus ``device`` and ``on_round``. The port
honours ``gossip_mode`` ("dense" or "permute"), ``gossip_backend``
("cuda" or "reference"), ``param_plane`` (the packed plane, the port's
default, or the per-leaf pytree engine), ``comm`` (every method),
``sparse`` (FedSPD only), ``eval_every``, ``scan_rounds``,
``cohort_size`` (FedSPD only), ``scenario`` (FedSPD only), ``telemetry``
(every method), ``options``
(``mode``, ``param_plane``, ``dp_clip``,
``dp_noise_multiplier``, ``tau_final``, ``cos_align_threshold``,
``keep_state``, ``comm``, ``sparse``), ``device`` and ``on_round``.
Every field that selects a feature the port does not have yet is refused
with a ``ValueError`` that names it; none falls back silently.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.comm.codecs import CommConfig
from repro_torch.core.gossip import MIX_BACKENDS, MODES
from repro_torch.core.sparse import SparseConfig
from repro_torch.experiments.heterogeneity import ClientSystemModel
from repro_torch.experiments.scenarios import Scenario
from repro_torch.telemetry.config import TelemetryConfig

# the options keys the port honours; any other key is refused
_OPTIONS = ("mode", "gossip_backend", "param_plane", "dp_clip",
            "dp_noise_multiplier", "tau_final", "cos_align_threshold",
            "keep_state", "comm", "sparse")


def _normalize_comm(options: dict) -> None:
    """A compressing codec works on packed plane slices: it implies the
    plane, and refuses ``param_plane=False`` rather than flip it."""
    comm = options.get("comm")
    if comm is None:
        return
    if not isinstance(comm, CommConfig):
        raise ValueError(
            f"comm must be a comm.codecs.CommConfig, got {type(comm).__name__}")
    if comm.codec != "fp32" and options.get("param_plane") is False:
        raise ValueError(
            f"comm codec {comm.codec!r} requires the packed parameter "
            "plane, but param_plane=False was requested — drop one of the "
            "two (fp32 is the only pytree-safe codec)")


def _normalize_sparse(options: dict) -> None:
    """Sparse masks live on the packed X axis: an enabled ``SparseConfig``
    implies the plane, and refuses ``param_plane=False``."""
    sparse = options.get("sparse")
    if sparse is None:
        return
    if not isinstance(sparse, SparseConfig):
        raise ValueError(
            "sparse must be a core.sparse.SparseConfig, got "
            f"{type(sparse).__name__}")
    if sparse.enabled and options.get("param_plane") is False:
        raise ValueError(
            f"sparse training (density={sparse.density}) requires the "
            "packed parameter plane, but param_plane=False was requested "
            "— drop one of the two")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """gossip_mode     FedSPD wiring: "dense" (Eq. (1) as W·C) or "permute"
                    (the edge-coloured schedule, core/gossip.mix_permute)
    gossip_backend  exchange execution: "cuda" (the default: the dense W
                    through the hand-written Hopper kernels, the
                    counterpart of the JAX package's "pallas", whatever
                    the wiring; their plain versions on CPU tensors) or
                    "reference" (the wiring itself: with "permute",
                    mix_permute; with "dense", the "cuda" path)
    param_plane     the parameter representation: the packed (S, N, X)
                    plane (True, and the port's default when unset) or the
                    per-leaf pytree engine (False: nested dicts of leaves,
                    the JAX package's default; no codec, no sparse masks,
                    no cohort and no Scenario.system there, as in JAX)
    comm            comm.codecs.CommConfig wire codec (every method; local
                    exchanges nothing)
    sparse          core.sparse.SparseConfig DisPFL masks (FedSPD only)
    eval_every      train-curve cadence (the final round always evaluates)
    scan_rounds     the engine. True: one captured round replayed every
                    round (a CUDA graph on the card, one per host-side
                    branch; on the CPU the same round called directly),
                    bit for bit the loop's run. False: the loop, one call
                    of the step a round. None (the default): the replay
                    on the card, the loop on the CPU
    cohort_size     K: each round K of N clients, drawn on the device from
                    a stream of their own, train and exchange (FedSPD only)
    scenario        experiments/scenarios.Scenario: a graph schedule, link
                    dropout and a ClientSystemModel (FedSPD only)
    telemetry       telemetry.TelemetryConfig: the in-round metric streams
                    (RunResult.telemetry), on both engines and both
                    parameter representations, every method
    options         per-method knobs: dp_clip, dp_noise_multiplier,
                    tau_final, cos_align_threshold (cosine alignment;
                    -1 disables it; not with sparse) (explicit entries
                    win over the fields);
                    keep_state=True leaves the final state and its
                    PackSpec in RunResult.extras (what export_run reads)
    device          "cuda" (the default: raises without a card) | "cpu"
    on_round        called with each round's index after the round (outside
                    its timed span, before that round's evaluation): a
                    hook to watch a run from outside, such as a profiler
                    started and stopped around chosen rounds"""

    gossip_mode: Optional[str] = None
    gossip_backend: Optional[str] = None
    param_plane: Optional[bool] = None
    comm: Any = None
    scenario: Any = None
    eval_every: int = 10
    scan_rounds: Optional[bool] = None
    cohort_size: Optional[int] = None
    sparse: Any = None
    telemetry: Any = None
    options: dict = dataclasses.field(default_factory=dict)
    device: str = "cuda"
    on_round: Optional[Callable[[int], None]] = None

    def resolve_options(self) -> dict:
        """A fresh per-run options dict (explicit ``options`` entries win
        over the typed fields); raises ``ValueError`` for what the port
        does not run yet."""
        if self.telemetry is not None and not isinstance(self.telemetry, TelemetryConfig):
            raise ValueError(
                "telemetry must be a telemetry.TelemetryConfig, got "
                f"{type(self.telemetry).__name__}")
        if self.scenario is not None:
            if not isinstance(self.scenario, Scenario):
                raise ValueError(
                    "scenario must be an experiments.scenarios.Scenario, got "
                    f"{type(self.scenario).__name__}")
            system = self.scenario.system
            if system is not None and not isinstance(system, ClientSystemModel):
                raise ValueError(
                    "Scenario.system must be an experiments.heterogeneity."
                    f"ClientSystemModel, got {type(system).__name__}")
        options = dict(self.options or {})
        unknown = sorted(k for k in options if k not in _OPTIONS)
        if unknown:
            raise ValueError(f"options {unknown} are not ported yet")
        if self.gossip_mode is not None:
            options.setdefault("mode", self.gossip_mode)
        if self.gossip_backend is not None:
            options.setdefault("gossip_backend", self.gossip_backend)
        if self.param_plane is not None:
            options.setdefault("param_plane", self.param_plane)
        if self.comm is not None:
            options.setdefault("comm", self.comm)
        if self.sparse is not None:
            options.setdefault("sparse", self.sparse)
        _normalize_comm(options)
        _normalize_sparse(options)
        if options.get("mode", "dense") not in MODES:
            raise ValueError(f"unknown gossip mode {options['mode']!r}")
        backend = options.setdefault("gossip_backend", "cuda")
        if backend not in MIX_BACKENDS:
            raise ValueError(
                f"gossip_backend {backend!r} is not available in the port; "
                f"use one of {MIX_BACKENDS} ('cuda' is the counterpart of "
                "'pallas')")
        return options
