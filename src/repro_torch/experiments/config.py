"""RunConfig: how a run of the port executes.

The JAX package's ``RunConfig`` fields, less ``donate`` (the port always
updates the plane in place), plus ``device``. This slice honours
``gossip_mode="dense"``, ``gossip_backend`` ("cuda", or "reference" as
another name for it), ``eval_every``, ``options`` (``dp_clip``,
``dp_noise_multiplier``, ``tau_final``, ``keep_state``) and ``device``.
Every field that selects a feature the port does not have yet is refused
with a ``ValueError`` that names it; none falls back silently.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core.gossip import MIX_BACKENDS

# the options keys this slice honours; any other key is refused
_OPTIONS = ("mode", "gossip_backend", "param_plane", "dp_clip",
            "dp_noise_multiplier", "tau_final", "cos_align_threshold",
            "keep_state")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """gossip_mode     FedSPD wiring: "dense" (the only one ported)
    gossip_backend  exchange execution: "cuda" (the hand-written Hopper
                    kernels, the counterpart of the JAX package's
                    "pallas"; their plain versions on CPU tensors).
                    "reference" names the same path
    param_plane     the port always runs the packed (S, N, X) plane; False
                    is refused
    eval_every      train-curve cadence (the final round always evaluates)
    options         per-method knobs: dp_clip, dp_noise_multiplier,
                    tau_final (explicit entries win over the fields);
                    keep_state=True leaves the final state and its
                    PackSpec in RunResult.extras (what export_run reads)
    device          "cuda" (the default: raises without a card) | "cpu"

    comm, scenario, scan_rounds, cohort_size, sparse and telemetry are not
    ported yet; setting any of them raises ``ValueError``."""

    gossip_mode: Optional[str] = None
    gossip_backend: Optional[str] = None
    param_plane: Optional[bool] = None
    comm: Any = None
    scenario: Any = None
    eval_every: int = 10
    scan_rounds: bool = False
    cohort_size: Optional[int] = None
    sparse: Any = None
    telemetry: Any = None
    options: dict = dataclasses.field(default_factory=dict)
    device: str = "cuda"

    def resolve_options(self) -> dict:
        """A fresh per-run options dict (explicit ``options`` entries win
        over the typed fields); raises ``ValueError`` for what the port
        does not run yet."""
        unported = {
            "comm (wire codecs)": self.comm is not None,
            "scenario (dynamic graphs, dropout, heterogeneity)":
                self.scenario is not None,
            "scan_rounds (the whole-run engine)": self.scan_rounds,
            "cohort_size (client subsampling)": self.cohort_size is not None,
            "sparse (DisPFL masks)": self.sparse is not None,
            "telemetry": self.telemetry is not None,
        }
        for what, on in unported.items():
            if on:
                raise ValueError(f"RunConfig.{what} is not ported yet")
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
        if options.get("param_plane", True) is False:
            raise ValueError(
                "param_plane=False (the per-leaf pytree engine) is not "
                "ported; the port runs the packed (S, N, X) plane")
        if options.get("mode", "dense") != "dense":
            raise ValueError(
                f"gossip_mode {options['mode']!r} is not ported yet; the "
                "port has the dense Eq. (1) wiring")
        if options.get("cos_align_threshold", -1.0) > -1.0:
            raise ValueError(
                "cos_align_threshold > -1 (cosine alignment) is not ported yet")
        backend = options.setdefault("gossip_backend", "cuda")
        if backend not in MIX_BACKENDS:
            raise ValueError(
                f"gossip_backend {backend!r} is not available in the port; "
                f"use one of {MIX_BACKENDS} ('cuda' is the counterpart of "
                "'pallas')")
        return options
