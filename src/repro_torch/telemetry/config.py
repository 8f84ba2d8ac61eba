"""TelemetryConfig: the frozen knob block for the in-round metric streams.

Attached to ``RunConfig(telemetry=...)`` (experiments/config.py). When set,
the experiment runner computes every stream inside the round: in the step
of the loop engine, and inside the captured round of the replay, so the
streams are part of the CUDA graph the card replays and need no extra
dispatch and no host read. Both engines run the same ops on the same
inputs, so every stream of the replay equals the loop's bit for bit.

Streams (all per round and per seed):

  logical_bytes   ()   logical comm this round (uncompressed dtypes)
  wire_bytes      ()   physical bytes under the run's codec (static ratio)
  u_entropy       ()   mean per-client entropy of the soft cluster weights
  u_drift         ()   ‖u_t − u_{t−1}‖_F, the soft-assignment drift
  consensus       (S,) per-cluster consensus residual ‖C_i − mean(C)‖²/N
  degree          ()   mean effective-adjacency degree (after dropout and
                       the activity weights)
  spectral_gap    ()   1 − ρ(W) proxy of the Metropolis mixing matrix
  stale_hist      (B,) staleness histogram (B = ``staleness_bins``)
  n_inactive      ()   stragglers and offline clients this round
  density         ()   mean active fraction of the sparse masks (DisPFL)
  mask_churn      ()   fraction of mask bits flipped this round

A stream whose input the run lacks (no ``u`` on the state, no centers with
an ``(S, N)`` lead, no sparse masks) is a NaN of its full static shape, so
which streams a run reports is a function of its config alone.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """How much the in-round metric streams collect.

    round_metrics   master switch for the per-round streams
    spectral_gap    include the mixing-matrix spectral-gap proxy (a few
                    N×N products a round; disable at very large N)
    power_iters     deflated power-iteration steps for the gap proxy
    staleness_bins  histogram bins: counts of staleness 0..B-2 plus an
                    overflow bin for >= B-1
    """

    round_metrics: bool = True
    spectral_gap: bool = True
    power_iters: int = 8
    staleness_bins: int = 5

    def __post_init__(self):
        if self.power_iters < 1:
            raise ValueError(
                f"TelemetryConfig.power_iters={self.power_iters!r} must be >= 1")
        if self.staleness_bins < 2:
            raise ValueError(
                f"TelemetryConfig.staleness_bins={self.staleness_bins!r} "
                "must be >= 2 (one exact bin + overflow)")

    @property
    def enabled(self) -> bool:
        return self.round_metrics
