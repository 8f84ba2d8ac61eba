"""The port's telemetry layer: the in-round metric streams
(``TelemetryConfig`` on ``RunConfig``, collected inside the round on both
engines and in the replay's CUDA graph), the JSONL event log and its
summary renderer, the one count of programs built
(``counters.compile_count``), serve-path latency stats, and
torch.profiler trace hooks."""
from repro_torch.telemetry.config import TelemetryConfig  # noqa: F401
from repro_torch.telemetry.counters import LatencyStats, compile_count  # noqa: F401
from repro_torch.telemetry.events import (  # noqa: F401
    read_events,
    run_events,
    streams_from_events,
    write_events,
    write_run_jsonl,
)
from repro_torch.telemetry.metrics import (  # noqa: F401
    STREAMS,
    consensus_residual,
    effective_degree,
    flatten_centers,
    inactive_count,
    make_collector,
    mask_churn,
    mask_density,
    mixture_drift,
    mixture_entropy,
    spectral_gap_proxy,
    staleness_histogram,
)
from repro_torch.telemetry.profile import (  # noqa: F401
    annotate,
    step_annotation,
    trace_session,
)
from repro_torch.telemetry.summary import summary_table  # noqa: F401
