"""The port's experiment entry points: the method registry, the runner, its
scenario engine (dynamic topologies, link dropout, client-system
heterogeneity) and its telemetry streams (``TelemetryConfig``)."""
from repro_torch.comm.codecs import CommConfig
from repro_torch.experiments.config import RunConfig
from repro_torch.experiments.export import export_run
from repro_torch.experiments.heterogeneity import (
    ClientSystemModel,
    HetCarry,
    apply_client_weights,
    het_round,
    masked_client_step,
    restore_inactive,
)
from repro_torch.experiments.registry import (
    CommModel,
    ExperimentContext,
    Method,
    available_methods,
    build_context,
    get_method,
    register,
)
from repro_torch.experiments.runner import RunResult, run_method, run_method_batch
from repro_torch.experiments.scenarios import Scenario, bernoulli_drop
from repro_torch.telemetry.config import TelemetryConfig

__all__ = ["ClientSystemModel", "CommConfig", "CommModel", "ExperimentContext",
           "HetCarry", "Method", "RunConfig", "RunResult", "Scenario", "TelemetryConfig",
           "apply_client_weights", "available_methods", "bernoulli_drop",
           "build_context", "export_run", "get_method", "het_round",
           "masked_client_step", "register", "restore_inactive", "run_method",
           "run_method_batch"]
