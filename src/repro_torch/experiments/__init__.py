"""The port's experiment entry points."""
from repro_torch.experiments.config import RunConfig
from repro_torch.experiments.export import export_run
from repro_torch.experiments.registry import available_methods, get_method
from repro_torch.experiments.runner import RunResult, run_method, run_method_batch

__all__ = ["RunConfig", "RunResult", "available_methods", "export_run", "get_method",
           "run_method", "run_method_batch"]
