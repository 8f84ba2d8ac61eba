"""Part of the PyTorch port; see the module docstrings."""
from repro_torch.telemetry.counters import LatencyStats  # noqa: F401
