"""Configurations: the paper-scale experiment (``paper_cnn``) and the LM
model zoo's architectures (``base`` and one file per arch)."""
from repro_torch.configs.base import (  # noqa: F401
    ARCH_ALIASES,
    ASSIGNED_ARCHS,
    INPUT_SHAPES,
    ArchConfig,
    InputShape,
    get_config,
    get_smoke_config,
)
