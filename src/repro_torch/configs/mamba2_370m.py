"""Mamba2-370m [arXiv:2405.21060]: 48 SSD layers, d_model 1024 (attn-free),
vocab 50280, ssm_state 128, headdim 64, expand 2."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=128,
    norm="rmsnorm",
    act="silu",
    citation="arXiv:2405.21060",
)


def smoke_config() -> ArchConfig:
    return CONFIG.with_overrides(
        n_layers=2, d_model=128, vocab=512, ssm_state=16, ssm_headdim=32,
        param_dtype="float32", compute_dtype="float32",
    )
