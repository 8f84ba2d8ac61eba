"""Zamba2-1.2B [arXiv:2411.15242]: 38 Mamba2 layers, d_model 2048, shared
attention block (32 heads MHA, d_ff 8192) invoked every 6 layers,
vocab 32000, ssm_state 64."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    attn_every=6,
    norm="rmsnorm",
    act="silu",
    citation="arXiv:2411.15242",
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-smoke",
        family="hybrid",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab=512,
        ssm_state=16,
        ssm_headdim=32,
        ssm_expand=2,
        attn_every=1,
        norm="rmsnorm",
        act="silu",
        param_dtype="float32",
        compute_dtype="float32",
        citation="arXiv:2411.15242",
    )
