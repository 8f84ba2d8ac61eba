"""Granite-3 8B [hf:ibm-granite/granite-3.0-2b-base family, 8B shape]: 40L,
d_model 4096, 32 heads (GQA kv=8), d_ff 12800, vocab 49155."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab=49155,
    norm="rmsnorm",
    act="silu",
    param_dtype="bfloat16",  # 8B: bf16 param store (DESIGN.md §5)
    citation="hf:ibm-granite/granite-3.0-2b-base",
)


def smoke_config() -> ArchConfig:
    return CONFIG.with_overrides(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=384, vocab=512,
        param_dtype="float32", compute_dtype="float32",
    )
