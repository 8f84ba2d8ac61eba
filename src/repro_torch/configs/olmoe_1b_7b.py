"""OLMoE-1B-7B [arXiv:2409.02060]: 16L, d_model 2048, 16 heads, expert
d_ff 1024, vocab 50304, MoE 64 experts top-8."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    n_experts=64,
    top_k=8,
    norm="rmsnorm",
    act="silu",
    citation="arXiv:2409.02060",
)


def smoke_config() -> ArchConfig:
    return CONFIG.with_overrides(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
        n_experts=4, top_k=2, param_dtype="float32", compute_dtype="float32",
    )
