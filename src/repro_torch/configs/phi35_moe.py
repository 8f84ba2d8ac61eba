"""Phi-3.5-MoE-42B (6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct]: 32L,
d_model 4096, 32 heads (GQA kv=8), expert d_ff 6400, vocab 32064,
MoE 16 experts top-2."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32064,
    n_experts=16,
    top_k=2,
    norm="rmsnorm",
    act="silu",
    param_dtype="bfloat16",  # 42B: bf16 param store (DESIGN.md §5)
    citation="hf:microsoft/Phi-3.5-MoE-instruct",
)


def smoke_config() -> ArchConfig:
    return CONFIG.with_overrides(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256, vocab=512,
        n_experts=4, top_k=2, param_dtype="float32", compute_dtype="float32",
    )
