"""H2O-Danube-1.8B [arXiv:2401.16818]: 24L, d_model 2560, 32 heads (GQA
kv=8), d_ff 6912, vocab 32000; llama+mistral mix with sliding-window
attention (window 4096)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32000,
    window=4096,  # SWA (mistral-style)
    norm="rmsnorm",
    act="silu",
    citation="arXiv:2401.16818",
)


def smoke_config() -> ArchConfig:
    return CONFIG.with_overrides(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256, vocab=512,
        window=64, param_dtype="float32", compute_dtype="float32",
    )
