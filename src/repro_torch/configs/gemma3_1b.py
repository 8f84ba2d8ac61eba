"""Gemma-3-1B [hf:google/gemma-3-1b-pt]: 26L, d_model 1152, 4 heads
(GQA kv=1, head_dim 256), d_ff 6912, vocab 262144; 5:1 local:global
attention (local window 1024... published 512; we keep 1024 per assignment),
tied embeddings."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab=262144,
    head_dim=256,
    local_global_ratio=5,
    local_window=1024,
    tie_embeddings=True,
    norm="rmsnorm",
    act="gelu",
    rope_theta=1_000_000.0,
    citation="hf:google/gemma-3-1b-pt",
)


def smoke_config() -> ArchConfig:
    return CONFIG.with_overrides(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=1, d_ff=256, vocab=512,
        head_dim=32, local_global_ratio=1, local_window=32,
        param_dtype="float32", compute_dtype="float32",
    )
