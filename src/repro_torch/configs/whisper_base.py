"""Whisper-base [arXiv:2212.04356]: enc-dec, 6+6L, d_model 512, 8 heads,
d_ff 2048, vocab 51865. Conv/mel frontend STUBBED: input_specs() supplies
precomputed frame embeddings (B, 1500, 512)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    encoder_layers=6,
    encoder_frames=1500,
    encoder_d_model=512,
    norm="rmsnorm",
    act="gelu",
    citation="arXiv:2212.04356",
)


def smoke_config() -> ArchConfig:
    return CONFIG.with_overrides(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
        encoder_layers=2, encoder_frames=64, encoder_d_model=128,
        param_dtype="float32", compute_dtype="float32",
    )
