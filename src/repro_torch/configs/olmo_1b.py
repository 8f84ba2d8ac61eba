"""OLMo-1B [arXiv:2402.00838]: 16L, d_model 2048, 16 heads (MHA), d_ff 8192,
vocab 50304, non-parametric LayerNorm, SwiGLU."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    norm="layernorm_np",
    act="silu",
    citation="arXiv:2402.00838",
)


def smoke_config() -> ArchConfig:
    return CONFIG.with_overrides(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=512, vocab=512,
        param_dtype="float32", compute_dtype="float32",
    )
