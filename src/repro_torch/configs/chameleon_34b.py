"""Chameleon-34B [arXiv:2405.09818]: 48L, d_model 8192, 64 heads (GQA kv=8),
d_ff 22016, vocab 65536 (early-fusion: VQ image tokens share the text vocab;
the VQ-GAN codec frontend is STUBBED — inputs are token ids). Uses qk-norm
as in the paper."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
    qk_norm=True,
    norm="rmsnorm",
    act="silu",
    param_dtype="bfloat16",  # 34B: bf16 param store (DESIGN.md §5)
    citation="arXiv:2405.09818",
)


def smoke_config() -> ArchConfig:
    return CONFIG.with_overrides(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=384, vocab=512,
        param_dtype="float32", compute_dtype="float32",
    )
