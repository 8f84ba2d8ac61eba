"""Architecture configuration schema of the LM model zoo.

A copy of the JAX package's ``configs/base.py``: every assigned
architecture has one file in this package exporting ``CONFIG`` (an
:class:`ArchConfig` with the exact published shape) and ``smoke_config()``
(a reduced same-family variant for CPU tests: ≤2 layers, d_model ≤ 512,
≤4 experts). The fields, defaults, aliases and input shapes are the same;
the dtype helpers return ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    citation: str = ""
    head_dim: Optional[int] = None  # default d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "cumsum"

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv: int = 4
    ssm_groups: int = 1

    # --- hybrid (zamba2-style shared attention block) ---
    attn_every: int = 0  # insert the shared attn block after every k SSM layers

    # --- attention pattern ---
    window: Optional[int] = None  # sliding-window size (None = full causal)
    local_global_ratio: int = 0  # gemma3: k local layers per 1 global
    local_window: int = 1024
    rope_theta: float = 10000.0

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_frames: int = 0  # stub frontend sequence length (whisper: 1500)
    encoder_d_model: int = 0

    # --- norms / misc ---
    norm: str = "rmsnorm"  # rmsnorm | layernorm_np (non-parametric)
    act: str = "silu"  # silu (swiglu) | gelu (plain mlp)
    tie_embeddings: bool = False
    qk_norm: bool = False  # chameleon uses qk-norm

    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # --- the JAX package's dry-run cost accounting (kept so that configs
    # compare field for field; the port runs layers as a Python loop) ---
    scan_unroll: int = 1
    attn_unroll: int = 1
    attn_q_block: int = 512
    attn_kv_block: int = 512

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(
                self, "head_dim",
                self.d_model // self.n_heads if self.n_heads else 0,
            )
        assert self.n_heads == 0 or self.n_heads % max(self.n_kv_heads, 1) == 0

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded to a multiple of 256 (the JAX package shards the
        embedding 16-way; the padded rows are masked out of the loss)."""
        return _round_up(self.vocab, 256)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_decoder_only(self) -> bool:
        return self.encoder_layers == 0

    @property
    def supports_long_context(self) -> bool:
        """Natively sub-quadratic (SSM / hybrid / sliding-window)."""
        return (
            self.family in ("ssm", "hybrid")
            or self.window is not None
            or self.local_global_ratio > 0
        )

    def param_dtype_torch(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def compute_dtype_torch(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def with_overrides(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


ASSIGNED_ARCHS = (
    "olmo-1b",
    "olmoe-1b-7b",
    "phi3_5-moe-42b-a6_6b",
    "whisper-base",
    "h2o-danube-1_8b",
    "zamba2-1_2b",
    "gemma3-1b",
    "granite-3-8b",
    "mamba2-370m",
    "chameleon-34b",
)

# CLI ids (with dots/dashes) -> module names
ARCH_ALIASES = {
    "olmo-1b": "olmo_1b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "phi3_5-moe-42b-a6_6b": "phi35_moe",
    "whisper-base": "whisper_base",
    "h2o-danube-1.8b": "h2o_danube",
    "h2o-danube-1_8b": "h2o_danube",
    "zamba2-1.2b": "zamba2_1_2b",
    "zamba2-1_2b": "zamba2_1_2b",
    "gemma3-1b": "gemma3_1b",
    "granite-3-8b": "granite_3_8b",
    "mamba2-370m": "mamba2_370m",
    "chameleon-34b": "chameleon_34b",
}


def get_config(arch: str) -> ArchConfig:
    mod_name = ARCH_ALIASES.get(arch)
    if mod_name is None:
        raise ValueError(f"unknown arch {arch!r}; have {sorted(ARCH_ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_ALIASES[arch]}")
    return mod.smoke_config()


# ---------------------------------------------------------------------------
# Input shapes assigned to this paper (public pool).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
