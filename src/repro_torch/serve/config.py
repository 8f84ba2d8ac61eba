"""ServeConfig: the one configuration object the serving stack takes.

A copy of the JAX package's ``serve/config.py``: ``launch/serve.py``'s
flags are a thin layer over this frozen dataclass. (The JAX package's
deprecated loose-kwarg surface, ``generate(bundle, params, ...)`` and
``--ckpt`` serving, raises in the port.)

``resolve()`` validates and normalizes in one place — unknown arch,
non-positive shapes, a codec outside the plane shipping formats, or a
client/mixture conflict all fail HERE with the field named, before any
model is built or plane loaded.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from repro_torch.configs.base import ARCH_ALIASES, get_config, get_smoke_config

#: Plane shipping formats the server can hold hot (comm/codecs wire forms).
SERVE_CODECS = ("fp32", "int8", "int4")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Everything about HOW a serve run executes.

    arch         model registry alias (configs.base.ARCH_ALIASES)
    smoke        smoke-shape config + ref attention (CI-runnable)
    batch        request-batch size B
    prompt_len   prompt tokens per request
    gen          tokens to generate per request
    temperature  0 = greedy, >0 = categorical sampling
    client       serve this trained client's mixture row from the
                 artifact's u table (exclusive with ``mixture``)
    mixture      explicit mixture weights: (S,) shared by the batch or
                 (B, S) per-request (exclusive with ``client``)
    codec        plane shipping format: fp32 | int8 | int4 (quantized
                 planes are mixed by the fused kernels/ paths)
    qblock       quantization block width for quantized codecs
    seed         PRNG seed (prompt synthesis + sampling)
    options      escape hatch for server knobs
    """

    arch: str = "olmo-1b"
    smoke: bool = True
    batch: int = 4
    prompt_len: int = 32
    gen: int = 16
    temperature: float = 0.0
    client: Optional[int] = None
    mixture: Any = None
    codec: str = "fp32"
    qblock: int = 64
    seed: int = 0
    options: dict = dataclasses.field(default_factory=dict)

    def resolve(self) -> "ServeConfig":
        """Validate every field (naming the offender) and normalize
        ``mixture`` to a float32 ndarray; returns the resolved config."""
        if self.arch not in ARCH_ALIASES:
            raise ValueError(
                f"unknown arch {self.arch!r}; have {sorted(ARCH_ALIASES)}"
            )
        for field in ("batch", "prompt_len", "gen", "qblock"):
            v = getattr(self, field)
            if not isinstance(v, int) or v <= 0:
                raise ValueError(f"{field} must be a positive int, got {v!r}")
        if self.temperature < 0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.codec not in SERVE_CODECS:
            raise ValueError(
                f"codec {self.codec!r} is not a plane shipping format; "
                f"have {SERVE_CODECS}"
            )
        if self.codec == "int4" and self.qblock % 2:
            raise ValueError(
                f"int4 plane serving needs an even qblock (paired nibbles), "
                f"got {self.qblock}"
            )
        if self.client is not None and self.mixture is not None:
            raise ValueError(
                "client and mixture are exclusive: pick a trained client's "
                "u row OR supply explicit mixture weights"
            )
        if self.client is not None and (
                not isinstance(self.client, int) or self.client < 0):
            raise ValueError(
                f"client must be a non-negative int, got {self.client!r}")
        if self.arch_config().family == "audio":
            raise NotImplementedError(
                "audio serving needs a decoder prefill over the prompt "
                "tokens (encdec_prefill_cross only fills the cross-"
                "attention cache); use launch/dryrun.py's serve shapes"
            )
        mixture = self.mixture
        if mixture is not None:
            mixture = np.asarray(mixture, np.float32)
            if mixture.ndim not in (1, 2):
                raise ValueError(
                    f"mixture must be (S,) or (B, S), got shape "
                    f"{mixture.shape}"
                )
            if mixture.ndim == 2 and mixture.shape[0] != self.batch:
                raise ValueError(
                    f"mixture batch {mixture.shape[0]} != batch {self.batch}"
                )
            if np.any(mixture < 0):
                raise ValueError("mixture weights must be non-negative")
            tot = mixture.sum(axis=-1, keepdims=True)
            if np.any(tot <= 0):
                raise ValueError("each mixture row must have positive mass")
            mixture = mixture / tot
        return dataclasses.replace(self, mixture=mixture)

    def arch_config(self):
        """The ArchConfig this config serves (smoke-aware)."""
        return (get_smoke_config(self.arch) if self.smoke
                else get_config(self.arch))

    def request_mixture(self, n_clusters: int,
                        u_table: Optional[np.ndarray] = None) -> np.ndarray:
        """Materialize the (B, S) request mixture this config describes:
        an explicit ``mixture`` is broadcast/validated against S, a
        ``client`` index selects that row of the artifact's trained u
        table, and neither defaults to the uniform mixture."""
        b, s = self.batch, n_clusters
        if self.mixture is not None:
            m = np.asarray(self.mixture, np.float32)
            if m.shape[-1] != s:
                raise ValueError(
                    f"mixture has {m.shape[-1]} clusters, plane has {s}")
            return np.broadcast_to(m, (b, s)).copy() if m.ndim == 1 else m
        if self.client is not None:
            if u_table is None:
                raise ValueError(
                    "client= serving needs a u table (train with --save / "
                    "export_servable records it); pass mixture= instead"
                )
            if self.client >= u_table.shape[0]:
                raise ValueError(
                    f"client {self.client} out of range for u table with "
                    f"{u_table.shape[0]} clients"
                )
            row = np.asarray(u_table[self.client], np.float32)
            return np.broadcast_to(row, (b, s)).copy()
        return np.full((b, s), 1.0 / s, np.float32)
