"""DisPFL-style decentralized sparse training on the packed plane.

Each client trains a sparse subnetwork under a fixed parameter budget
(``density``): one binary mask per client over the packed X axis, applied
to whichever cluster model it trains this round. A RigL-style update
(Evci et al., 2020) periodically drops the smallest-magnitude active
weights and regrows as many dead coordinates where the dense gradient is
largest.

- Counts are static ints of (density, prune_rate, X): ``k_active`` ones
  per client row, always, so density holds exactly.
- Prune keeps the top ``k_active - n_prune`` of ``|w|`` on the active
  support; regrow takes the top ``n_prune`` scores among the coordinates
  inactive before the update, so the two are disjoint.
- Every top-k breaks ties toward the lower index, as ``jax.lax.top_k``
  does: a stable descending sort, the same choice on the CPU and on the
  card.
- ``density >= 1.0`` turns the subsystem off: callers take the dense code
  paths, bit for bit.

The random inputs are injectable: ``init_masks`` takes its uniform scores
and ``rigl_update`` its ``"random"`` regrow scores as a
``torch.Generator`` or as the ``(n, x)`` tensor itself.
"""
from __future__ import annotations

import dataclasses

import torch

_REGROW_MODES = ("rigl", "random")


@dataclasses.dataclass(frozen=True)
class SparseConfig:
    """density       fraction of the packed X axis each client keeps
                  active, in (0, 1]; 1.0 means dense (subsystem off)
    prune_rate    fraction of the active set pruned (and regrown) per mask
                  update, in [0, 1)
    regrow        "rigl" (where |dense grad| is largest) or "random"
    update_every  rounds between mask updates"""

    density: float = 1.0
    prune_rate: float = 0.2
    regrow: str = "rigl"
    update_every: int = 10

    def __post_init__(self):
        if not 0.0 < float(self.density) <= 1.0:
            raise ValueError(f"density must be in (0, 1], got {self.density}")
        if not 0.0 <= float(self.prune_rate) < 1.0:
            raise ValueError(
                f"prune_rate must be in [0, 1), got {self.prune_rate}")
        if self.regrow not in _REGROW_MODES:
            raise ValueError(
                f"regrow must be one of {_REGROW_MODES}, got {self.regrow!r}")
        if int(self.update_every) < 1:
            raise ValueError(
                f"update_every must be >= 1, got {self.update_every}")

    @property
    def enabled(self) -> bool:
        """Density 1.0 routes callers to the dense code paths."""
        return float(self.density) < 1.0

    def k_active(self, x: int) -> int:
        """Active coordinates per client row."""
        return min(x, max(1, int(round(float(self.density) * x))))

    def n_prune(self, x: int) -> int:
        """Coordinates pruned (= regrown) per update, capped by the dead
        coordinates (regrow draws only from those)."""
        k = self.k_active(x)
        return min(int(float(self.prune_rate) * k), x - k)

    def update_due(self, rnd: int) -> bool:
        """Whether round ``rnd`` updates the mask: every ``update_every``
        rounds, never at round 0 (the initial masks hold for the first
        window)."""
        return rnd > 0 and rnd % int(self.update_every) == 0


def top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices ``(..., k)`` int64 of the k largest scores along the last
    axis, ties to the lower index (``jax.lax.top_k``'s order)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def _uniform(key, shape) -> torch.Tensor:
    """A ``torch.Generator``'s uniform draw of ``shape`` on its device, or
    an injected one."""
    if isinstance(key, torch.Generator):
        return torch.rand(shape, generator=key, device=key.device)
    if isinstance(key, torch.Tensor):
        if tuple(key.shape) != tuple(shape):
            raise ValueError(f"scores {tuple(key.shape)}, expected {tuple(shape)}")
        return key.float()
    raise ValueError(
        f"pass a torch.Generator or the uniform scores of shape {tuple(shape)}")


def _one_hot_rows(idx: torch.Tensor, x: int) -> torch.Tensor:
    out = torch.zeros(idx.shape[:-1] + (x,), dtype=torch.float32, device=idx.device)
    return out.scatter_(-1, idx, 1.0)


def init_masks(key, n: int, x: int, cfg: SparseConfig) -> torch.Tensor:
    """``(n, x)`` fp32 {0,1} masks with exactly ``k_active`` ones per row:
    the top-k of uniform scores. ``key`` is a generator or the ``(n, x)``
    scores; the masks land on its device. At density 1.0, all ones and no
    draw."""
    k = cfg.k_active(x)
    if k >= x:
        return torch.ones((n, x), dtype=torch.float32, device=key.device)
    return _one_hot_rows(top_k(_uniform(key, (n, x)), k), x)


def rigl_update(mask: torch.Tensor, weights: torch.Tensor,
                grads: torch.Tensor | None, key,
                cfg: SparseConfig) -> torch.Tensor:
    """One unconditional RigL prune/regrow pass over ``(n, x)`` rows: keep
    the ``k_active - n_prune`` largest |w| of the active support, regrow
    ``n_prune`` of the inactive coordinates (largest |grad| for "rigl",
    largest of the uniform scores ``key`` for "random"). Every row keeps
    exactly ``k_active`` ones."""
    n, x = mask.shape
    n_prune = cfg.n_prune(x)
    if n_prune == 0:
        return mask
    n_keep = cfg.k_active(x) - n_prune
    neg = float("-inf")   # a scalar, not a tensor: nothing crosses from the host
    active = mask > 0
    kept = _one_hot_rows(top_k(torch.where(active, weights.float().abs(), neg),
                               n_keep), x)
    if cfg.regrow == "rigl":
        grow = grads.float().abs()
    else:
        grow = _uniform(key, (n, x)).to(mask.device)
    grown = _one_hot_rows(top_k(torch.where(active, neg, grow), n_prune), x)
    return kept + grown


def maybe_update_mask(mask: torch.Tensor, weights: torch.Tensor,
                      grads: torch.Tensor | None, key, rnd: int,
                      cfg: SparseConfig) -> torch.Tensor:
    """``rigl_update`` on the rounds ``cfg.update_due`` names; the mask
    itself otherwise."""
    if not cfg.update_due(rnd):
        return mask
    return rigl_update(mask, weights, grads, key, cfg)


def column_activity(mask: torch.Tensor) -> torch.Tensor:
    """``(..., n, x)`` masks -> ``(..., x)`` fp32 {0,1}: a column is live
    iff any client keeps it (the sparse mix's skip granularity)."""
    return (mask.sum(dim=-2) > 0).float()
