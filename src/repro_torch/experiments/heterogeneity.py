"""Client-system heterogeneity: stragglers, availability and stale gossip.

The port's copy of the JAX package's engine, with its draws injectable:

- ``ClientSystemModel`` declares per-client compute speeds (explicit
  multipliers or a slow-client fraction), a per-round time budget with
  lognormal jitter (straggler timeouts), Bernoulli or two-state Markov
  availability, and a stale-gossip decay ``staleness_gamma``.
- ``het_round`` runs ONE round of it from the round's draws: normals ``z``
  (the jitter) and uniforms ``u`` (availability), each ``(N,)``, which
  ``draw_het`` makes on a generator's device (the JAX driver splits
  ``fold_in(key, round)`` into the two). It reads and returns tensors on
  one device and never syncs with the host, so a captured round runs it.
- ``apply_client_weights`` folds the per-client activity weights into the
  round's adjacency: an inactive client loses its row and column (it
  neither sends nor receives, and costs no bytes), a stale sender's column
  is scaled by ``gamma**staleness`` before ``fedspd_weight_matrix``
  normalizes the rows.
- ``masked_client_step`` carries an inactive client's state rows
  bit-untouched through the round, along the ``Method.cohort_axes``
  client-axis map.

The staleness counter rides ``HetCarry``: it resets to 0 on an exchange
and grows while a client is timed out or unavailable. A returning client
is down-weighted once by its age (staleness before the reset).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch


class HetCarry(NamedTuple):
    """Per-client heterogeneity state carried from round to round (the
    replay updates these tensors in place)."""

    stale: torch.Tensor  # (N,) int32: rounds since the last exchange
    avail: torch.Tensor  # (N,) fp32 Markov up/down state (1 = up)


def _check_prob(name: str, v: float) -> None:
    if not 0.0 <= float(v) <= 1.0:
        raise ValueError(f"ClientSystemModel.{name}={v!r} must be in [0, 1]")


@dataclasses.dataclass(frozen=True)
class ClientSystemModel:
    """Per-client compute-speed / availability / staleness model, resolved
    by the runner through ``Scenario.system``.

    speed           explicit (N,) speed multipliers (1.0 = nominal, 0.25 =
                    4x slower), or None to derive from ``slow_fraction``
    slow_fraction   fraction of clients that are slow (round(f·N), chosen
                    on the host from ``seed``)
    slow_factor     slowdown of the slow clients (>= 1)
    time_budget     per-round budget in nominal round units; a client whose
                    round time 1/speed (× jitter) exceeds it straggles
                    this round. 0 disables timeouts
    jitter          lognormal sigma on the per-round compute time
    p_unavailable   i.i.d. Bernoulli per-round unavailability
    markov          (p_fail, p_recover) two-state availability chain;
                    excludes ``p_unavailable``
    staleness_gamma stale-gossip decay in (0, 1] (1.0 = off)
    seed            the slow-client choice and the runner's stream of
                    timeout and availability draws
    """

    speed: Any = None
    slow_fraction: float = 0.0
    slow_factor: float = 4.0
    time_budget: float = 0.0
    jitter: float = 0.0
    p_unavailable: float = 0.0
    markov: Optional[tuple] = None
    staleness_gamma: float = 1.0
    seed: int = 0

    def __post_init__(self):
        _check_prob("slow_fraction", self.slow_fraction)
        _check_prob("p_unavailable", self.p_unavailable)
        if self.markov is not None:
            if len(self.markov) != 2:
                raise ValueError(
                    "ClientSystemModel.markov must be (p_fail, p_recover);"
                    f" got {self.markov!r}")
            _check_prob("markov[0] (p_fail)", self.markov[0])
            _check_prob("markov[1] (p_recover)", self.markov[1])
            if self.p_unavailable > 0.0:
                raise ValueError(
                    "ClientSystemModel: p_unavailable and markov are "
                    "mutually exclusive availability models")
        if self.slow_factor < 1.0:
            raise ValueError(
                f"ClientSystemModel.slow_factor={self.slow_factor!r} "
                "must be >= 1 (it is a slowdown)")
        if self.time_budget < 0.0:
            raise ValueError(
                f"ClientSystemModel.time_budget={self.time_budget!r} "
                "must be >= 0 (0 disables straggler timeouts)")
        if self.jitter < 0.0:
            raise ValueError(f"ClientSystemModel.jitter={self.jitter!r} must be >= 0")
        if not 0.0 < float(self.staleness_gamma) <= 1.0:
            raise ValueError(
                "ClientSystemModel.staleness_gamma="
                f"{self.staleness_gamma!r} must be in (0, 1]")

    @property
    def has_stragglers(self) -> bool:
        return self.time_budget > 0.0

    @property
    def has_availability(self) -> bool:
        return self.p_unavailable > 0.0 or self.markov is not None

    def resolve_speeds(self, n: int) -> np.ndarray:
        """The (N,) speed multipliers, on the host: explicit ``speed`` wins;
        otherwise round(slow_fraction·N) clients chosen from ``seed`` run
        at 1/slow_factor."""
        if self.speed is not None:
            arr = np.asarray(self.speed, dtype=np.float32)
            if arr.shape != (n,):
                raise ValueError(
                    f"ClientSystemModel.speed must have shape ({n},); got {arr.shape}")
            if (arr <= 0.0).any():
                raise ValueError("ClientSystemModel.speed multipliers must be positive")
            return arr
        speeds = np.ones(n, dtype=np.float32)
        k = int(round(float(self.slow_fraction) * n))
        if k:
            rng = np.random.default_rng(self.seed)
            idx = rng.choice(n, size=k, replace=False)
            speeds[idx] = np.float32(1.0 / self.slow_factor)
        return speeds

    def init_carry(self, n: int, device: torch.device | str = "cpu") -> HetCarry:
        """Round 0's carry on ``device``: nobody stale, everybody up."""
        return HetCarry(stale=torch.zeros((n,), dtype=torch.int32, device=device),
                        avail=torch.ones((n,), dtype=torch.float32, device=device))


def draw_het(gen: torch.Generator, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One round's draws on ``gen``'s device: (N,) standard normals (the
    jitter) and (N,) uniforms in [0, 1) (availability)."""
    z = torch.randn((n,), generator=gen, device=gen.device)
    u = torch.rand((n,), generator=gen, device=gen.device)
    return z, u


def het_round(model: ClientSystemModel, speeds: torch.Tensor, carry: HetCarry,
              z: torch.Tensor, u: torch.Tensor) -> tuple[HetCarry, torch.Tensor]:
    """One round of the heterogeneity process: (carry', weights).

    ``weights`` is the (N,) activity vector: 0 for a client that timed out
    or is unavailable, ``gamma**staleness`` (staleness before this round's
    reset) for one that exchanges. ``z`` are the round's normals, ``u`` its
    uniforms (``draw_het``); a model without jitter or availability does
    not read them."""
    if model.has_stragglers:
        t = 1.0 / speeds
        if model.jitter > 0.0:
            t = t * torch.exp(model.jitter * z)
        timely = (t <= model.time_budget).float()
    else:
        timely = torch.ones_like(carry.avail)
    if model.markov is not None:
        p_fail, p_recover = (float(p) for p in model.markov)
        avail = torch.where(carry.avail > 0.0, u >= p_fail, u < p_recover).float()
    elif model.p_unavailable > 0.0:
        avail = (u >= model.p_unavailable).float()
    else:
        avail = torch.ones_like(carry.avail)
    active = timely * avail
    gamma = float(model.staleness_gamma)
    if gamma < 1.0:
        base = torch.full_like(active, gamma)
        w = active * torch.pow(base, carry.stale.float())
    else:
        w = active
    stale = torch.where(active > 0.0, torch.zeros_like(carry.stale),
                        carry.stale + 1).to(torch.int32)
    return HetCarry(stale=stale, avail=avail), w


def apply_client_weights(adj: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Fold per-client activity weights into the round's adjacency: an
    inactive client (w == 0) loses its row and column, an active sender's
    column is scaled by its weight (``fedspd_weight_matrix`` normalizes the
    rows; ``round_comm_bytes`` binarizes the links)."""
    recv = (w > 0.0).to(adj.dtype)
    return adj * recv[..., :, None] * w.to(adj.dtype)[..., None, :]


def restore_inactive(old, new, axes, keep: torch.Tensor):
    """Carry inactive clients' state rows bit-untouched through a round.

    ``old``/``new`` are same-shaped state namedtuples; ``axes`` maps each
    field to its client axis (None: a global field, taken from ``new``);
    ``keep`` is the (N,) active mask. A ``torch.where`` over the whole
    field, not a gather: the count of inactive clients varies by round and
    a captured round cannot gather a varying count."""

    def keep_old(o, v, ax):
        if o is None or ax is None:
            return v
        shape = (1,) * ax + (-1,) + (1,) * (o.dim() - ax - 1)
        return torch.where(keep.reshape(shape), v, o)

    return type(old)(*(keep_old(o, v, a) for o, v, a in zip(old, new, axes)))


def _snapshot(state, axes):
    """Copies of the client-axis fields: the round step writes its mixed
    rows into the plane in place (and a cohort scatters into every
    client-axis field), so the old rows must be copied before it runs."""
    return type(state)(*(v.clone() if isinstance(v, torch.Tensor) and ax is not None
                         else v for v, ax in zip(state, axes)))


def masked_client_step(step: Callable, axes) -> Callable:
    """Run a dynamic-graph step under per-client activity weights.

    ``axes`` maps each state field to its client axis (the
    ``Method.cohort_axes`` contract). The wrapper folds this round's
    weights (the LAST extra) into the adjacency (``apply_client_weights``),
    runs the wrapped step unchanged on every client, then restores the
    inactive clients' rows from a copy taken before the step
    (``restore_inactive``): a straggler's row is carried, not recomputed.
    Its generator draws still advance, as the JAX key does.

    Wraps outside the cohort wrapper: inactive cohort members are masked
    out of the ``(K, K)`` minor and their scattered rows restored here."""

    def steph(state, train, gen, lr, adj, *rest):
        *inner, aw = rest
        old = _snapshot(state, axes)
        new, aux = step(state, train, gen, lr, apply_client_weights(adj, aw), *inner)
        return restore_inactive(old, new, axes, aw > 0.0), aux

    return steph
