"""Round-metric primitives of the telemetry streams.

Plain torch functions on tensors, in fp32, over trailing axes only, so a
leading batch axis passes through (``(k, N, S)`` weights, ``(k, S, N, X)``
planes, ``(k, N, N)`` adjacencies). None of them syncs with the host: they
run inside a captured round.

``make_collector`` builds the closure the experiment runner
(experiments/runner.py) calls inside each round, after the step: on the
loop in the step's own call, on the replay inside the captured CUDA graph,
so every stream is the same ops on the same inputs on both engines.
"""
from __future__ import annotations

import math

import torch

from repro_torch.telemetry.config import TelemetryConfig
from repro_torch.utils.pytree import tree_leaves

# the stream names in export order (the JSONL schema)
STREAMS = ("logical_bytes", "wire_bytes", "u_entropy", "u_drift",
           "consensus", "degree", "spectral_gap", "stale_hist",
           "n_inactive", "density", "mask_churn")


def stream_shapes(cfg: TelemetryConfig, n_clusters: int) -> dict:
    """Each stream's per-round shape: ``(S,)`` for ``consensus``, ``(B,)``
    for ``stale_hist``, a scalar for the rest."""
    tails = {"consensus": (int(n_clusters),), "stale_hist": (int(cfg.staleness_bins),)}
    return {name: tails.get(name, ()) for name in STREAMS}


def mixture_entropy(u: torch.Tensor) -> torch.Tensor:
    """Mean per-client entropy of the (..., N, S) soft cluster weights: 0
    for hard assignments, log(S) at the uniform mixture."""
    p = u.float()
    h = -torch.where(p > 0.0, p * torch.log(p), p.new_zeros(())).sum(-1)
    return h.mean(-1)


def mixture_drift(u_old: torch.Tensor, u_new: torch.Tensor) -> torch.Tensor:
    """Frobenius norm of the soft-assignment update ‖u_t − u_{t−1}‖."""
    d = u_new.float() - u_old.float()
    return torch.sqrt((d * d).sum((-2, -1)))


def consensus_residual(plane: torch.Tensor) -> torch.Tensor:
    """Per-cluster consensus residual on a (..., S, N, X) plane:
    ‖C_i − mean_i(C)‖² summed over clients and parameters, / N (the
    normalization of core/fedspd's per-cluster consensus metric). Every
    cluster in one reduction."""
    p32 = plane.float()
    mean = p32.mean(-2, keepdim=True)
    return torch.square(p32 - mean).sum((-2, -1)) / plane.shape[-2]


def _off_diagonal_links(adj: torch.Tensor) -> tuple:
    """The binarized adjacency without self loops, and the identity."""
    eye = torch.eye(adj.shape[-1], dtype=torch.float32, device=adj.device)
    return (adj > 0.0).float() * (1.0 - eye), eye


def effective_degree(adj: torch.Tensor) -> torch.Tensor:
    """Mean degree of the binarized effective (..., N, N) adjacency, after
    dropout and the activity weights zeroed their links."""
    a, _ = _off_diagonal_links(adj)
    return a.sum((-2, -1)) / adj.shape[-1]


def spectral_gap_proxy(adj: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """1 − ρ proxy for the Metropolis mixing matrix of the effective
    adjacency, where ρ = max |eigenvalue ≠ 1| governs gossip convergence.

    Builds the symmetric doubly-stochastic Metropolis W (w_ij = a_ij / (1 +
    max(d_i, d_j)), the diagonal takes the deficit), deflates the all-ones
    eigenvector and runs ``iters`` fixed power steps from ``linspace(-1,
    1, N)``. An empty effective graph (everyone isolated) reports 0."""
    n = adj.shape[-1]
    a, eye = _off_diagonal_links(adj)
    deg = a.sum(-1)
    mx = torch.maximum(deg[..., :, None], deg[..., None, :])
    w = a / (1.0 + mx)
    w = w + eye * (1.0 - w.sum(-1, keepdim=True))
    v = torch.linspace(-1.0, 1.0, n, dtype=torch.float32,
                       device=adj.device).expand(adj.shape[:-1])
    # ρ starts at 0, as JAX's does (``iters=0`` reports a gap of 1), and is
    # then the last step's (JAX's loop computes it every step; XLA drops
    # all but the last)
    rho = torch.zeros(adj.shape[:-2], dtype=torch.float32, device=adj.device)
    for _ in range(int(iters)):
        v = v - v.mean(-1, keepdim=True)   # deflate the ones vector
        norm = torch.sqrt((v * v).sum(-1, keepdim=True))
        v = v / torch.clamp_min(norm, 1e-12)
        v = torch.matmul(w, v[..., None])[..., 0]
    if iters > 0:
        rho = torch.sqrt((v * v).sum(-1))
    return torch.clamp_min(1.0 - rho, 0.0)


def staleness_histogram(stale: torch.Tensor, bins: int) -> torch.Tensor:
    """(..., N) integer staleness counters -> (..., bins) fp32 counts: exact
    bins for staleness 0..bins-2 plus an overflow bin for >= bins-1."""
    clipped = torch.clamp(stale, 0, bins - 1)
    edges = torch.arange(bins, dtype=clipped.dtype, device=clipped.device)
    return (clipped[..., None] == edges).float().sum(-2)


def inactive_count(weights: torch.Tensor) -> torch.Tensor:
    """Clients contributing nothing this round (stragglers and offline):
    zero entries of the (..., N) activity-weight vector."""
    return (weights <= 0.0).float().sum(-1)


def mask_density(mask: torch.Tensor) -> torch.Tensor:
    """Mean active fraction of the (..., N, X) sparse masks: constant by
    construction under the exact-count RigL update (core/sparse), so a
    drifting stream is the regression signal."""
    return mask.float().mean((-2, -1))


def mask_churn(mask_old: torch.Tensor, mask_new: torch.Tensor) -> torch.Tensor:
    """Fraction of coordinates whose mask bit flipped this round: 0 on
    frozen rounds, 2·prune_rate·density at a full RigL update."""
    return (mask_new.float() - mask_old.float()).abs().mean((-2, -1))


def centers_lead(centers, batch_ndim: int = 0):
    """The ``(S, N)`` lead (with ``batch_ndim`` leading seed axes) that
    ``flatten_centers`` would give ``centers``, or None where its leaves
    disagree on it. Reads shapes only."""
    leaves = tree_leaves(centers)
    if not leaves or not all(isinstance(leaf, torch.Tensor) for leaf in leaves):
        return None
    lead = tuple(leaves[0].shape[:batch_ndim + 2])
    if len(lead) < batch_ndim + 2 or any(tuple(leaf.shape[:batch_ndim + 2]) != lead
                                         for leaf in leaves):
        return None
    return lead


def flatten_centers(centers, batch_ndim: int = 0) -> torch.Tensor:
    """Ravel a tree of (S, N, ...) center leaves (with ``batch_ndim``
    leading seed axes), in the pytree engine's sorted-key leaf order, into
    one (..., S, N, X) plane; a plane passes through without a copy.
    Raises on leaves that do not share the (S, N) lead."""
    leaves = tree_leaves(centers)
    if len(leaves) == 1 and leaves[0].dim() == batch_ndim + 3:
        return leaves[0]
    lead = centers_lead(centers, batch_ndim)
    if lead is None:
        raise ValueError("centers leaves disagree on (S, N) structure")
    return torch.cat([leaf.reshape(*lead, -1) for leaf in leaves], dim=-1)


def make_collector(cfg: TelemetryConfig, *, batch_shape: tuple = (),
                   n_clusters: int, n_clients: int, wire_ratio: float = 1.0,
                   per_round_bytes: float | None = None,
                   has_u: bool = True, has_plane: bool = True,
                   has_mask: bool = False):
    """Build the per-round collection closure the runner calls in the round.

    ``collect(old, new, adj, weights=None, stale=None)`` returns the
    {stream: tensor} dict for ONE round. ``old`` holds what the round
    replaced (``u``, ``comm_bytes``, ``mask``: copies taken before the step,
    which updates some of them in place), ``new`` the state after it.
    ``adj`` is the adjacency the step mixed over (after dropout and the
    activity weights), on the run's device; ``weights``/``stale`` are the
    activity vector and the staleness counters after the round (None
    without a system model: every client active, every count 0).
    ``per_round_bytes`` is the static round cost of a method whose bytes
    are not tracked in its state (then ``comm_bytes`` is not read).

    Every output has its full per-seed shape (scalars broadcast to
    ``batch_shape``), and a stream whose input is missing is a NaN of that
    shape.
    """
    bshape = tuple(batch_shape)
    s, n = int(n_clusters), int(n_clients)
    bins = int(cfg.staleness_bins)
    wire = float(torch.tensor(wire_ratio, dtype=torch.float32))

    def collect(old, new, adj, weights=None, stale=None) -> dict:
        def full(v, tail=()):
            if isinstance(v, torch.Tensor):
                return v.float().expand(bshape + tail)
            return adj.new_full(bshape + tail, v, dtype=torch.float32)

        logical = full(per_round_bytes if per_round_bytes is not None
                       else new.comm_bytes - old.comm_bytes)
        out = {
            "logical_bytes": logical,
            "wire_bytes": logical * wire,
            "u_entropy": full(mixture_entropy(new.u) if has_u else math.nan),
            "u_drift": full(mixture_drift(old.u, new.u) if has_u else math.nan),
        }
        if has_plane:
            plane = flatten_centers(new.centers, batch_ndim=len(bshape))
            out["consensus"] = full(consensus_residual(plane), (s,))
        else:
            out["consensus"] = full(math.nan, (s,))
        out["degree"] = full(effective_degree(adj))
        out["spectral_gap"] = full(spectral_gap_proxy(adj, cfg.power_iters)
                                   if cfg.spectral_gap else math.nan)
        if stale is None:
            stale = torch.zeros((n,), dtype=torch.int32, device=adj.device)
        out["stale_hist"] = full(staleness_histogram(stale, bins), (bins,))
        out["n_inactive"] = full(inactive_count(weights) if weights is not None else 0.0)
        if has_mask:
            out["density"] = full(mask_density(new.mask))
            out["mask_churn"] = full(mask_churn(old.mask, new.mask))
        else:
            out["density"] = full(math.nan)
            out["mask_churn"] = full(math.nan)
        return out

    return collect
