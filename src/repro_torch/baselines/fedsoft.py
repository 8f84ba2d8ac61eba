"""FedSoft [Ruan & Joe-Wong 2022] — soft clustering with proximal local
updates. Each client trains ONE local model y_i on ALL of its data with a
proximal pull toward every cluster center (weighted by importance u_is);
centers are then importance-weighted aggregates of client models — over the
whole population (centralized) or the graph neighborhood (decentralized).

Appendix C of the FedSPD paper argues exactly this update is what biases
FedSoft's gradients toward a mixture of optima and breaks consensus in
low-connectivity DFL.

Both the center stack ``(S, N, X)`` and the client models y ``(N, X)``
are packed planes. The aggregation is S separate importance-weighted,
renormalised products ``W·diag(u_s)·y`` — an einsum in the JAX package,
outside any Pallas kernel — and stays ``torch.matmul`` here. Behind a
wire codec the client models y cross the wire: the aggregation runs on
the decoded values while each client keeps its own y exact.

On the pytree engine (``pack_spec=None``) the centers and y are trees of
``(S, N, ...)`` / ``(N, ...)`` leaves: the proximal pull is taken leaf by
leaf and added to the loss gradient for one SGD step (the JAX pytree
branch of ``local_sgd``), and the aggregation is the same products over
each leaf viewed as ``(N, -1)``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.baselines.common import init_planes, local_sgd
from repro_torch.core.clustering import mixture_coefficients
from repro_torch.core.packing import PackSpec, maybe_unpack
from repro_torch.utils.pytree import tree_map


class FedSoftState(NamedTuple):
    centers: torch.Tensor  # (S, N, X) each client's center estimates
    y: torch.Tensor        # (N, X) client local models
    u: torch.Tensor        # (N, S)
    ef: torch.Tensor | None = None  # (N, X) error-feedback residual on y


def init_state(gen: torch.Generator, model_init: Callable, n_clients: int,
               s_clusters: int, pack_spec: PackSpec | None) -> FedSoftState:
    centers = init_planes(gen, model_init, s_clusters * n_clients, pack_spec,
                          lead=(s_clusters, n_clients))
    y = init_planes(gen, model_init, n_clients, pack_spec)
    u = torch.full((n_clients, s_clusters), 1.0 / s_clusters,
                   device=gen.device)
    return FedSoftState(centers=centers, y=y, u=u)


def make_step(loss_fn: Callable, per_example_loss: Callable, w: torch.Tensor,
              *, tau: int, batch: int, s_clusters: int,
              prox_lambda: float = 0.1, pack_spec: PackSpec | None, channel=None):
    """``step(state, data, gen, lr, *, idx=None, comm_u=None) -> (state,
    {"u": u})``; ``w`` is the ``(N, N)`` aggregation matrix on the plane's
    device; ``channel`` runs y through a wire codec. Injectable: ``idx``
    ``(τ, N, batch)``, ``comm_u`` the codec's uniform rounding draw (else
    drawn from ``gen``)."""

    def step(state: FedSoftState, data, gen, lr, *, idx=None, comm_u=None):
        centers = state.centers
        with torch.no_grad():
            # importance: per-point min-loss counts (FedSoft Eq. 4)
            losses = per_example_loss(
                maybe_unpack(centers, pack_spec),
                {"x": data["inputs"], "y": data["targets"]})  # (S, N, M)
            u = mixture_coefficients(torch.argmin(losses, dim=0), s_clusters)
        def prox_grad(y):
            # λ Σ_s u_is (y_i − c_is), leaf by leaf on the pytree engine
            def pull(y_l, c_l):
                uu = u.T.reshape(u.T.shape + (1,) * (y_l.dim() - 1))  # (S, N, 1...)
                return prox_lambda * (uu * (y_l[None] - c_l.float())).sum(dim=0)

            return tree_map(pull, y, centers)

        y = local_sgd(loss_fn, state.y, data, gen, tau, batch, lr,
                      pack_spec=pack_spec, extra_grad=prox_grad, idx=idx)

        ef, y_tx = state.ef, y
        if channel is not None:
            y_tx, ef = channel.roundtrip(
                y, comm_u if comm_u is not None else gen, ef)

        # importance-weighted center aggregation over the neighborhood:
        # c_s[i] = Σ_j W_ij u_js y_j / Σ_j W_ij u_js
        wus = []
        for s in range(s_clusters):
            wu = w * u[None, :, s]
            wus.append(wu / wu.sum(dim=1, keepdim=True).clamp_min(1e-9))

        def aggregate(leaf):
            y32 = leaf.float().reshape(leaf.shape[0], -1)
            out = torch.stack([torch.matmul(wu, y32) for wu in wus])
            return out.reshape((s_clusters,) + leaf.shape).to(leaf.dtype)

        new = FedSoftState(centers=tree_map(aggregate, y_tx), y=y, u=u, ef=ef)
        return new, {"u": u}

    return step


def personalized_params(state: FedSoftState, pack_spec: PackSpec | None) -> dict:
    return maybe_unpack(state.y, pack_spec)
