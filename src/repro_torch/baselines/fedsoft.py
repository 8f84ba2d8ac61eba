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
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.baselines.common import init_planes, local_sgd
from repro_torch.core.clustering import mixture_coefficients
from repro_torch.core.packing import PackSpec, unpack


class FedSoftState(NamedTuple):
    centers: torch.Tensor  # (S, N, X) each client's center estimates
    y: torch.Tensor        # (N, X) client local models
    u: torch.Tensor        # (N, S)
    ef: torch.Tensor | None = None  # (N, X) error-feedback residual on y


def init_state(gen: torch.Generator, model_init: Callable, n_clients: int,
               s_clusters: int, pack_spec: PackSpec) -> FedSoftState:
    centers = init_planes(gen, model_init, s_clusters * n_clients, pack_spec)
    y = init_planes(gen, model_init, n_clients, pack_spec)
    u = torch.full((n_clients, s_clusters), 1.0 / s_clusters,
                   device=centers.device)
    return FedSoftState(centers=centers.view(s_clusters, n_clients, -1), y=y,
                        u=u)


def make_step(loss_fn: Callable, per_example_loss: Callable, w: torch.Tensor,
              *, tau: int, batch: int, s_clusters: int,
              prox_lambda: float = 0.1, pack_spec: PackSpec, channel=None):
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
                unpack(centers, pack_spec),
                {"x": data["inputs"], "y": data["targets"]})  # (S, N, M)
            u = mixture_coefficients(torch.argmin(losses, dim=0), s_clusters)
        uu = u.T[:, :, None]  # (S, N, 1)

        def prox_grad(y):
            # λ Σ_s u_is (y_i − c_is)
            return prox_lambda * (uu * (y[None] - centers.float())).sum(dim=0)

        y = local_sgd(loss_fn, state.y, data, gen, tau, batch, lr,
                      pack_spec=pack_spec, extra_grad=prox_grad, idx=idx)

        ef, y_tx = state.ef, y
        if channel is not None:
            y_tx, ef = channel.roundtrip(
                y, comm_u if comm_u is not None else gen, ef)

        # importance-weighted center aggregation over the neighborhood:
        # c_s[i] = Σ_j W_ij u_js y_j / Σ_j W_ij u_js
        y32 = y_tx.float()
        out = []
        for s in range(s_clusters):
            wu = w * u[None, :, s]
            wu = wu / wu.sum(dim=1, keepdim=True).clamp_min(1e-9)
            out.append(torch.matmul(wu, y32))
        new = FedSoftState(centers=torch.stack(out).to(y.dtype), y=y, u=u, ef=ef)
        return new, {"u": u}

    return step


def personalized_params(state: FedSoftState, pack_spec: PackSpec) -> dict:
    return unpack(state.y, pack_spec)
