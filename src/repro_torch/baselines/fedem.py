"""FedEM [Marfoq et al. 2021] — federated EM over a mixture of S
distributions. Every client trains ALL S cluster models every round
(responsibility-weighted) and exchanges ALL S models: per-round computation
and communication are S× FedSPD's (the comparison the paper draws in §6.3).

Decentralized variant: each of the S stacks is gossip-averaged with the
static Metropolis matrix. Personalized prediction = u-weighted mixture.

The whole ``(S, N, X)`` center stack is ONE packed plane. The E-step is
one forward of all S×N models on all N×M points; the M-step runs the S
clusters' responsibility-weighted SGD batched into each forward (the JAX
package vmaps the same independent per-cluster updates); the all-S
exchange is one ``gossip_mix_stack`` launch. Behind a wire codec every
one of the S messages is encoded and decoded before that launch; with
error feedback the residual covers the whole stack.

On the pytree engine (``pack_spec=None``) the centers are a tree of
``(S, N, ...)`` leaves: the M-step takes per-leaf gradients and the plain
step p − lr·g, and the exchange launches ``gossip_mix_stack`` (kernel 3)
once per leaf, viewed as ``(S, N, -1)``. The JAX pytree step mixes each
cluster's leaves with its reference einsum (``jax.vmap`` of
``gossip_avg``, whatever the backend); the kernel computes the same
product and agrees with it to 1e-5.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.baselines.common import gossip_avg_comm, gossip_avg_stack, init_planes
from repro_torch.core.packing import PackSpec, grad, maybe_unpack, mixture
from repro_torch.optim.sgd import sgd_update
from repro_torch.utils.pytree import tree_map


class FedEMState(NamedTuple):
    centers: torch.Tensor  # (S, N, X) packed plane (a tree of (S, N, ...) leaves)
    u: torch.Tensor        # (N, S)
    ef: torch.Tensor | None = None  # (S, N, X) error-feedback residual (comm)


def init_state(gen: torch.Generator, model_init: Callable, n_clients: int,
               s_clusters: int, pack_spec: PackSpec | None) -> FedEMState:
    """Independent random init per (cluster, client) pair, packed (or a
    tree with ``pack_spec=None``)."""
    centers = init_planes(gen, model_init, s_clusters * n_clients, pack_spec,
                          lead=(s_clusters, n_clients))
    u = torch.full((n_clients, s_clusters), 1.0 / s_clusters,
                   device=gen.device)
    return FedEMState(centers=centers, u=u)


def e_step(per_example_loss: Callable, plane, u: torch.Tensor,
           data: dict, pack_spec: PackSpec | None) -> torch.Tensor:
    """Responsibilities r ``(S, N, M)`` ∝ u_is · exp(-ℓ(c_is; d)): a
    softmax over S of log(max(u, 1e-12)) − loss."""
    losses = per_example_loss(maybe_unpack(plane, pack_spec),
                              {"x": data["inputs"], "y": data["targets"]})
    logr = torch.log(u.clamp_min(1e-12)).T[:, :, None] - losses
    return torch.softmax(logr, dim=0)


def make_step(per_example_loss: Callable, w: torch.Tensor, *, tau: int,
              batch: int, s_clusters: int, pack_spec: PackSpec | None, channel=None):
    """``step(state, data, gen, lr, *, idx=None, comm_u=None) -> (state,
    {"u": u})``; ``w`` is the ``(N, N)`` mixing matrix on the plane's
    device; ``channel`` runs all S messages through a wire codec.
    Injectable: ``idx`` ``(S, τ, N, batch)``, cluster s's batch indices at
    each of its τ M-step steps; ``comm_u`` the codec's uniform rounding
    draw ``(S, N, Xp/block, block)`` (else drawn from ``gen``)."""

    def weighted_loss(params, b):
        # Σ ℓ·r / max(Σ r, 1e-6) per (cluster, client) row
        rw = b["rw"]
        return ((per_example_loss(params, b) * rw).sum(dim=-1)
                / rw.sum(dim=-1).clamp_min(1e-6))

    def step(state: FedEMState, data, gen, lr, *, idx=None, comm_u=None):
        x, y = data["inputs"], data["targets"]
        n, m = x.shape[0], x.shape[1]
        with torch.no_grad():
            r = e_step(per_example_loss, state.centers, state.u, data,
                       pack_spec)
        u = r.mean(dim=2).T.contiguous()  # (N, S)

        # M-step: τ responsibility-weighted SGD steps for EVERY cluster
        # model, the S clusters batched as one (S, N, X) slab
        rows = torch.arange(n, device=x.device)[None, :, None]
        p = state.centers
        for t in range(tau):
            it = (idx[:, t] if idx is not None else
                  torch.randint(0, m, (s_clusters, n, batch), generator=gen,
                                device=gen.device))
            b = {"x": x[rows, it], "y": y[rows, it],
                 "rw": torch.gather(r, 2, it)}
            p = tree_map(lambda pp, g: sgd_update(pp, g, lr), p,
                         grad(weighted_loss, p, b, pack_spec))

        # exchange ALL S models (the S× communication cost): one launch,
        # or one a leaf on the pytree engine
        if channel is None:
            return FedEMState(centers=gossip_avg_stack(p, w), u=u, ef=state.ef), {"u": u}
        p, ef = gossip_avg_comm(p, w, channel=channel,
                                key=comm_u if comm_u is not None else gen, ef=state.ef)
        return FedEMState(centers=p, u=u, ef=ef), {"u": u}

    return step


def personalize(state: FedEMState, pack_spec: PackSpec | None) -> dict:
    """The u-weighted PARAMETER mixture Σ_s u_is c_is (Eq.-(2) style), for
    export; accuracy uses the probability mixture instead."""
    return maybe_unpack(mixture(state.centers, state.u), pack_spec)


def mixture_predict(apply_fn: Callable, state: FedEMState, x: torch.Tensor,
                    pack_spec: PackSpec | None) -> torch.Tensor:
    """Per-client mixture prediction Σ_s u_is softmax(logits_is):
    x ``(N, B, d)`` -> probabilities ``(N, B, K)``."""
    logits = apply_fn(maybe_unpack(state.centers, pack_spec), x)  # (S, N, B, K)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("ns,snbk->nbk", state.u, probs)


def personalized_accuracy(apply_fn: Callable, state: FedEMState, data: dict,
                          pack_spec: PackSpec | None) -> torch.Tensor:
    """``(N,)`` accuracy of the argmax of each client's probability
    mixture."""
    probs = mixture_predict(apply_fn, state, data["inputs"], pack_spec)
    return (probs.argmax(dim=-1) == data["targets"]).float().mean(dim=-1)
