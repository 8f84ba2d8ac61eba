"""IFCA [Ghosh et al. 2020] — hard clustering: each client picks the single
cluster whose model has the lowest loss on its full local data, trains that
model on ALL its data, and (decentralized variant) averages with neighbors
that picked the same cluster. No mixtures: the paper's hard-clustering
baseline.

The centers live on the packed ``(S, N, X)`` plane: the gather of the
chosen models is one advanced-index copy, local SGD one batched update
over ``(N, X)``, the same-choice average ``core/gossip.mix_dense`` (one
``gossip_mix_flat`` launch), and the scatter writes the mixed rows back
into the plane IN PLACE: a state passed to the step must not be reused.
Behind a wire codec the chosen-model slab is encoded and decoded
(``Channel.roundtrip``) before the mix; with error feedback the residual
rides ``state.ef``.

On the pytree engine (``pack_spec=None``) the centers are a tree of
``(S, N, ...)`` leaves: the gather and the in-place scatter run leaf by
leaf, and the same-choice average launches ``gossip_mix_flat`` once per
leaf (``core/gossip.mix_dense``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.baselines.common import init_planes, local_sgd
from repro_torch.core.gossip import GossipSpec, mix_dense
from repro_torch.core.packing import PackSpec, maybe_unpack
from repro_torch.utils.pytree import tree_gather_rows, tree_scatter_rows_


class IFCAState(NamedTuple):
    centers: torch.Tensor  # (S, N, X) packed plane (a tree of (S, N, ...) leaves)
    choice: torch.Tensor   # (N,) int64 hard assignment
    ef: torch.Tensor | None = None  # (N, X) error-feedback residual (comm)


def init_state(gen: torch.Generator, model_init: Callable, n_clients: int,
               s_clusters: int, pack_spec: PackSpec | None) -> IFCAState:
    centers = init_planes(gen, model_init, s_clusters * n_clients, pack_spec,
                          lead=(s_clusters, n_clients))
    return IFCAState(centers=centers,
                     choice=torch.zeros((n_clients,), dtype=torch.int64,
                                        device=gen.device))


def make_step(loss_fn: Callable, per_example_loss: Callable,
              gossip: GossipSpec, *, tau: int, batch: int,
              pack_spec: PackSpec | None, channel=None):
    """``step(state, data, gen, lr, *, idx=None, comm_u=None) -> (state,
    {"choice"})``; ``channel`` runs the transmitted slab through a wire
    codec. Injectable: ``idx`` ``(τ, N, batch)``, ``comm_u`` the codec's
    uniform rounding draw (else drawn from ``gen``)."""

    adj_dev: dict = {}  # the static adjacency, moved to the device once

    def step(state: IFCAState, data, gen, lr, *, idx=None, comm_u=None):
        plane = state.centers
        dev = state.choice.device
        if dev not in adj_dev:
            adj_dev[dev] = torch.as_tensor(gossip.adj, dtype=torch.float32, device=dev)
        with torch.no_grad():
            # hard cluster estimation on the full local dataset: (S, N)
            losses = per_example_loss(
                maybe_unpack(plane, pack_spec),
                {"x": data["inputs"], "y": data["targets"]}).mean(dim=-1)
        choice = torch.argmin(losses, dim=0)  # ties: the lowest index
        c_sel = local_sgd(loss_fn, tree_gather_rows(plane, choice),
                          data, gen, tau, batch, lr, pack_spec=pack_spec, idx=idx)
        # same-choice neighborhood averaging (decentralized IFCA); the
        # transmitted chosen-model slab goes through the wire codec
        ef = state.ef
        if channel is not None:
            c_sel, ef = channel.roundtrip(
                c_sel, comm_u if comm_u is not None else gen, ef)
            c_sel = c_sel.contiguous()
        mixed = mix_dense(gossip, c_sel, choice, adj=adj_dev[dev])
        tree_scatter_rows_(plane, choice, mixed)
        return IFCAState(centers=plane, choice=choice, ef=ef), {"choice": choice}

    return step


def personalized_params(state: IFCAState, pack_spec: PackSpec | None) -> dict:
    return maybe_unpack(tree_gather_rows(state.centers, state.choice), pack_spec)
