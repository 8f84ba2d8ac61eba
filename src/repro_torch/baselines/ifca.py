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
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.baselines.common import init_planes, local_sgd
from repro_torch.core.gossip import GossipSpec, mix_dense
from repro_torch.core.packing import PackSpec, unpack


class IFCAState(NamedTuple):
    centers: torch.Tensor  # (S, N, X) packed plane
    choice: torch.Tensor   # (N,) int64 hard assignment
    ef: torch.Tensor | None = None  # (N, X) error-feedback residual (comm)


def init_state(gen: torch.Generator, model_init: Callable, n_clients: int,
               s_clusters: int, pack_spec: PackSpec) -> IFCAState:
    plane = init_planes(gen, model_init, s_clusters * n_clients, pack_spec)
    return IFCAState(centers=plane.view(s_clusters, n_clients, -1),
                     choice=torch.zeros((n_clients,), dtype=torch.int64,
                                        device=plane.device))


def make_step(loss_fn: Callable, per_example_loss: Callable,
              gossip: GossipSpec, *, tau: int, batch: int,
              pack_spec: PackSpec, channel=None):
    """``step(state, data, gen, lr, *, idx=None, comm_u=None) -> (state,
    {"choice"})``; ``channel`` runs the transmitted slab through a wire
    codec. Injectable: ``idx`` ``(τ, N, batch)``, ``comm_u`` the codec's
    uniform rounding draw (else drawn from ``gen``)."""

    adj_dev: dict = {}  # the static adjacency, moved to the device once

    def step(state: IFCAState, data, gen, lr, *, idx=None, comm_u=None):
        plane = state.centers
        if plane.device not in adj_dev:
            adj_dev[plane.device] = torch.as_tensor(gossip.adj, dtype=torch.float32,
                                                    device=plane.device)
        with torch.no_grad():
            # hard cluster estimation on the full local dataset: (S, N)
            losses = per_example_loss(
                unpack(plane, pack_spec),
                {"x": data["inputs"], "y": data["targets"]}).mean(dim=-1)
        choice = torch.argmin(losses, dim=0)  # ties: the lowest index
        rows = torch.arange(choice.shape[0], device=plane.device)
        c_sel = local_sgd(loss_fn, plane[choice, rows], data, gen, tau,
                          batch, lr, pack_spec=pack_spec, idx=idx)
        # same-choice neighborhood averaging (decentralized IFCA); the
        # transmitted chosen-model slab goes through the wire codec
        ef = state.ef
        if channel is not None:
            c_sel, ef = channel.roundtrip(
                c_sel, comm_u if comm_u is not None else gen, ef)
            c_sel = c_sel.contiguous()
        plane[choice, rows] = mix_dense(gossip, c_sel, choice,
                                        adj=adj_dev[plane.device])
        return IFCAState(centers=plane, choice=choice, ef=ef), {"choice": choice}

    return step


def personalized_params(state: IFCAState, pack_spec: PackSpec) -> dict:
    rows = torch.arange(state.choice.shape[0], device=state.choice.device)
    return unpack(state.centers[state.choice, rows], pack_spec)
