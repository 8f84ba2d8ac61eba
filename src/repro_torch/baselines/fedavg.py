"""FedAvg [McMahan et al. 2017] — centralized and decentralized (D-SGD
gossip) variants. The non-personalized reference point.

The state is the packed ``(N, X)`` plane: local SGD is one batched update
over the plane, and the W-average is one ``gossip_mix_flat`` launch (one
``gossip_mix_dequant`` over the encoded payload behind an int8/int4 wire
codec). With error feedback the state is ``WithEF(plane, ef)``, so the
residual crosses rounds. On the pytree engine (``pack_spec=None``) the
state is a tree of ``(N, ...)`` leaves and the W-average launches
``gossip_mix_flat`` once per leaf.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.baselines.common import gossip_avg_comm, local_sgd
from repro_torch.comm.codecs import join_ef, split_ef
from repro_torch.core.packing import PackSpec, maybe_unpack


def make_step(loss_fn: Callable, w: torch.Tensor, *, tau: int, batch: int,
              pack_spec: PackSpec | None, channel=None):
    """``step(state, data, gen, lr, *, idx=None, comm_u=None) -> (state,
    {})``; ``w`` is the ``(N, N)`` mixing matrix on the plane's device;
    ``channel`` (comm/codecs.Channel) runs the exchange through a wire
    codec. Injectable: ``idx`` ``(τ, N, batch)``, ``comm_u`` the codec's
    uniform rounding draw ``(N, Xp/block, block)`` (else drawn from
    ``gen``)."""
    def step(state, data, gen, lr, *, idx=None, comm_u=None):
        plane, ef = split_ef(state, channel)
        plane = local_sgd(loss_fn, plane, data, gen, tau, batch, lr,
                          pack_spec=pack_spec, idx=idx)
        mixed, ef = gossip_avg_comm(plane, w, channel=channel,
                                    key=comm_u if comm_u is not None else gen, ef=ef)
        return join_ef(mixed, ef, channel), {}

    return step


def personalized_params(state, pack_spec: PackSpec | None, channel=None) -> dict:
    """FedAvg has no personalization: every client evaluates its own copy
    (equal to the consensus model up to gossip error); an EF-wrapped state
    drops its residual."""
    plane, _ = split_ef(state, channel)
    return maybe_unpack(plane, pack_spec)
