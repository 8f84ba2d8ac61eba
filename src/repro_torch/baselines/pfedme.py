"""pFedMe [T. Dinh et al. 2020] — personalization via Moreau envelopes.

Each client maintains a "global" iterate w_i; per round it approximately
solves θ_i = argmin f_i(θ) + λ/2 ||θ - w_i||² with K inner SGD steps, then
takes the outer step w_i <- w_i - η λ (w_i - θ_i). Decentralized variant
gossips w with the static Metropolis matrix (one ``gossip_mix_flat``
launch; behind a wire codec, ``baselines/common.gossip_avg_comm``).
Personalized model = θ_i.

w lives on the packed ``(N, X)`` plane: the inner proximal steps and the
outer Moreau step are single-tensor updates over the plane. On the pytree
engine (``pack_spec=None``) w is a tree of ``(N, ...)`` leaves, both steps
run leaf by leaf in the JAX pytree form, θ − η·(g + λ·(θ − w)), and the
gossip launches ``gossip_mix_flat`` once per leaf.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.baselines.common import gossip_avg_comm, init_planes
from repro_torch.core.packing import PackSpec, grad, maybe_unpack
from repro_torch.data.pipeline import gather_batches, uniform_batch_indices
from repro_torch.utils.pytree import tree_leaves, tree_map


class PFedMeState(NamedTuple):
    w: torch.Tensor  # (N, X) packed plane (a tree of (N, ...) leaves)
    ef: torch.Tensor | None = None  # (N, X) error-feedback residual (comm)


def init_state(gen: torch.Generator, model_init: Callable, n_clients: int,
               pack_spec: PackSpec | None) -> PFedMeState:
    return PFedMeState(w=init_planes(gen, model_init, n_clients, pack_spec))


def _inner_solve(loss_fn, w, data, gen, k_inner, batch, inner_lr, lam, *,
                 pack_spec, idx=None):
    """K SGD steps on f_i(θ) + λ/2||θ - w||², θ init = w; each step is
    θ ← θ − η·(λ·(θ − w) + g). Injectable ``idx`` ``(K, N, batch)``.
    Returns θ."""
    x, y = data["inputs"], data["targets"]
    n, m = x.shape[0], x.shape[1]
    theta = w
    for k in range(k_inner):
        it = idx[k] if idx is not None else uniform_batch_indices(gen, n, m, batch)
        g = grad(loss_fn, theta, gather_batches(x, y, it), pack_spec)
        theta = tree_map(lambda th, gl, wl: th - inner_lr * (gl + lam * (th - wl)),
                         theta, g, w)
    return theta


def make_step(loss_fn: Callable, w_mix: torch.Tensor, *, tau: int, batch: int,
              lam: float = 15.0, k_inner: int = 5, inner_lr: float = 5e-2,
              pack_spec: PackSpec | None, channel=None):
    """``step(state, data, gen, lr, *, idx=None, comm_u=None) -> (state,
    {})``; ``w_mix`` is the ``(N, N)`` mixing matrix on the plane's
    device; ``channel`` runs the exchange of w, after the τ outer steps,
    through a wire codec. Injectable: ``idx`` ``(τ, K, N, batch)``, the
    inner solve's batch indices at each outer step; ``comm_u`` the codec's
    uniform rounding draw (else drawn from ``gen``)."""

    def step(state: PFedMeState, data, gen, lr, *, idx=None, comm_u=None):
        # η·λ taken in fp32 on the device, as the JAX step multiplies its
        # fp32 lr by λ (lr may be a 0-d device tensor read from a tape)
        w = state.w
        lr_lam = torch.as_tensor(lr, dtype=torch.float32,
                                 device=tree_leaves(w)[0].device) * np.float32(lam)
        for t in range(tau):
            theta = _inner_solve(loss_fn, w, data, gen, k_inner, batch,
                                 inner_lr, lam, pack_spec=pack_spec,
                                 idx=None if idx is None else idx[t])
            w = tree_map(lambda ww, th: (ww.float() - lr_lam * (ww.float() - th.float()))
                         .to(ww.dtype), w, theta)
        w, ef = gossip_avg_comm(w, w_mix, channel=channel,
                                key=comm_u if comm_u is not None else gen, ef=state.ef)
        return PFedMeState(w=w, ef=ef), {}

    return step


def personalized_params(state: PFedMeState, loss_fn, data, gen, *, batch=32,
                        lam=15.0, k_inner=10, inner_lr=5e-2,
                        pack_spec: PackSpec | None, idx=None) -> dict:
    """θ_i from the final w_i (a fresh inner solve on local data, drawing
    from ``gen``). Injectable ``idx`` ``(k_inner, N, batch)``."""
    theta = _inner_solve(loss_fn, state.w, data, gen, k_inner, batch,
                         inner_lr, lam, pack_spec=pack_spec, idx=idx)
    return maybe_unpack(theta, pack_spec)
