"""Step functions of the launcher: the FedSPD train round, the plain
data-parallel train step, prefill and decode, the JAX package's
``launch/steps.py`` on one device.

``make_fedspd_train_step`` is one FedSPD round in the stream regime
(Section 4's four steps over one fresh per-client batch) through
``core/fedspd.make_round_step``; its exchange is kernel 1 (or 4, 5, 6
under a codec or sparse masks) through ``core/gossip.make_mix_fn``.
``make_plain_train_step`` is the conventional synchronous step, the
non-personalized reference point. Prefill and decode wrap the bundle's.

The mesh forms (``mesh=`` here, ``make_ppermute_gossip_mix``, and the
``mesh`` / ``sharding`` / ``specs`` modules they stand on) shard the
client axis over a multi-card mesh: they wait for ROADMAP queue 1 item 2
and raise, naming it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.fedspd import FedSPDConfig, make_round_step
from repro_torch.core.gossip import GossipSpec
from repro_torch.graphs.topology import pod_aware
from repro_torch.models.registry import ModelBundle
from repro_torch.optim.sgd import make_optimizer, tree_init, tree_update
from repro_torch.utils.pytree import tree_leaves, tree_map

MESH_LATER = ("the multi-card mesh (launch/mesh.py, launch/sharding.py, the "
              "ppermute gossip schedule) waits for ROADMAP queue 1 item 2")


def make_gossip(n_clients: int, n_pods: int, seed: int = 0,
                mode: str = "dense") -> GossipSpec:
    """Pod-aware client graph: dense ER inside each pod, a few bridges
    between pods."""
    graph = pod_aware(n_clients // n_pods, n_pods, seed=seed)
    return GossipSpec.from_graph(graph, mode=mode)


def make_fedspd_train_step(bundle: ModelBundle, gossip: GossipSpec,
                           fcfg: FedSPDConfig, mix_fn=None, pack_spec=None,
                           mesh=None, comm=None, sparse=None):
    """One FedSPD round over per-client batches ``{"tokens": (N, b, L)}``:
    ``core/fedspd.make_round_step``'s ``step(state, batch, adj=None, *,
    lr=None, s=None, noise=None, comm_u=None, regrow_scores=None) ->
    (state, metrics)``, its draws injectable.

    ``pack_spec`` selects the packed ``(S, N, X)`` plane (its
    ``model_bytes`` is the per-model wire size); ``None`` runs the
    pytree engine. ``comm`` and ``sparse`` as in ``make_round_step``.
    The plane is always updated in place (JAX's ``donate=True``), so
    there is no ``donate``. ``mesh`` raises: the sharded round waits for
    ROADMAP queue 1 item 2."""
    if mesh is not None:
        raise ValueError(f"make_fedspd_train_step(mesh=...): {MESH_LATER}")
    return make_round_step(bundle.loss, bundle.per_example_loss, gossip, fcfg,
                           pack_spec=pack_spec, mix_fn=mix_fn, comm=comm, sparse=sparse)


def make_plain_train_step(bundle: ModelBundle, optimizer_name: str = "adamw",
                          lr: float = 3e-4):
    """Synchronous data-parallel LM step (the reference point):
    ``train_step(params, opt_state, batch) -> (params, opt_state, loss)``
    with ``opt_state`` from ``train_step.init(params)``."""
    opt = make_optimizer(optimizer_name)

    def train_step(params, opt_state, batch):
        live = tree_map(lambda leaf: leaf.detach().requires_grad_(True), params)
        loss = bundle.loss(live, batch)
        grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
        grads = tree_map(lambda _: next(grads), live)
        params, opt_state = tree_update(opt, grads, opt_state, params, lr)
        return params, opt_state, loss.detach()

    train_step.init = lambda params: tree_init(opt, params)
    return train_step


def make_prefill_step(bundle: ModelBundle):
    """Fill the cache for a request batch."""

    def prefill_step(params, batch, cache):
        return bundle.prefill(params, batch, cache)

    return prefill_step


def make_decode_step(bundle: ModelBundle):
    """One new token against the cache."""

    def decode_step(params, cache, tokens):
        return bundle.decode_step(params, cache, tokens)

    return decode_step


def arch_for_shape(cfg: ArchConfig, shape_name: str) -> tuple[ArchConfig, str]:
    """Shape-level arch adaptation: ``long_500k`` needs sub-quadratic
    attention, so a full-attention arch runs it under a sliding window of
    4,096. Returns (cfg, note)."""
    if shape_name != "long_500k":
        return cfg, ""
    if cfg.supports_long_context:
        return cfg, "native sub-quadratic"
    return cfg.with_overrides(window=4096), "+swa4096 variant"


def supports_shape(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and cfg.family == "audio":
        return False, (
            "skip: enc-dec audio backbone (1500-frame encoder); a 500k-token "
            "decode has no audio meaning (DESIGN.md §4)"
        )
    return True, ""


def make_ppermute_gossip_mix(gossip: GossipSpec, mesh, state_example=None,
                             replicate_model_dims: bool = False, comm=None):
    """The edge-coloured collective schedule of Eq. (1) over a mesh."""
    raise NotImplementedError(f"make_ppermute_gossip_mix: {MESH_LATER}")
