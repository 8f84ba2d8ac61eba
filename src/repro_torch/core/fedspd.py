"""FedSPD: soft-clustering personalized decentralized FL (paper Algorithm 1)
on the packed ``(S, N, X)`` parameter plane.

Round structure (Section 4):
  1. LocalUpdate       — client i draws s_i ~ Categorical(u_i) and runs τ
                         SGD steps on c_{i,s_i} with batches from the points
                         currently assigned to s_i;
  2. ParameterExchange — (with DP: clip the round's update, add noise);
  3. ParameterUpdate   — closed-neighbourhood average over matching
                         selections, C <- W·C (Eq. (1); core/gossip.py);
  4. DataClustering    — relabel every local point by its min-loss center
                         and recompute u (core/clustering.py).
FinalPhase (Eq. (2)): x_i = Σ_s u_{i,s} c_{i,s}, then τ_final local epochs
on all of D_i.

Two data regimes (``FedSPDConfig.regime``): ``full`` (the paper's) keeps
per-point assignments z over each client's whole local dataset and
re-clusters all M points every round; ``stream`` consumes a fresh batch
a round, assigns its points under the current centers, trains with the
cluster-masked loss and updates u as an EMA of the batch's assignment
fractions (z is not used).

Two parameter representations (``make_round_step(pack_spec=...)``), as
in the JAX package:

- the packed plane (a ``PackSpec``; the port's default):
  ``state.centers`` is ONE ``(S, N, X)`` fp32 tensor. The gather of the
  selected rows is one advanced-index copy, local SGD runs on that
  ``(N, X)`` slab with every client batched into each forward, the
  exchange is one kernel launch, and the scatter writes the mixed rows
  back into the plane IN PLACE (the counterpart of the JAX engine's
  donated buffer): a state passed to the round step must not be reused.
- the pytree engine (``pack_spec=None``; the JAX package's default,
  ``RunConfig(param_plane=False)``): ``state.centers`` is a nested dict
  of ``(S, N, ...)`` leaves (``utils/pytree.py``). Every cross-client
  stage walks the leaves: the gather and the in-place scatter, the
  optimizer's per-leaf update, the DP clip (one fp32 norm per client
  over all leaves, per-leaf sums added in leaf order) and its per-leaf
  noise, and the exchange, one ``gossip_mix_flat`` launch per leaf
  (never the fused DP kernel). No codec and no sparse masks, as in JAX.

With a wire codec (``make_round_step(comm=...)``) the exchange sends the
encoded slab and mixes what receivers decode; with error feedback the
per-client residual rides ``state.ef``. With DisPFL sparse training
(``sparse=...``, density < 1) every client carries a binary mask over X in
``state.mask``: local SGD trains on the masked support, the exchange is
mask-then-encode with a support-renormalised mix, and a RigL prune/regrow
updates the mask every ``update_every`` rounds.

Random draws come from ``state.gen`` (a ``torch.Generator`` on the plane's
device). Every draw can be injected instead — the round's selections,
batch indices, DP noise (a tree of ``(N, ...)`` leaves on the pytree
engine), the codec's rounding draw, RigL's dense-gradient
batch indices and its random-regrow scores; ``seeded_init``'s seed
clients, initial parameters and index tape; ``final_phase``'s index tape —
so tests can feed both packages the same numbers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.comm.codecs import CommConfig, make_channel
from repro_torch.core.clustering import (
    assign_clusters,
    cluster_all_clients,
    mixture_coefficients,
)
from repro_torch.core.gossip import (
    GossipSpec,
    fedspd_weight_matrix,
    make_mix_fn,
    round_comm_bytes,
)
from repro_torch.core.packing import (
    PackSpec,
    flat_grad,
    grad,
    make_pack_spec,
    maybe_unpack,
    mixture,
    pack,
    stack_models,
    unpack,
)
from repro_torch.core.sparse import SparseConfig, column_activity, rigl_update
from repro_torch.data.pipeline import (
    cluster_batch_indices,
    gather_batches,
    uniform_batch_indices,
)
from repro_torch.device import copy_generator, fork_generator
from repro_torch.optim.sgd import Optimizer, sgd, tree_init, tree_update
from repro_torch.utils.pytree import (
    tree_bytes,
    tree_gather_rows,
    tree_index,
    tree_leaves,
    tree_map,
    tree_scatter_rows_,
)


class FedSPDState(NamedTuple):
    centers: torch.Tensor     # (S, N, X) fp32 plane (or a tree of (S, N, ...)
    #                           leaves on the pytree engine): client i's center s
    u: torch.Tensor           # (N, S) mixture coefficients
    z: torch.Tensor           # (N, M) int64 per-point assignments
    round: int
    gen: torch.Generator      # the run's random stream (JAX: state.key)
    comm_bytes: torch.Tensor  # () fp32 cumulative logical bytes
    ef: torch.Tensor | None = None    # (N, X) error-feedback residual
    mask: torch.Tensor | None = None  # (N, X) fp32 {0,1} sparse masks


@dataclasses.dataclass(frozen=True)
class FedSPDConfig:
    n_clients: int
    n_clusters: int
    tau: int = 5                  # local steps per round
    batch: int = 32
    lr0: float = 5e-2
    lr_decay: float = 0.98        # per-round multiplicative decay
    tau_final: int = 10
    final_lr_scale: float = 0.5
    u_ema: float = 0.3            # "stream" regime u update rate
    regime: str = "full"          # full | stream
    point_to_point: bool = True   # comm accounting mode
    # differential privacy (paper B.2.6): each round's update is L2-clipped
    # to dp_clip and Gaussian noise of std dp_clip * dp_noise_multiplier is
    # added before the exchange; 0 disables
    dp_clip: float = 0.0
    dp_noise_multiplier: float = 0.0


def _fp32(x: float) -> float:
    return float(np.float32(x))


def round_lr(cfg: FedSPDConfig, r: int) -> float:
    """The round's own schedule lr0 · decay^r, taken in fp32."""
    return _fp32(np.float32(cfg.lr0) * np.float32(cfg.lr_decay) ** np.float32(r))


def init_state(gen: torch.Generator, model_init: Callable, cfg: FedSPDConfig,
               data_m: int, spec: PackSpec | None = None) -> FedSPDState:
    """Independent random init per (cluster, client) pair: packed through
    ``spec``, or (``spec=None``) a tree of ``(S, N, ...)`` leaves. Packed,
    each model is written into the plane as it is drawn, so the init
    holds the plane and one model (the plane of a full-width LM is most
    of the card)."""
    lead = (cfg.n_clusters, cfg.n_clients)
    if spec is None:
        models = [model_init(gen) for _ in range(math.prod(lead))]
        centers = stack_models(models, None, lead)
    else:
        centers = torch.empty(lead + (spec.size,), dtype=torch.float32, device=gen.device)
        for row in centers.view(-1, spec.size):
            row.copy_(pack(model_init(gen), spec))
    return _state(centers, cfg, data_m, fork_generator(gen))


def _state(centers, cfg, data_m, gen) -> FedSPDState:
    dev = tree_leaves(centers)[0].device
    return FedSPDState(
        centers=centers,
        u=torch.full((cfg.n_clients, cfg.n_clusters), 1.0 / cfg.n_clusters,
                     device=dev),
        z=torch.zeros((cfg.n_clients, data_m), dtype=torch.int64, device=dev),
        round=0, gen=gen,
        comm_bytes=torch.zeros((), device=dev),
    )


def seeded_init(gen: torch.Generator, model_init: Callable, cfg: FedSPDConfig,
                loss_fn: Callable, data: dict, spec: PackSpec | None = None, *,
                epochs: int = 15, lr: float = 0.1,
                seeds: torch.Tensor | None = None,
                init_params=None,
                idx_tape: torch.Tensor | None = None,
                optimizer: Optimizer | None = None) -> FedSPDState:
    """Client-seeded warm start: S distinct random clients each pretrain
    one cluster center on their own local data (``epochs · max(1, M //
    batch)`` steps at ``lr`` of ``optimizer``, plain SGD by default);
    every client starts from those S seeds. The S pretrainings are
    independent and run batched, as one ``(S, X)`` slab. The centers come
    back packed through ``spec``, or (``spec=None``, the pytree engine) as
    a tree of ``(S, N, ...)`` leaves, one contiguous tensor each: the same
    numbers either way, as JAX's one ``seeded_init`` serves both engines.

    Injectable draws: ``seeds`` ``(S,)`` client ids, ``init_params`` the
    S initial models (``(S, X)`` packed, or with ``spec=None`` a tree of
    ``(S, ...)`` leaves), ``idx_tape`` ``(S, steps, B)`` batch indices
    into each seed client's M points."""
    x, y = data["inputs"], data["targets"]
    n, m = x.shape[0], x.shape[1]
    s_clusters = cfg.n_clusters
    steps = epochs * max(1, m // cfg.batch)
    if seeds is None:
        seeds = torch.randperm(n, generator=gen, device=gen.device)[:s_clusters]
    if init_params is None:
        init_params = stack_models([model_init(gen) for _ in range(s_clusters)],
                                   spec, (s_clusters,))
    if idx_tape is None:
        idx_tape = torch.randint(0, m, (s_clusters, steps, cfg.batch),
                                 generator=gen, device=gen.device)
    tree_out = spec is None
    if tree_out:
        spec = make_pack_spec(tree_index(init_params, 0))
        init_params = pack(init_params, spec)
    seeds = torch.as_tensor(seeds, device=x.device).long()
    xs, ys = x[seeds], y[seeds]
    p = init_params.to(x.device, torch.float32)
    p = _optimize(optimizer, p, steps, lambda t: gather_batches(xs, ys, idx_tape[:, t]),
                  loss_fn, spec, lr)
    centers = p[:, None, :].expand(s_clusters, n, spec.size).contiguous()
    if tree_out:
        centers = tree_map(lambda leaf: leaf.contiguous(), unpack(centers, spec))
    return _state(centers, cfg, m, fork_generator(gen))


def _optimize(optimizer: Optimizer | None, p, steps: int,
              batch_of: Callable, loss_fn: Callable, spec: PackSpec | None, lr,
              grad_mask: torch.Tensor | None = None):
    """``steps`` steps on the slab ``p`` (or, with ``spec=None``, on the
    tree ``p``, leaf by leaf), step t on ``batch_of(t)``, with
    ``optimizer`` (plain SGD for None; its state made fresh here); with
    ``grad_mask`` every gradient is projected on it first."""
    optimizer = optimizer or sgd()
    state = tree_init(optimizer, p)
    for t in range(steps):
        g = grad(loss_fn, p, batch_of(t), spec)
        if grad_mask is not None:
            g = g * grad_mask
        p, state = tree_update(optimizer, g, state, p, lr)
    return p


def select_clusters(gen: torch.Generator, u: torch.Tensor) -> torch.Tensor:
    """Step 1a: s_i ~ Categorical(u_i). Returns ``(N,)`` int64."""
    return torch.multinomial(u, 1, generator=gen).squeeze(1)


def _consensus_per_cluster(centers) -> torch.Tensor:
    """Theorem 5.10's E_t per cluster, every cluster at once, leaf by leaf
    over the ``(S, N, ...)`` leaves (the ``(S, N, X)`` plane is one leaf):
    JAX's per-cluster ``consensus_distance``, its per-leaf terms added in
    leaf order. The deviations are squared in place: one temporary of the
    plane's size, not two (an LM's plane is most of the card)."""
    total = None
    for leaf in tree_leaves(centers):
        l32 = leaf.float()
        d = (l32 - l32.mean(dim=1, keepdim=True)).square_().flatten(1).sum(dim=1) \
            / leaf.shape[1]
        total = d if total is None else total + d
    return total


def make_round_step(loss_fn: Callable, per_example_loss: Callable,
                    gossip: GossipSpec, cfg: FedSPDConfig, *,
                    pack_spec: PackSpec | None = None,
                    mix_fn: Callable | None = None,
                    comm: CommConfig | None = None,
                    sparse: SparseConfig | None = None,
                    optimizer: Optimizer | None = None,
                    lr_schedule: Callable | None = None):
    """Returns ``step(state, data, adj=None, *, lr=None, s=None, idx=None,
    noise=None, comm_u=None, rigl_idx=None, regrow_scores=None) -> (state,
    metrics)`` for the "full" regime, on the packed plane through
    ``pack_spec`` or, with ``pack_spec=None``, on the pytree engine (the
    JAX ``step_full`` / ``step_stream``). ``data`` is
    ``{"inputs": (N, M, d), "targets": (N, M)}`` on the plane's device.
    For the "stream" regime, ``step(state, batch, adj=None, *, lr=None,
    s=None, noise=None, comm_u=None, regrow_scores=None)`` with ``batch``
    the round's fresh per-client batch, any keys with leaves ``(N, B,
    ...)`` (``{"x": (N, B, d), "y": (N, B)}``, or an LM's ``{"tokens":
    (N, B, L)}``), which the masked loss gets with ``"mask"`` added: no
    batch indices are drawn, and RigL's dense gradient is the masked
    loss's on the batch.
    ``adj`` ``(N, N)`` on the plane's device overrides the graph's
    adjacency for this round (a per-seed graph, a cohort's minor); ``lr``
    (a float or a 0-d fp32 tensor on the device, as a captured round
    reads it from a tape) overrides the round's schedule:
    ``lr_schedule(state.round)`` (optim/schedules.py; moved to the plane's
    device) or, without one, ``round_lr(cfg, state.round)``. The step
    reads ``state.round`` on the host only there and in the sparse mask's
    ``update_due``.

    ``optimizer`` (optim/sgd.py; plain SGD by default) takes the τ local
    steps, its state made fresh every round as the JAX step's is.

    Injectable draws: ``s`` ``(N,)`` selections, ``idx`` ``(τ, N, B)``
    batch indices, ``noise`` ``(N, X)`` standard-normal DP noise (on the
    pytree engine a tree of ``(N, ...)`` leaves, one draw per leaf as the
    JAX pytree step draws it; used only when σ = dp_clip ·
    dp_noise_multiplier > 0), ``comm_u`` ``(N,
    Xp/block, block)`` the int8/int4 codec's uniform rounding draw,
    ``rigl_idx`` ``(N, B)`` the batch indices of RigL's dense gradient,
    ``regrow_scores`` ``(N, X)`` the uniform scores of ``regrow="random"``.

    ``mix_fn`` comes from ``core/gossip.make_mix_fn(comm=comm)`` (the
    default); with a codec it must be comm-aware, with sparse it must
    carry ``sparse_matmul`` (and, with int8/int4, ``sparse_dequant``).

    ``comm`` runs the exchange through a wire codec (``state.ef`` carries
    the residual with error feedback). A DP round with a codec sanitizes
    first, then encodes: the fused DP kernel is for the uncompressed
    exchange of a ``mix_fn`` that carries ``fused_dp`` (none does with
    cosine alignment, whose W depends on the sanitized values).
    ``state.comm_bytes`` keeps counting logical bytes.

    ``sparse`` (density < 1) runs DisPFL on ``state.mask``: the gathered
    rows are projected on the mask and gradients masked every step; the
    exchange (with the old mask) mixes num = W·(M⊙Ĉ) and den = W·M and
    keeps ``where(M ∧ den > 0, num / den, own value)``; RigL on the
    post-update rows stores the new mask every ``update_every`` rounds.
    Density 1.0 runs the dense paths bit for bit, the mask riding along.

    The pytree engine takes neither a codec nor sparse masks (each raises,
    as in JAX), gives a DP round one fp32 clip norm a client over all
    leaves and per-leaf noise, and mixes with ``mix_fn`` (by default
    ``make_mix_fn(plane=False)``: one flat-kernel launch per leaf) without
    ever taking ``fused_dp``; it counts ``tree_bytes`` of a client's
    selected model a link, which is ``PackSpec.model_bytes``.

    The mixed rows are scattered into ``state.centers`` in place."""
    if cfg.regime not in ("full", "stream"):
        raise ValueError(f"unknown regime {cfg.regime!r}; expected 'full' or 'stream'")
    tree = pack_spec is None
    sparse_on = sparse is not None and sparse.enabled
    if tree and comm is not None and comm.codec != "fp32":
        raise ValueError(
            f"comm codec {comm.codec!r} requires the packed parameter plane "
            "(pass pack_spec; fp32 is the only pytree-safe codec)")
    if tree and sparse_on:
        raise ValueError(
            f"sparse training (density={sparse.density}) requires the packed "
            "parameter plane (pass pack_spec)")
    channel = None if tree else make_channel(comm, pack_spec.size)
    if sparse_on and gossip.aligned:
        raise ValueError(
            "sparse training does not compose with cosine-alignment "
            "filtering: the masked mixing weights are support-, not "
            "value-, dependent")
    if mix_fn is None:
        mix_fn = make_mix_fn(gossip, comm=comm, plane=not tree)
    if (channel is not None) != bool(getattr(mix_fn, "comm_aware", False)):
        raise ValueError(
            "mix_fn must be core/gossip.make_mix_fn(comm=...) for the same "
            f"codec (comm={comm})")
    if sparse_on and not hasattr(mix_fn, "sparse_matmul"):
        raise ValueError(
            "sparse training needs a mix_fn with sparse_matmul "
            "(core/gossip.make_mix_fn)")
    sigma = cfg.dp_clip * cfg.dp_noise_multiplier
    adj_dev: dict = {}  # the static adjacency, moved to the device once

    def masked_loss(p, batch):
        """The stream regime's loss: each client's mean per-example loss
        over the batch points assigned to its selected cluster."""
        pel = per_example_loss(p, batch)
        m = batch["mask"]
        return (pel * m).sum(dim=-1) / m.sum(dim=-1).clamp_min(1.0)

    def local_updates(c, batch_of, loss, lr, grad_mask):
        """τ steps on the ``(N, X)`` slab, step t on ``batch_of(t)``;
        with ``grad_mask`` every step's gradient is projected on it."""
        return _optimize(optimizer, c, cfg.tau, batch_of, loss, pack_spec, lr,
                         grad_mask)

    def dp_flat_parts(c_old, c_new, gen, noise):
        """One L2 norm per client row; the noise only when σ > 0."""
        sq = (c_new - c_old).square().sum(dim=-1, keepdim=True)
        scale = torch.clamp(cfg.dp_clip / torch.sqrt(sq + 1e-12), max=1.0)
        if sigma <= 0:
            return scale, None
        if noise is None:
            noise = torch.randn(c_new.shape, generator=gen,
                                device=c_new.device)
        return scale, noise

    def dp_sanitized(c_old, c_new, gen, noise):
        """c_old + scale ⊙ (c_new − c_old) [+ σ·noise], unfused."""
        scale, noise = dp_flat_parts(c_old, c_new, gen, noise)
        c_sel = c_old + scale * (c_new - c_old)
        if noise is not None:
            c_sel = c_sel + sigma * noise
        return c_sel

    def dp_sanitized_tree(c_old, c_new, gen, noise):
        """The pytree DP round, as the JAX pytree step: δ = c_new − c_old
        leaf by leaf in fp32, one clip scale a client from the per-leaf
        sums of squares added in leaf order, then c_old + (δ·scale + σ·ξ)
        with per-leaf noise ξ (drawn leaf by leaf when not given)."""
        delta = tree_map(lambda a, b: a.float() - b.float(), c_new, c_old)
        sq = None
        for leaf in tree_leaves(delta):
            v = leaf.square().reshape(leaf.shape[0], -1).sum(dim=1)
            sq = v if sq is None else sq + v
        scale = torch.clamp(cfg.dp_clip / torch.sqrt(sq + 1e-12), max=1.0)
        if sigma > 0 and noise is None:
            noise = tree_map(lambda leaf: torch.randn(leaf.shape, generator=gen,
                                                      device=leaf.device), delta)

        def one(old, d, nz=None):
            d = d * scale.reshape((-1,) + (1,) * (d.dim() - 1))
            if nz is not None:
                d = d + sigma * nz
            return (old.float() + d).to(old.dtype)

        return tree_map(one, c_old, delta, *((noise,) if sigma > 0 else ()))

    def channel_mix(c_sel, s, key, ef, adj):
        if channel is None:
            return mix_fn(c_sel, s, adj=adj), ef
        return mix_fn(c_sel, s, key, ef, adj=adj)

    def exchange_packed(plane, c_old, c_new, s, gen, noise, key, ef, adj):
        """Steps (2)+(3): DP sanitize, the codec, the Eq. (1) mix, and the
        in-place scatter of the mixed rows back into ``(S, N, X)``. A DP
        round without a codec is one fused kernel when ``mix_fn`` has one
        (``fused_dp``). Returns (plane, ef')."""
        fused = getattr(mix_fn, "fused_dp", None)
        if cfg.dp_clip > 0 and channel is None and fused is not None:
            scale, noise = dp_flat_parts(c_old, c_new, gen, noise)
            c_mixed = fused(c_old, c_new, scale, noise, sigma, s, adj=adj)
        else:
            c_sel = (dp_sanitized(c_old, c_new, gen, noise) if cfg.dp_clip > 0
                     else c_new)
            c_mixed, ef = channel_mix(c_sel, s, key, ef, adj)
        tree_scatter_rows_(plane, s, c_mixed)
        return plane, ef

    def exchange_sparse(plane, c_old, c_new, s, smask, gen, noise, key, ef,
                        adj):
        """The sparse steps (2)+(3): DP sanitize then re-mask (noise must
        not densify the support), mask-then-encode, and the
        support-renormalised mix num = W·(M⊙Ĉ), den = W·M; a receiver
        keeps its own value where its mask is dead or no sender covers
        the coordinate. The residual is masked after every update.
        Returns (plane, ef')."""
        if cfg.dp_clip > 0:
            c_sel = smask * dp_sanitized(c_old, c_new, gen, noise)
        else:
            c_sel = c_new  # masked start + masked gradients: on the support
        w = fedspd_weight_matrix(gossip, s, adj=adj)
        colact = column_activity(smask)
        if channel is None:
            num = mix_fn.sparse_matmul(w, c_sel, colact)
        else:
            enc, x_hat, ef = channel.encode_stream(
                c_sel, key, ef, need_hat=channel.has_ef or not channel.fused)
            if ef is not None:
                ef = smask * ef
            if channel.fused:
                num = mix_fn.sparse_dequant(w, enc, smask, colact)
            else:
                num = mix_fn.sparse_matmul(w, smask * x_hat, colact)
        den = mix_fn.sparse_matmul(w, smask, colact)
        c_mixed = torch.where((smask > 0) & (den > 0),
                              num / den.clamp_min(1e-12), c_sel)
        tree_scatter_rows_(plane, s, c_mixed)
        return plane, ef

    def sparse_mask_update(state, c_new, dense_grad, regrow_scores):
        """RigL prune/regrow on the post-update rows, on the rounds
        ``sparse.update_due`` names (the dense gradient, ``dense_grad()``,
        is taken only then)."""
        if not sparse.update_due(state.round):
            return state.mask
        grads = dense_grad() if sparse.regrow == "rigl" else None
        key = regrow_scores if regrow_scores is not None else state.gen
        return rigl_update(state.mask, c_new, grads, key, sparse)

    def begin(state, adj, lr, s):
        """The round's adjacency, lr and selections, and the gathered rows
        (an advanced-index copy of each leaf)."""
        dev = state.u.device
        if adj is None:
            if dev not in adj_dev:
                adj_dev[dev] = torch.as_tensor(gossip.adj, dtype=torch.float32,
                                               device=dev)
            adj = adj_dev[dev]
        if lr is None and lr_schedule is not None:
            lr = torch.as_tensor(lr_schedule(state.round), dtype=torch.float32,
                                 device=dev)
        elif lr is None:
            lr = round_lr(cfg, state.round)
        if sparse_on and state.mask is None:
            raise ValueError(
                "sparse training needs state.mask (core/sparse.init_masks)")
        if s is None:
            s = select_clusters(state.gen, state.u)
        s = torch.as_tensor(s, device=dev).long()
        return adj, lr, s, tree_gather_rows(state.centers, s)

    def finish(state, c_old, c_new, s, adj, lr, noise, comm_u, dense_grad,
               regrow_scores):
        """Steps (2)+(3) (sanitize, codec, mix, scatter; RigL on its
        rounds) and the byte count. Returns (plane, ef', mask', bytes)."""
        plane, gen = state.centers, state.gen
        key = comm_u if comm_u is not None else gen
        if tree:
            mask, ef = state.mask, state.ef
            c_sel = (dp_sanitized_tree(c_old, c_new, gen, noise) if cfg.dp_clip > 0
                     else c_new)
            tree_scatter_rows_(plane, s, mix_fn(c_sel, s, adj=adj))
        elif sparse_on:
            mask = sparse_mask_update(state, c_new, dense_grad, regrow_scores)
            plane, ef = exchange_sparse(plane, c_old, c_new, s, state.mask,
                                        gen, noise, key, state.ef, adj)
        else:
            mask = state.mask
            plane, ef = exchange_packed(plane, c_old, c_new, s, gen, noise,
                                        key, state.ef, adj)
        # one model's wire bytes in its own dtypes (a host int from shapes)
        model_b = tree_bytes(c_new) // cfg.n_clients if tree else pack_spec.model_bytes
        comm = state.comm_bytes + round_comm_bytes(
            gossip, s, model_b, point_to_point=cfg.point_to_point, adj=adj)
        return plane, ef, mask, comm

    def step_full_packed(state: FedSPDState, data: dict, adj=None, *, lr=None,
                         s=None, idx=None, noise=None, comm_u=None,
                         rigl_idx=None, regrow_scores=None):
        gen, x, y = state.gen, data["inputs"], data["targets"]
        # (1) selection, gather, τ local steps on cluster-conditional
        # batches, on the mask's support when sparse
        adj, lr, s, c_old = begin(state, adj, lr, s)
        grad_mask = None
        if sparse_on:
            c_old, grad_mask = state.mask * c_old, state.mask

        def batch_of(t):
            it = (idx[t] if idx is not None else
                  cluster_batch_indices(gen, state.z, s, cfg.batch))
            return gather_batches(x, y, it)

        c_new = local_updates(c_old, batch_of, loss_fn, lr, grad_mask)

        def dense_grad():
            it = (rigl_idx if rigl_idx is not None else
                  cluster_batch_indices(gen, state.z, s, cfg.batch))
            return flat_grad(loss_fn, c_new, gather_batches(x, y, it), pack_spec)

        # (2)+(3) sanitize + codec + mix + scatter
        plane, ef, mask, comm = finish(state, c_old, c_new, s, adj, lr, noise,
                                       comm_u, dense_grad, regrow_scores)

        # (4) re-cluster every local point under the new centers
        z, u = cluster_all_clients(per_example_loss, maybe_unpack(plane, pack_spec),
                                   {"x": x, "y": y}, cfg.n_clusters)
        return _result(state, plane, u, z, comm, ef, mask, lr, s)

    def step_stream_packed(state: FedSPDState, batch: dict, adj=None, *,
                           lr=None, s=None, noise=None, comm_u=None,
                           regrow_scores=None):
        # (1) selection and gather; the batch's points assigned under the
        # current centers; τ steps of the cluster-masked loss on the batch
        adj, lr, s, c_old = begin(state, adj, lr, s)
        zb, _ = assign_clusters(per_example_loss, maybe_unpack(state.centers, pack_spec), batch)
        sbatch = {**batch, "mask": (zb == s[:, None]).float()}
        grad_mask = None
        if sparse_on:
            c_old, grad_mask = state.mask * c_old, state.mask
        c_new = local_updates(c_old, lambda t: sbatch, masked_loss, lr, grad_mask)

        def dense_grad():
            return flat_grad(masked_loss, c_new, sbatch, pack_spec)

        # (2)+(3), then u as the EMA of the batch's assignment fractions
        plane, ef, mask, comm = finish(state, c_old, c_new, s, adj, lr, noise,
                                       comm_u, dense_grad, regrow_scores)
        # the rows are in the plane now: free them before the consensus
        # reduction's temporaries (an LM's rows are most of the card)
        del c_old, c_new, dense_grad
        u_batch = mixture_coefficients(zb, cfg.n_clusters)
        u = (1 - cfg.u_ema) * state.u + cfg.u_ema * u_batch
        return _result(state, plane, u, state.z, comm, ef, mask, lr, s)

    return step_full_packed if cfg.regime == "full" else step_stream_packed


def _result(state, plane, u, z, comm, ef, mask, lr, s):
    """The round's new state and its metrics."""
    new_state = FedSPDState(centers=plane, u=u, z=z, round=state.round + 1,
                            gen=state.gen, comm_bytes=comm, ef=ef, mask=mask)
    metrics = {"lr": lr, "selected": s,
               "consensus": _consensus_per_cluster(plane),
               "comm_bytes": comm}
    return new_state, metrics


# --------------------------------------------------------------------------
# Final phase (Algorithm 1, FINALPHASE)
# --------------------------------------------------------------------------


def personalize(state: FedSPDState, pack_spec: PackSpec | None = None) -> dict:
    """Eq. (2): x_i = Σ_s u_{i,s} c_{i,s}. Returns the parameter dict with
    leaves ``(N, ...)``: views of one new ``(N, X)`` tensor on the plane,
    new tensors on the pytree engine (``pack_spec=None``)."""
    return maybe_unpack(mixture(state.centers, state.u), pack_spec)


def final_phase(state: FedSPDState, loss_fn: Callable, data: dict,
                cfg: FedSPDConfig, pack_spec: PackSpec | None = None, *,
                lr: float | None = None,
                idx_tape: torch.Tensor | None = None,
                optimizer: Optimizer | None = None) -> dict:
    """Eq. (2), then τ_final local epochs (``tau_final · max(1, M //
    batch)`` steps of ``optimizer``, plain SGD by default, on uniform
    batches) on all local data, on the plane (``pack_spec``) or leaf by
    leaf (``pack_spec=None``). Draws from
    a copy of ``state.gen``, so the run's stream does not advance (JAX
    reuses ``state.key`` here). Injectable: ``idx_tape`` ``(steps, N,
    B)``. Returns the personalized parameter dict, leaves ``(N, ...)``."""
    x, y = data["inputs"], data["targets"]
    n, m = x.shape[0], x.shape[1]
    if lr is None:
        lr = _fp32(np.float32(cfg.lr0) * np.float32(cfg.final_lr_scale)
                   * np.float32(cfg.lr_decay) ** np.float32(state.round))
    steps = cfg.tau_final * max(1, m // cfg.batch)
    gen = copy_generator(state.gen) if idx_tape is None else None

    def batch_of(t):
        it = (idx_tape[t] if idx_tape is not None
              else uniform_batch_indices(gen, n, m, cfg.batch))
        return gather_batches(x, y, it)

    params = _optimize(optimizer, mixture(state.centers, state.u), steps, batch_of,
                       loss_fn, pack_spec, lr)
    return maybe_unpack(params, pack_spec)
