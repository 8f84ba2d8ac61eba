"""Step functions of the launcher: the FedSPD train round, the plain
data-parallel train step, prefill and decode, the JAX package's
``launch/steps.py``.

``make_fedspd_train_step`` is one FedSPD round in the stream regime
(Section 4's four steps over one fresh per-client batch) through
``core/fedspd.make_round_step``; on one device its exchange is kernel 1
(or 4, 5, 6 under a codec or sparse masks) through
``core/gossip.make_mix_fn``. With ``mesh=`` the round runs on each rank's
client: the packed plane's client axis sharded one client a data row
(``launch/sharding.shard_plane_state``) and Eq. (1) as
``make_ppermute_gossip_mix``, the edge-coloured send/recv schedule.
``make_plain_train_step`` is the conventional synchronous step, the
non-personalized reference point. Prefill and decode wrap the bundle's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.comm.codecs import make_channel
from repro_torch.configs.base import ArchConfig
from repro_torch.core.fedspd import FedSPDConfig, make_round_step, select_clusters
from repro_torch.core.gossip import GossipSpec
from repro_torch.graphs.topology import pod_aware
from repro_torch.launch.mesh import dp_size, n_chips
from repro_torch.launch.sharding import (
    ClientGroup,
    _dp_ranks,
    client_index,
    local_state,
    place_local_state,
)
from repro_torch.models.registry import ModelBundle
from repro_torch.optim.sgd import make_optimizer, tree_init, tree_update
from repro_torch.utils.pytree import tree_leaves, tree_map


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
    there is no ``donate``.

    ``mesh`` (a ``DeviceMesh``; needs the packed plane, refuses sparse
    masks) is the multi-rank round: the state is ``launch/sharding.
    shard_plane_state``'s (or the rank's own rows as plain tensors), and
    the step runs on this rank's client with ``make_ppermute_gossip_mix``
    as its exchange unless ``mix_fn`` is given. It takes the global batch,
    data and injected draws (``s``, the full regime's ``idx``, ``noise``,
    ``comm_u``) and uses this client's row of each; the byte count
    gathers every client's selection and the consensus sums over the
    ranks (``make_round_step(clients=...)``). Its own draws: the
    selections from the state's generator over the gathered ``u``, as the
    one-device round draws them (every rank alike), and a client's row
    draws (batch indices, DP noise, codec rounding) from a generator
    seeded from the state's generator and the client's index, the seed
    drawn only in rounds that need one. So with those draws injected, or
    at one client a run's draws, the mesh round is the one-device round's
    on the same state."""
    if sparse is not None and sparse.enabled and mesh is not None:
        raise ValueError(
            "sparse training is not available on the mesh/ppermute path — "
            "the collective schedule ships raw plane rows, not masked "
            "payloads")
    if mesh is None:
        return make_round_step(bundle.loss, bundle.per_example_loss, gossip, fcfg,
                               pack_spec=pack_spec, mix_fn=mix_fn, comm=comm,
                               sparse=sparse)
    if pack_spec is None:
        raise ValueError(
            "mesh sharding of the round step requires the packed "
            "parameter plane (pass pack_spec)")
    if mix_fn is None:
        mix_fn = make_ppermute_gossip_mix(gossip, mesh, replicate_model_dims=True,
                                          comm=comm)
    clients = ClientGroup(mesh)
    step = make_round_step(bundle.loss, bundle.per_example_loss, gossip, fcfg,
                           pack_spec=pack_spec, mix_fn=mix_fn, comm=comm,
                           sparse=sparse, clients=clients)
    sigma = fcfg.dp_clip * fcfg.dp_noise_multiplier
    rounding = comm is not None and comm.codec in ("int8", "int4")
    i = clients.index

    def row(v):
        return None if v is None else torch.as_tensor(v)[i:i + 1]

    def mesh_step(state, batch, adj=None, *, lr=None, s=None, idx=None, noise=None,
                  comm_u=None):
        local = local_state(state)
        gen = local.gen
        if s is None:
            s = select_clusters(gen, clients.gather(local.u))
        kw = {"lr": lr, "s": row(s).to(local.u.device), "noise": row(noise),
              "comm_u": row(comm_u)}
        if idx is not None:
            kw["idx"] = torch.as_tensor(idx)[:, i:i + 1]
        if ((fcfg.regime == "full" and idx is None) or (sigma > 0 and noise is None)
                or (rounding and comm_u is None)):
            seed = int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device))
            local = local._replace(gen=torch.Generator(gen.device).manual_seed(seed + i))
        new, metrics = step(local, {k: row(v) for k, v in batch.items()}, adj, **kw)
        return place_local_state(new._replace(gen=gen), like=state), metrics

    return mesh_step


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
    """FedSPD's Eq. (1) as an edge-coloured send/recv schedule over
    ``mesh``'s ranks, one client a data row (JAX's ``lax.ppermute``
    schedule under ``shard_map``): a client sends deg·X bytes a round,
    not the dense all-gather's N·X.

    For every colour class of ``gossip.perms`` (a matching, so a partner
    swap), each client i with ``perm[i] != i`` sends its selection and its
    row to ``perm[i]`` and receives theirs, in one ``dist.batch_isend_irecv``
    among the ranks of its model coordinate; every rank walks the same
    colour list. It accumulates in fp32 as ``core/gossip.mix_permute``
    does: ``m = (s_partner == s)`` (and, given this round's adjacency
    ``adj``, a subgraph of the spec's graph, ``adj[i, perm[i]] > 0``),
    ``acc += m · row``, ``cnt += m``, then ``acc / cnt`` in the row's
    dtype.

    ``mix(c_sel, s, adj=None)`` takes a tree of ``(1, …)`` leaves or the
    ``(1, X)`` plane shard of this rank's client with its ``(1,)``
    selection (the mesh round), or the whole ``(N, …)`` input on every
    rank (the registry's ``gossip_backend="ppermute"``): then each rank
    mixes its own row and all ranks gather the mixed rows, so every rank
    returns the same ``(N, …)``; a rank past the mesh mixes nothing and
    gets the rows too. That form gathers over the whole process group, so
    every rank of it calls the mix.

    With ``comm`` (int8, int4 or top-k) the encoded row crosses the link
    (``Channel.to_wire``), encoded once with ``make_channel(comm, X).encode_stream``
    (rounding draw ``key``, residual ``ef``); the receiver decodes it, and
    its own contribution is its own decoded message, so the result is
    ``W·decode(encode(C))``. The mix is then comm-aware: ``(c_sel, s, key,
    ef, adj=None) -> (mixed, ef')``.

    ``state_example`` and ``replicate_model_dims`` are JAX's: there they
    set the ``shard_map`` specs of the model dims. The port's rows are
    whole on every rank of a data row, so neither changes anything."""
    import torch.distributed as dist

    del state_example, replicate_model_dims
    n = gossip.adj.shape[0]
    if dp_size(mesh) != n:
        raise ValueError(
            f"the ppermute schedule needs one client per data row: {n} clients, "
            f"a mesh of {dp_size(mesh)} rows")
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    idx = None if coord is None else client_index(mesh)
    table = _dp_ranks(mesh)
    peers = None if coord is None else table[:, int(coord[names.index("model")])].tolist()
    # the colour classes that pair anyone (every rank walks all of them)
    colours = [perm for perm in gossip.perms if (perm != np.arange(n)).any()]
    ready = []

    def start(device):
        """Before the first exchange: one collective over the whole
        process group when the mesh is all of it (NCCL's batched send/recv
        must not be a group's first collective)."""
        if not ready:
            if n_chips(mesh) == dist.get_world_size():
                dist.all_reduce(torch.zeros(1, device=device))
            ready.append(True)

    def exchange(own: list, s_row, adj, recv_like, decode, acc):
        """The schedule for this rank's client: ``own`` the tensors it
        sends, ``recv_like()`` fresh receive buffers, ``decode(parts)``
        the fp32 ``(1, F)`` row of received parts; adds into ``acc`` and
        returns it divided by the count."""
        cnt = torch.ones(1, device=acc.device)
        s64 = s_row.reshape(1).to(torch.int64).contiguous()
        for perm in colours:
            p = int(perm[idx])
            if p == idx:
                continue
            peer = peers[p]
            rs, parts = torch.empty_like(s64), recv_like()
            ops = [dist.P2POp(dist.isend, s64, peer, tag=0),
                   dist.P2POp(dist.irecv, rs, peer, tag=0)]
            for t, (a, b) in enumerate(zip(own, parts), start=1):
                ops += [dist.P2POp(dist.isend, a, peer, tag=t),
                        dist.P2POp(dist.irecv, b, peer, tag=t)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            m = rs == s64
            if adj is not None:
                m = m & (adj[idx, p] > 0)
            mf = m.float()
            acc.add_(decode(parts).mul_(mf[:, None]))
            cnt.add_(mf)
        return acc.div_(cnt[:, None])

    def gathered(mixed, width, device):
        """Every client's mixed row on every rank of the process group:
        ``(N, width)`` fp32 (each client's row as its model-coordinate-0
        rank mixed it)."""
        own = (mixed if mixed is not None
               else torch.zeros((1, width), dtype=torch.float32, device=device))
        rows = [torch.empty_like(own) for _ in range(dist.get_world_size())]
        dist.all_gather(rows, own.contiguous())
        return torch.cat([rows[r] for r in table[:, 0].tolist()])

    def split(c_sel):
        """(rank's leaves (1, …) or None past the mesh, whole input?)."""
        leaves = tree_leaves(c_sel)
        lead = leaves[0].shape[0]
        whole = lead == n and n > 1
        if not whole and lead != 1:
            raise ValueError(
                f"the ppermute mix takes this rank's (1, ...) rows or all {n} "
                f"clients' rows, got a leading axis of {lead}")
        if idx is None and not whole:
            raise RuntimeError("this rank is not in the mesh")
        if idx is None:
            return None, True
        return ([leaf[idx:idx + 1] for leaf in leaves] if whole else leaves), whole

    if comm is not None and comm.codec != "fp32":
        def mix_comm(c_sel, s, key, ef, adj=None):
            start(c_sel.device)
            ch = make_channel(comm, c_sel.shape[-1])
            rows, whole = split(c_sel)
            if whole:
                # every rank holds every row: one encode of all of them (alike
                # on every rank), this client's message taken from it
                enc, _, ef = ch.encode_stream(c_sel, key, ef)
                if idx is not None:
                    enc = {k: v[idx:idx + 1] for k, v in enc.items()}
            else:
                enc, _, ef = ch.encode_stream(rows[0], key, ef)
            mixed = None
            if idx is not None:
                mixed = exchange(ch.to_wire(enc), s[idx:idx + 1] if whole else s, adj,
                                 lambda: ch.wire_buffers(c_sel.device),
                                 lambda parts: ch.decode(ch.from_wire(parts)),
                                 ch.decode(enc))
            if whole:
                mixed = gathered(mixed, ch.x, c_sel.device)
            return mixed.to(c_sel.dtype), ef

        mix_comm.comm_aware = True
        return mix_comm

    def mix(c_sel, s, adj=None):
        leaves = tree_leaves(c_sel)
        start(leaves[0].device)
        rows, whole = split(c_sel)
        widths = [leaf[0].numel() for leaf in leaves]
        mixed = None
        if idx is not None:
            flat = [r.reshape(1, -1).float() for r in rows]
            own = torch.cat(flat, 1) if len(flat) > 1 else flat[0].contiguous()
            mixed = exchange([own], s[idx:idx + 1] if whole else s, adj,
                             lambda: [torch.empty_like(own)], lambda parts: parts[0],
                             own.clone())
        if whole:
            mixed = gathered(mixed, sum(widths), leaves[0].device)
        outs = iter(torch.split(mixed, widths, dim=1))
        return tree_map(lambda leaf: next(outs).reshape((-1,) + leaf.shape[1:])
                        .to(leaf.dtype), c_sel)

    return mix
