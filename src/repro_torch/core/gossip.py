"""FedSPD's cluster-matched gossip (paper Eq. (1)) and its byte accounting.

Two wirings compute the same mixing (``GossipSpec.mode``):

- ``dense``: the row-stochastic weight matrix W is built on the device
  from the adjacency and this round's cluster selections, then applied
  over the client axis, C_s <- W C_s;
- ``permute``: the graph's edges are coloured on the host
  (graphs/coloring.py), and ``mix_permute`` accumulates one gather and
  one masked add per colour class, then divides by the count. Every
  neighbour appears in exactly one class, so it reproduces Eq. (1).

Cosine alignment (paper §6 "Client communications",
``cos_align_threshold > -1``): a neighbour's model joins the average only
if its cosine similarity to the receiver's is at least the threshold.

The exchange of ``make_mix_fn``'s ``"cuda"`` backend (the counterpart of
the JAX package's ``pallas``) builds the dense W, with the cosine mask
when alignment is on, and mixes in the hand-written Hopper kernel
``kernels/gossip_mix``, one launch per mix, whatever the mode; DP rounds
without alignment use its fused clip·scale + W·C sibling. With a wire
codec int8/int4 payloads are mixed by the fused dequantize+mix kernel
straight off the encoded plane, and topk payloads are decoded and mixed
by the flat kernel; the sparse (DisPFL) exchange's products go through
the slab-skipping kernels. The tensor's device picks the execution: on a
CUDA tensor the wrapper launches the kernel, on a CPU tensor it runs the
kernel's plain version. The ``"reference"`` backend runs ``mix`` (the
spec's own wiring); for the dense wiring it is the ``"cuda"`` exchange.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.comm.codecs import CommConfig, make_channel
from repro_torch.graphs.coloring import permute_schedule
from repro_torch.graphs.topology import Graph
from repro_torch.kernels.gossip_mix import (
    gossip_mix_encoded,
    gossip_mix_encoded_masked,
    gossip_mix_flat,
    gossip_mix_fused_dp,
    gossip_mix_sparse,
    gossip_mix_tree,
)
from repro_torch.utils.pytree import tree_leaves, tree_map

# "cuda" is the JAX package's "pallas": the dense W through the kernels.
# "reference" is the JAX package's default: the spec's wiring (``mix``).
# "ppermute": the edge-coloured send/recv schedule over one rank a client
# (launch/steps.make_ppermute_gossip_mix)
MIX_BACKENDS = ("cuda", "reference", "ppermute")
MODES = ("dense", "permute")


@dataclasses.dataclass(frozen=True)
class GossipSpec:
    """The wiring over a static graph: the augmented adjacency, the mode,
    the alignment threshold (-1 disables it) and the colour classes'
    permutations (for ``mode="permute"``)."""

    adj: np.ndarray  # augmented adjacency (diag 1)
    mode: str = "dense"
    cos_align_threshold: float = -1.0
    perms: tuple = ()
    # the permutations as one (colours, N) int64 tensor per device, made
    # on first use (outside a graph capture: the warm-up makes it)
    _on_device: dict = dataclasses.field(default_factory=dict, compare=False,
                                         repr=False)

    @staticmethod
    def from_graph(graph: Graph, mode: str = "dense",
                   cos_align_threshold: float = -1.0) -> "GossipSpec":
        if mode not in MODES:
            raise ValueError(f"unknown gossip mode {mode!r}")
        return GossipSpec(adj=graph.adj, mode=mode,
                          cos_align_threshold=float(cos_align_threshold),
                          perms=tuple(np.asarray(p) for p in permute_schedule(graph)))

    @property
    def aligned(self) -> bool:
        return self.cos_align_threshold > -1.0

    def perms_on(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._on_device:
            n = self.adj.shape[0]
            stack = np.stack(self.perms) if self.perms else np.zeros((0, n), np.int64)
            self._on_device[device] = torch.as_tensor(stack, dtype=torch.int64,
                                                      device=device)
        return self._on_device[device]


def _adjacency(spec: GossipSpec, adj, device) -> torch.Tensor:
    if adj is None:
        adj = spec.adj
    return torch.as_tensor(adj, dtype=torch.float32, device=device)


def _pairwise_cos(c_sel) -> torch.Tensor:
    """``(N, N)`` cosine similarity between the clients' selected models
    (an ``(N, X)`` plane or a tree of ``(N, ...)`` leaves): the Gram
    matrices of the leaves, each viewed as ``(N, -1)`` in fp32, added in
    leaf order, over the outer product of the row norms."""
    gram = None
    for leaf in tree_leaves(c_sel):
        flat = leaf.float().reshape(leaf.shape[0], -1)
        g = torch.matmul(flat, flat.T)
        gram = g if gram is None else gram + g
    norms = torch.sqrt(torch.diagonal(gram).clamp_min(1e-24))
    return gram / (norms[:, None] * norms[None, :])


def fedspd_weight_matrix(spec: GossipSpec, s: torch.Tensor, c_sel=None,
                         adj=None) -> torch.Tensor:
    """Row-stochastic W for the selected clusters: W[i, j] > 0 iff j is in
    i's closed neighbourhood, s_j == s_i and, with alignment on and
    ``c_sel`` given, cos(c_j, c_i) >= the threshold. The adjacency
    (``adj`` overrides the spec's, and may be weighted) is masked by the
    selection match and the cosine mask, the diagonal is set to 1, and
    rows are normalised."""
    a = _adjacency(spec, adj, s.device)
    w = a * (s[None, :] == s[:, None]).float()
    if spec.aligned and c_sel is not None:
        w = w * (_pairwise_cos(c_sel) >= spec.cos_align_threshold).float()
    w.fill_diagonal_(1.0)
    return w / w.sum(dim=1, keepdim=True)


def mix_dense(spec: GossipSpec, c_sel, s: torch.Tensor, adj=None):
    """Paper-faithful C <- W C over the client axis, fp32: one
    ``gossip_mix_flat`` launch per leaf (one for the plane) on CUDA
    tensors, its plain version on CPU tensors."""
    return gossip_mix_tree(fedspd_weight_matrix(spec, s, c_sel, adj=adj), c_sel)


def mix_permute(spec: GossipSpec, c_sel, s: torch.Tensor, adj=None):
    """The edge-coloured accumulate: per colour class one gather of the
    partners' rows and one masked add (leaf by leaf), then the division
    by the count. ``adj`` (this round's adjacency) must be a subgraph of
    the spec's graph, the colouring being the spec's; it is read as a
    binary mask (a weighted entry counts as a link)."""
    n = s.shape[0]
    c32 = tree_map(lambda leaf: leaf.float(), c_sel)
    cos = _pairwise_cos(c32) if spec.aligned else None
    idx = torch.arange(n, device=s.device)
    acc, cnt = c32, torch.ones(n, device=s.device)

    def rows(v, leaf):
        return v.reshape((-1,) + (1,) * (leaf.dim() - 1))

    for p in spec.perms_on(s.device):
        match = (s[p] == s) & (p != idx)
        if adj is not None:
            match = match & (adj[idx, p] > 0)
        if cos is not None:
            match = match & (cos[idx, p] >= spec.cos_align_threshold)
        mf = match.float()
        acc = tree_map(lambda a, leaf: a + rows(mf, leaf) * leaf[p], acc, c32)
        cnt = cnt + mf
    inv = 1.0 / cnt
    return tree_map(lambda a, leaf: (a * rows(inv, a)).to(leaf.dtype), acc, c_sel)


def mix(spec: GossipSpec, c_sel, s: torch.Tensor, adj=None):
    """Eq. (1) on the spec's wiring."""
    if spec.mode == "dense":
        return mix_dense(spec, c_sel, s, adj=adj)
    if spec.mode == "permute":
        return mix_permute(spec, c_sel, s, adj=adj)
    raise ValueError(f"unknown gossip mode {spec.mode!r}")


def make_mix_fn(spec: GossipSpec, backend: str = "cuda",
                comm: CommConfig | None = None, *, plane: bool = True, mesh=None):
    """The exchange for ``core/fedspd.make_round_step``: over the packed
    ``(N, X)`` plane (the JAX ``plane=True`` form), or with
    ``plane=False`` over the pytree engine's tree of ``(N, ...)`` leaves.

    Backends, as in the JAX package: ``"cuda"`` (JAX's ``pallas``) builds
    the dense W, with the cosine mask from the mixed values when
    alignment is on, and mixes in the kernels whatever ``spec.mode`` is;
    ``"reference"`` runs ``mix``, so ``mode="permute"`` runs
    ``mix_permute``, and for ``mode="dense"`` it is ``"cuda"``.

    Without a compressing codec: ``mix(c_sel, s, adj=None)``. On
    ``"cuda"`` (and ``"reference"`` with the dense wiring) without
    alignment it carries ``mix.fused_dp(c_old, c_new, scale, noise,
    sigma, s, adj=None)``, the fused DP kernel, whose W comes from the
    selections alone; with alignment W depends on the sanitized values,
    so there is no ``fused_dp`` and a DP round sanitizes, then mixes.

    With one (``comm``, int8/int4/topk): ``mix(c_sel, s, key, ef,
    adj=None) -> (mixed, ef')``, ``mix.comm_aware`` set. ``key`` is the
    codec's draw (see ``comm/codecs.quant_encode``), ``ef`` the
    error-feedback residual. On ``"cuda"`` int8/int4 encode (plus the
    residual update), then mix the payload in ``gossip_mix_dequant``;
    topk decodes, then mixes in ``gossip_mix_flat``; with alignment W
    comes from the decoded values. ``"reference"`` with the permute
    wiring decodes, then runs ``mix_permute``.

    Every mix carries the sparse exchange's products (its W is the dense
    one in either wiring): ``mix.sparse_matmul(w, v, col_active)``
    (``gossip_mix_sparse``) and, with a codec, ``mix.sparse_dequant(w,
    enc, mask, col_active)`` (``gossip_mix_dequant_masked``, for int8/int4
    payloads).

    With ``plane=False`` (the JAX ``plane=False`` form) the mix is
    ``mix(c_sel, s, adj=None)`` on a tree: on ``"cuda"`` the dense W, then
    one ``gossip_mix_flat`` launch per leaf (``gossip_mix_tree``, the JAX
    ``pallas`` backend's pytree branch). It carries no ``fused_dp`` (a
    pytree DP round sanitizes leaf by leaf, then mixes) and no sparse
    products; a compressing codec raises, as in JAX.

    ``"ppermute"`` (JAX's ``ppermute``) runs ``launch/steps.
    make_ppermute_gossip_mix`` over ``mesh``, one rank a client; without
    one it makes an ``(N, 1)`` ("data", "model") mesh of the process
    group's first N ranks (CUDA under NCCL, else the CPU), and every rank
    returns the whole mixed input. It needs an initialized process group
    of at least N ranks, and refuses cosine alignment, as JAX does. It
    carries no ``fused_dp`` and no sparse products."""
    if backend not in MIX_BACKENDS:
        raise ValueError(
            f"unknown gossip backend {backend!r}; the port has {MIX_BACKENDS}")
    by_mode = backend == "reference" and spec.mode != "dense"
    compressing = comm is not None and comm.codec != "fp32"
    if compressing and not plane:
        raise ValueError(
            f"comm codec {comm.codec!r} operates on packed (N, X) plane "
            "slices; build the mix with plane=True (run_method enables "
            "param_plane automatically when comm is set)")
    if backend == "ppermute":
        return _ppermute_mix(spec, comm, mesh)
    if not plane:
        def tree_mix(c_sel, s, adj=None):
            return (mix if by_mode else mix_dense)(spec, c_sel, s, adj=adj)

        return tree_mix

    if not compressing:
        if by_mode:
            def mix_fn(c_sel, s, adj=None):
                return mix(spec, c_sel, s, adj=adj)
        else:
            def mix_fn(c_sel, s, adj=None):
                return mix_dense(spec, c_sel, s, adj=adj)

            def fused_dp(c_old, c_new, scale, noise, sigma, s, adj=None):
                w = fedspd_weight_matrix(spec, s, adj=adj)
                return gossip_mix_fused_dp(w, c_old, c_new, scale, noise,
                                           sigma).to(c_old.dtype)

            if not spec.aligned:
                mix_fn.fused_dp = fused_dp
        mix_fn.sparse_matmul = gossip_mix_sparse
        return mix_fn

    if by_mode:
        def mix_comm(c_sel, s, key, ef, adj=None):
            x_hat, ef = make_channel(comm, c_sel.shape[-1]).roundtrip(c_sel, key, ef)
            return mix(spec, x_hat, s, adj=adj).to(c_sel.dtype), ef
    else:
        def mix_comm(c_sel, s, key, ef, adj=None):
            x = c_sel.shape[-1]
            ch = make_channel(comm, x)
            if ch.fused:
                enc, x_hat, ef = ch.encode_stream(c_sel, key, ef, need_hat=spec.aligned)
                w = fedspd_weight_matrix(spec, s, x_hat, adj=adj)
                return gossip_mix_encoded(w, enc, qblock=comm.block, x_out=x), ef
            x_hat, ef = ch.roundtrip(c_sel, key, ef)
            w = fedspd_weight_matrix(spec, s, x_hat, adj=adj)
            return gossip_mix_flat(w, x_hat).to(c_sel.dtype), ef

    def sparse_dequant(w, enc, mask, col_active):
        return gossip_mix_encoded_masked(w, enc, mask, col_active, qblock=comm.block)

    mix_comm.comm_aware = True
    mix_comm.sparse_matmul = gossip_mix_sparse
    mix_comm.sparse_dequant = sparse_dequant
    return mix_comm


def _ppermute_mix(spec: GossipSpec, comm, mesh):
    """The ``"ppermute"`` backend (see ``make_mix_fn``)."""
    if spec.aligned:
        raise ValueError(
            "ppermute backend does not implement cosine-alignment "
            "filtering; use the reference or cuda backend")
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import make_ppermute_gossip_mix

    n = spec.adj.shape[0]
    if mesh is None:
        world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0
        if world < n:
            raise RuntimeError(
                "ppermute backend needs one device per client "
                f"({n} clients, {world} ranks in the process group) — run each "
                "rank under torch.distributed (e.g. torchrun --nproc-per-node "
                f"{n}), one rank a client")
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        mesh = make_test_mesh((n, 1), ("data", "model"), device_type=device_type)
    return make_ppermute_gossip_mix(spec, mesh, replicate_model_dims=True, comm=comm)


def round_comm_bytes(spec: GossipSpec, s: torch.Tensor, model_bytes: int, *,
                     point_to_point: bool = True, adj=None) -> torch.Tensor:
    """Bytes sent this round over all clients, as an fp32 scalar.
    Point-to-point FedSPD: a client sends its model only to the neighbours
    that selected the same cluster (paper §6.3). A given ``adj`` is
    binarised (a link ships a whole model or nothing) and its diagonal
    zeroed multiplicatively."""
    a = _adjacency(spec, adj, s.device)
    if adj is not None:
        a = (a > 0).float()
    a = a * (1.0 - torch.eye(a.shape[0], device=a.device))
    if point_to_point:
        a = a * (s[None, :] == s[:, None]).float()
    return a.sum() * float(model_bytes)


def consensus_distance(c_stack) -> torch.Tensor:
    """Theorem 5.10's E_t: the mean over clients of the squared distance of
    each client's center to the client average, summed over the leaves of
    a tree of ``(N, ...)`` leaves (in sorted key order, as the JAX package
    walks them) or over one ``(N, X)`` tensor."""
    total = None
    for leaf in tree_leaves(c_stack):
        l32 = leaf.float()
        d = (l32 - l32.mean(dim=0, keepdim=True)).square().sum() / leaf.shape[0]
        total = d if total is None else total + d
    return total
