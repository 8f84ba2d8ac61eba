"""FedSPD's cluster-matched gossip (paper Eq. (1)) and its byte accounting.

The dense wiring: the row-stochastic weight matrix W is built on the
device from the adjacency and this round's cluster selections, then
applied over the client axis, C_s <- W C_s. The mix is the hand-written
Hopper kernel ``kernels/gossip_mix`` (the counterpart of the JAX package's
``pallas`` backend), one launch per mix; DP rounds use its fused
clip·scale + W·C sibling. With a wire codec (``make_mix_fn(comm=...)``)
int8/int4 payloads are mixed by the fused dequantize+mix kernel straight
off the encoded plane, and topk payloads are decoded and mixed by the flat
kernel; the sparse (DisPFL) exchange's products go through the
slab-skipping kernels. The tensor's device picks the execution: on a CUDA
tensor the wrapper launches the kernel, on a CPU tensor it runs the
kernel's plain version.

The edge-coloured ``permute`` wiring and cosine alignment are not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.comm.codecs import CommConfig, make_channel
from repro_torch.graphs.topology import Graph
from repro_torch.kernels.gossip_mix import (
    gossip_mix_encoded,
    gossip_mix_encoded_masked,
    gossip_mix_flat,
    gossip_mix_fused_dp,
    gossip_mix_sparse,
)

# "reference" (the JAX package's default name) is another name for the
# same path: the port has one mix, and the device decides how it runs
MIX_BACKENDS = ("cuda", "reference")


@dataclasses.dataclass(frozen=True)
class GossipSpec:
    """The dense wiring over a static graph (the JAX spec's ``mode`` and
    ``cos_align_threshold`` are not ported; ``RunConfig`` refuses them)."""

    adj: np.ndarray  # augmented adjacency (diag 1)

    @staticmethod
    def from_graph(graph: Graph) -> "GossipSpec":
        return GossipSpec(adj=graph.adj)


def _adjacency(spec: GossipSpec, adj, device) -> torch.Tensor:
    if adj is None:
        adj = spec.adj
    return torch.as_tensor(adj, dtype=torch.float32, device=device)


def fedspd_weight_matrix(spec: GossipSpec, s: torch.Tensor,
                         adj=None) -> torch.Tensor:
    """Row-stochastic W for the selected clusters: W[i, j] > 0 iff j is in
    i's closed neighbourhood and s_j == s_i. The adjacency (``adj``
    overrides the spec's, and may be weighted) is masked by the selection
    match, the diagonal is set to 1, and rows are normalised."""
    a = _adjacency(spec, adj, s.device)
    w = a * (s[None, :] == s[:, None]).float()
    w.fill_diagonal_(1.0)
    return w / w.sum(dim=1, keepdim=True)


def mix_dense(spec: GossipSpec, c_sel: torch.Tensor, s: torch.Tensor,
              adj=None) -> torch.Tensor:
    """Paper-faithful C <- W C over the client axis, fp32: one
    ``gossip_mix_flat`` launch on a CUDA tensor, its plain version on a
    CPU tensor."""
    w = fedspd_weight_matrix(spec, s, adj=adj)
    return gossip_mix_flat(w, c_sel).to(c_sel.dtype)


def make_mix_fn(spec: GossipSpec, backend: str = "cuda",
                comm: CommConfig | None = None):
    """The exchange for ``core/fedspd.make_round_step`` over the packed
    ``(N, X)`` plane (the JAX ``plane=True`` form).

    Without a compressing codec: ``mix(c_sel, s, adj=None)``, with
    ``mix.fused_dp(c_old, c_new, scale, noise, sigma, s, adj=None)``, the
    fused DP kernel, whose W comes from the selections alone.

    With one (``comm``, int8/int4/topk): ``mix(c_sel, s, key, ef,
    adj=None) -> (mixed, ef')``, ``mix.comm_aware`` set. ``key`` is the
    codec's draw (see ``comm/codecs.quant_encode``), ``ef`` the
    error-feedback residual. int8/int4 encode (plus the residual update),
    then mix the payload in ``gossip_mix_dequant``; topk decodes, then
    mixes in ``gossip_mix_flat``.

    Both carry the sparse exchange's products: ``mix.sparse_matmul(w, v,
    col_active)`` (``gossip_mix_sparse``) and, with a codec,
    ``mix.sparse_dequant(w, enc, mask, col_active)``
    (``gossip_mix_dequant_masked``, for int8/int4 payloads)."""
    if backend not in MIX_BACKENDS:
        raise ValueError(
            f"unknown gossip backend {backend!r}; the port has {MIX_BACKENDS}")

    if comm is None or comm.codec == "fp32":
        def mix(c_sel, s, adj=None):
            return mix_dense(spec, c_sel, s, adj=adj)

        def fused_dp(c_old, c_new, scale, noise, sigma, s, adj=None):
            w = fedspd_weight_matrix(spec, s, adj=adj)
            return gossip_mix_fused_dp(w, c_old, c_new, scale, noise,
                                       sigma).to(c_old.dtype)

        mix.fused_dp = fused_dp
        mix.sparse_matmul = gossip_mix_sparse
        return mix

    def mix_comm(c_sel, s, key, ef, adj=None):
        x = c_sel.shape[-1]
        ch = make_channel(comm, x)
        w = fedspd_weight_matrix(spec, s, adj=adj)
        if ch.fused:
            enc, _, ef = ch.encode_stream(c_sel, key, ef)
            return gossip_mix_encoded(w, enc, qblock=comm.block, x_out=x), ef
        x_hat, ef = ch.roundtrip(c_sel, key, ef)
        return gossip_mix_flat(w, x_hat).to(c_sel.dtype), ef

    def sparse_dequant(w, enc, mask, col_active):
        return gossip_mix_encoded_masked(w, enc, mask, col_active, qblock=comm.block)

    mix_comm.comm_aware = True
    mix_comm.sparse_matmul = gossip_mix_sparse
    mix_comm.sparse_dequant = sparse_dequant
    return mix_comm


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
