"""Mixing (weight) matrices and consensus-rate estimation (numpy only).

A copy of the JAX package's ``graphs/mixing.py``: the same graph gives the
same matrices, bit for bit.

FedSPD's cluster-center update (paper Eq. (1)) averages over the closed
neighborhood *restricted to clients that selected the same cluster this
round*; the resulting W_s^t is row-stochastic but data-dependent. We build it
on the device inside core/gossip.py. This module provides the *static* pieces:

- classical doubly-stochastic gossip matrices (Metropolis–Hastings, uniform)
  used by the decentralized baselines (FedAvg/FedEM/IFCA/... all gossip with
  a fixed W);
- spectral-gap estimation, which lower-bounds the paper's expected consensus
  rate ``p`` of Assumption 5.7 (E||C W - C̄||² ≤ (1-p)||C - C̄||²; for a
  static doubly-stochastic W, p = 1 - λ₂(WᵀW)).
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.topology import Graph


def metropolis_weights(graph: Graph) -> np.ndarray:
    """Metropolis–Hastings weights: symmetric, doubly stochastic.

    W_ij = 1 / (1 + max(d_i, d_j)) for edges, diagonal absorbs the rest.
    Doubly-stochastic W preserves the parameter average (paper Lemma A.1).
    """
    n = graph.n
    deg = graph.degrees
    w = np.zeros((n, n), dtype=np.float64)
    for i, j in graph.edges():
        w[i, j] = w[j, i] = 1.0 / (1.0 + max(deg[i], deg[j]))
    np.fill_diagonal(w, 1.0 - w.sum(axis=1))
    return w.astype(np.float32)


def uniform_neighbor_weights(graph: Graph) -> np.ndarray:
    """Row-stochastic closed-neighborhood averaging: W = A_aug / rowsum.

    This is FedSPD Eq. (1) in the degenerate case where *every* neighbor
    selected the same cluster. Not doubly stochastic in general.
    """
    adj = graph.adj
    return (adj / adj.sum(axis=1, keepdims=True)).astype(np.float32)


def spectral_gap(w: np.ndarray) -> float:
    """1 - |λ₂(W)|: the classical measure of gossip mixing speed."""
    ev = np.linalg.eigvals(w.astype(np.float64))
    mags = np.sort(np.abs(ev))[::-1]
    return float(1.0 - (mags[1] if len(mags) > 1 else 0.0))


def consensus_rate_p(w: np.ndarray) -> float:
    """The constant p of Assumption 5.7 for a static W (β=1):
    ||C W - C̄||_F² ≤ (1-p) ||C - C̄||_F² with p = 1 - σ₂(W)² where σ₂ is the
    second-largest singular value of the doubly-stochastic W."""
    sv = np.linalg.svd(w.astype(np.float64), compute_uv=False)
    s2 = sv[1] if len(sv) > 1 else 0.0
    return float(max(0.0, min(1.0, 1.0 - s2 * s2)))


def expected_fedspd_consensus_rate(
    graph: Graph, selection_probs: np.ndarray, n_rounds: int = 64, seed: int = 0
) -> float:
    """Monte-Carlo estimate of the paper's Assumption-5.7 constant for the
    *data-dependent* FedSPD mixing process of one cluster.

    Per round, each client selects the cluster with prob u_{i,s}; only
    selecting clients mix (closed neighborhood ∩ same selection). We measure
    the per-round Frobenius contraction of a random C toward its mean and
    report the empirical worst-case rate. Host-side diagnostic (numpy).
    """
    rng = np.random.default_rng(seed)
    n = graph.n
    worst = 1.0
    for _ in range(n_rounds):
        sel = rng.random(n) < selection_probs  # clients updating this cluster
        w = np.eye(n, dtype=np.float64)
        for i in range(n):
            if not sel[i]:
                continue
            nbrs = [j for j in graph.neighbors(i) if sel[j]] + [i]
            w[i, :] = 0.0
            w[i, nbrs] = 1.0 / len(nbrs)
        c = rng.standard_normal((n, 16))
        cb = c.mean(axis=0, keepdims=True)
        num = np.linalg.norm(w @ c - (w @ c).mean(axis=0, keepdims=True)) ** 2
        den = np.linalg.norm(c - cb) ** 2
        worst = min(worst, 1.0 - num / den) if den > 0 else worst
    return float(max(0.0, worst))
