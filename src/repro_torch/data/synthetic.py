"""Synthetic mixture-of-clusters classification data (numpy only).

A copy of the JAX package's generator: the same seed gives the same arrays,
bit for bit, so both packages train on identical data. Each client's points
are a U[0.1, 0.9] mixture of S clusters built from Gaussian class
prototypes; cluster 2 rotates the inputs (``rotate``), permutes the labels
(``label_split``), or both (S=4, ``both``) — paper Appendix B.1.
``make_unbalanced_quantity`` skews how much data each client holds
(Appendix B.2.5). ``make_mixture_tokens`` is the LM counterpart: documents
drawn from cluster-specific Markov chains.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ClientDataset:
    """Per-client supervised data with ground-truth cluster provenance.

    x: (N, M, ...) inputs    y: (N, M) int labels
    z_true: (N, M) int true cluster of each point (hidden from algorithms;
            used only for evaluation of clustering quality)
    mix_true: (N, S) true mixture fractions
    x_test/y_test/z_test: per-client held-out split (N, Mt, ...).
    """

    x: np.ndarray
    y: np.ndarray
    z_true: np.ndarray
    mix_true: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    z_test: np.ndarray
    n_classes: int
    n_clusters: int

    @property
    def n_clients(self) -> int:
        return self.x.shape[0]

    @property
    def points_per_client(self) -> int:
        return self.x.shape[1]


def _mixture_counts(
    rng: np.random.Generator, n_clients: int, s: int, m: int,
    lo: float = 0.1, hi: float = 0.9,
) -> np.ndarray:
    """Counts (N, S) per client per cluster, paper-style U[lo,hi] fractions."""
    if s == 1:
        return np.full((n_clients, 1), m, dtype=np.int64)
    # draw the fraction for a random "primary" split, distribute remainder
    counts = np.zeros((n_clients, s), dtype=np.int64)
    for i in range(n_clients):
        fracs = rng.uniform(lo, hi, size=s)
        fracs = fracs / fracs.sum()
        c = np.floor(fracs * m).astype(np.int64)
        c[rng.integers(s)] += m - c.sum()
        counts[i] = c
    return counts


def make_mixture_classification(
    n_clients: int = 20,
    n_clusters: int = 2,
    n_per_client: int = 256,
    n_test_per_client: int = 128,
    n_classes: int = 10,
    dim: int = 64,
    noise: float = 0.45,
    mode: str = "rotate",  # rotate | label_split | both
    seed: int = 0,
) -> ClientDataset:
    """Gaussian-prototype classification with rotation / label-split clusters."""
    assert mode in ("rotate", "label_split", "both")
    if mode == "both":
        assert n_clusters == 4, "mode='both' composes 2x2 clusters"
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((n_classes, dim)).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)

    # orthogonal "rotation" transforms, one per rotation-cluster
    q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    rotations = [np.eye(dim, dtype=np.float32), q.astype(np.float32)]
    # label permutation for label-split clusters (even/odd-style swap)
    perm = np.arange(n_classes)
    perm = np.roll(perm, n_classes // 2)

    def cluster_xform(s: int):
        if mode == "rotate":
            return rotations[s % 2], np.arange(n_classes)
        if mode == "label_split":
            return rotations[0], (perm if s % 2 else np.arange(n_classes))
        rot = rotations[s % 2]
        lab = perm if (s // 2) % 2 else np.arange(n_classes)
        return rot, lab

    m_tr, m_te = n_per_client, n_test_per_client
    counts_tr = _mixture_counts(rng, n_clients, n_clusters, m_tr)
    mix_true = counts_tr / m_tr

    def sample(counts_row):
        xs, ys, zs = [], [], []
        for s, c in enumerate(counts_row):
            if c == 0:
                continue
            rot, lab = cluster_xform(s)
            labels = rng.integers(n_classes, size=c)
            pts = protos[labels] + noise * rng.standard_normal((c, dim)).astype(
                np.float32
            )
            xs.append(pts @ rot.T)
            ys.append(lab[labels])
            zs.append(np.full(c, s, dtype=np.int64))
        x = np.concatenate(xs)
        y = np.concatenate(ys)
        z = np.concatenate(zs)
        p = rng.permutation(len(x))
        return x[p], y[p], z[p]

    X, Y, Z = [], [], []
    Xt, Yt, Zt = [], [], []
    for i in range(n_clients):
        x, y, z = sample(counts_tr[i])
        X.append(x); Y.append(y); Z.append(z)
        # test split uses the same mixture proportions
        counts_te = np.maximum(
            1, np.round(mix_true[i] * m_te)
        ).astype(np.int64)
        counts_te[np.argmax(counts_te)] += m_te - counts_te.sum()
        counts_te = np.maximum(counts_te, 0)
        xt, yt, zt = sample(counts_te)
        Xt.append(xt[:m_te]); Yt.append(yt[:m_te]); Zt.append(zt[:m_te])

    return ClientDataset(
        x=np.stack(X).astype(np.float32),
        y=np.stack(Y).astype(np.int64),
        z_true=np.stack(Z),
        mix_true=mix_true.astype(np.float32),
        x_test=np.stack(Xt).astype(np.float32),
        y_test=np.stack(Yt).astype(np.int64),
        z_test=np.stack(Zt),
        n_classes=n_classes,
        n_clusters=n_clusters,
    )


def make_unbalanced_quantity(
    base: ClientDataset, ratio: float, seed: int = 0
) -> ClientDataset:
    """Appendix B.2.5: low/average/high data holders with max/min ratio r.

    A third of the clients (chosen from ``seed``) keep m/r of their points
    (at least 8), the rest keep all m; a low holder's slots are refilled
    from its kept points, so every shape stays (N, M, ...).
    """
    rng = np.random.default_rng(seed)
    n, m = base.x.shape[0], base.x.shape[1]
    x, y, z = base.x.copy(), base.y.copy(), base.z_true.copy()
    groups = np.array_split(rng.permutation(n), 3)
    low = groups[0]
    keep_low = max(8, int(round(m / max(ratio, 1.0))))
    for i in low:
        idx = rng.choice(m, size=keep_low, replace=False)
        rep = idx[rng.integers(keep_low, size=m)]
        x[i], y[i], z[i] = x[i][rep], y[i][rep], z[i][rep]
    return dataclasses.replace(base, x=x, y=y, z_true=z)


def make_mixture_tokens(
    n_clients: int = 16,
    n_clusters: int = 2,
    docs_per_client: int = 64,
    seq_len: int = 256,
    vocab: int = 512,
    seed: int = 0,
    concentration: float = 0.25,
) -> dict:
    """Cluster-specific Markov chains over a shared vocab: the LM analogue
    of the rotated-image clusters, as the JAX package's generator makes it
    from the same seed.

    Returns tokens ``(N, D, L)`` int32, z_true ``(N, D)``, mix_true ``(N,
    S)``. Each cluster's transition matrix is a Dirichlet draw per row, so
    next-token statistics differ across clusters."""
    rng = np.random.default_rng(seed)
    trans = [rng.dirichlet(np.full(vocab, concentration), size=vocab).astype(np.float64)
             for _ in range(n_clusters)]
    counts = _mixture_counts(rng, n_clients, n_clusters, docs_per_client)

    tokens = np.zeros((n_clients, docs_per_client, seq_len), dtype=np.int32)
    z_true = np.zeros((n_clients, docs_per_client), dtype=np.int64)
    for i in range(n_clients):
        d = 0
        for s, c in enumerate(counts[i]):
            for _ in range(c):
                seq = np.zeros(seq_len, dtype=np.int32)
                seq[0] = rng.integers(vocab)
                t = trans[s]
                for k in range(1, seq_len):
                    seq[k] = rng.choice(vocab, p=t[seq[k - 1]])
                tokens[i, d] = seq
                z_true[i, d] = s
                d += 1
        p = rng.permutation(docs_per_client)
        tokens[i] = tokens[i][p]
        z_true[i] = z_true[i][p]
    return {
        "tokens": tokens,
        "z_true": z_true,
        "mix_true": (counts / docs_per_client).astype(np.float32),
        "vocab": vocab,
        "n_clusters": n_clusters,
    }
