"""Client communication topologies (numpy only).

A copy of the JAX package's static generators: Erdős–Rényi, Barabási–Albert,
random geometric, ring and complete graphs, each repaired to be connected,
and ``union_graph`` over a stack of adjacencies. The same seed gives the
same adjacency, bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected client graph. ``adj`` is the augmented adjacency matrix
    (diagonal = 1, as in the paper's Table 1) over N clients."""

    adj: np.ndarray  # (N, N) float32, symmetric, diag == 1

    @property
    def n(self) -> int:
        return self.adj.shape[0]

    @property
    def degrees(self) -> np.ndarray:
        """Open-neighborhood degrees."""
        return self.adj.sum(axis=1) - 1.0

    @property
    def avg_degree(self) -> float:
        return float(self.degrees.mean())

    def neighbors(self, i: int) -> np.ndarray:
        nbrs = np.nonzero(self.adj[i])[0]
        return nbrs[nbrs != i]

    def edges(self) -> list[tuple[int, int]]:
        iu, ju = np.triu_indices(self.n, k=1)
        mask = self.adj[iu, ju] > 0
        return list(zip(iu[mask].tolist(), ju[mask].tolist()))

    def is_connected(self) -> bool:
        return _is_connected(self.adj)


def _is_connected(adj: np.ndarray) -> bool:
    n = adj.shape[0]
    seen = np.zeros(n, dtype=bool)
    stack = [0]
    seen[0] = True
    while stack:
        v = stack.pop()
        for u in np.nonzero(adj[v])[0]:
            if not seen[u]:
                seen[u] = True
                stack.append(int(u))
    return bool(seen.all())


def _augment(adj: np.ndarray) -> np.ndarray:
    adj = adj.astype(np.float32)
    adj = np.maximum(adj, adj.T)
    np.fill_diagonal(adj, 1.0)
    return adj


def _connect_components(adj: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Add random edges between components until connected."""
    n = adj.shape[0]
    while not _is_connected(adj):
        # find a component and wire it to the rest
        seen = np.zeros(n, dtype=bool)
        stack = [0]
        seen[0] = True
        while stack:
            v = stack.pop()
            for u in np.nonzero(adj[v])[0]:
                if not seen[u]:
                    seen[u] = True
                    stack.append(int(u))
        inside = np.nonzero(seen)[0]
        outside = np.nonzero(~seen)[0]
        i = rng.choice(inside)
        j = rng.choice(outside)
        adj[i, j] = adj[j, i] = 1.0
    return adj


def erdos_renyi(n: int, p: float, seed: int = 0) -> Graph:
    """Connected ER graph with link probability ``p`` (paper default)."""
    rng = np.random.default_rng(seed)
    u = rng.random((n, n))
    # mask AFTER thresholding: np.triu(u)<p would turn every zeroed
    # lower-triangle entry into an edge (0 < p), yielding a complete graph
    adj = np.triu((u < p).astype(np.float32), k=1)
    adj = _connect_components(_augment(adj), rng)
    return Graph(_augment(adj))


def barabasi_albert(n: int, m: int, seed: int = 0) -> Graph:
    """BA preferential attachment with ``m`` edges per new node."""
    rng = np.random.default_rng(seed)
    m = max(1, min(m, n - 1))
    adj = np.zeros((n, n), dtype=np.float32)
    # seed clique of m+1 nodes
    for i in range(m + 1):
        for j in range(i + 1, m + 1):
            adj[i, j] = adj[j, i] = 1.0
    deg = adj.sum(axis=1)
    for v in range(m + 1, n):
        probs = deg[:v] / deg[:v].sum()
        targets = rng.choice(v, size=m, replace=False, p=probs)
        for t in targets:
            adj[v, t] = adj[t, v] = 1.0
        deg = adj.sum(axis=1)
    adj = _connect_components(adj, rng)
    return Graph(_augment(adj))


def random_geometric(n: int, radius: float, seed: int = 0) -> Graph:
    """RGG on the unit square; edge iff distance < radius."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    d = np.linalg.norm(pts[:, None, :] - pts[None, :, :], axis=-1)
    adj = (d < radius).astype(np.float32)
    np.fill_diagonal(adj, 0.0)
    adj = _connect_components(_augment(adj), rng)
    return Graph(_augment(adj))


def ring(n: int) -> Graph:
    adj = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        adj[i, (i + 1) % n] = adj[(i + 1) % n, i] = 1.0
    return Graph(_augment(adj))


def complete(n: int) -> Graph:
    return Graph(_augment(np.ones((n, n), dtype=np.float32)))


def make_graph(kind: str, n: int, avg_degree: float, seed: int = 0) -> Graph:
    """Uniform factory used by configs/benchmarks: target an average degree."""
    if kind == "er":
        p = min(1.0, avg_degree / max(n - 1, 1))
        return erdos_renyi(n, p, seed)
    if kind == "ba":
        return barabasi_albert(n, max(1, int(round(avg_degree / 2))), seed)
    if kind == "rgg":
        # E[deg] ~ n * pi * r^2 on unit square (ignoring edge effects)
        r = float(np.sqrt(avg_degree / (np.pi * max(n, 2))))
        return random_geometric(n, r, seed)
    if kind == "ring":
        return ring(n)
    if kind == "complete":
        return complete(n)
    raise ValueError(f"unknown graph kind: {kind}")


def union_graph(adjs: np.ndarray) -> Graph:
    """The union over a stack of adjacencies (leading axis: rounds or
    seeds): what the static wiring of a run whose steps each take one of
    the stacked adjacencies must cover."""
    return Graph(_augment(np.asarray(adjs).max(axis=0)))
