"""Client communication topologies (numpy only).

A copy of the JAX package's generators: Erdős–Rényi, Barabási–Albert,
random geometric, ring, complete and pod-aware graphs, each repaired to be
connected; ``union_graph`` over a stack of adjacencies; and the dynamic
topologies of Appendix B.2.4 (``rewire``, ``GraphSchedule``,
``rewire_schedule``, ``stack_schedule``) with per-round Bernoulli link
failures (``symmetric_mask_drop``, ``drop_edges``, ``dropout_schedule``).
The same seed gives the same adjacency, bit for bit.
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


def pod_aware(
    n_per_pod: int,
    n_pods: int,
    intra_p: float = 0.4,
    bridges_per_pod_pair: int = 2,
    seed: int = 0,
) -> Graph:
    """Dense ER within each pod, a few bridge edges between pods: the
    low-connectivity regime at the pod boundary."""
    rng = np.random.default_rng(seed)
    n = n_per_pod * n_pods
    adj = np.zeros((n, n), dtype=np.float32)
    for p in range(n_pods):
        lo = p * n_per_pod
        sub = erdos_renyi(n_per_pod, intra_p, seed=seed + 17 * p).adj
        adj[lo : lo + n_per_pod, lo : lo + n_per_pod] = sub
    for a in range(n_pods):
        for b in range(a + 1, n_pods):
            for _ in range(bridges_per_pod_pair):
                i = a * n_per_pod + rng.integers(n_per_pod)
                j = b * n_per_pod + rng.integers(n_per_pod)
                adj[i, j] = adj[j, i] = 1.0
    adj = _connect_components(adj, rng)
    return Graph(_augment(adj))


def rewire(graph: Graph, p_remove: float, seed: int = 0) -> Graph:
    """Dynamic topology (Appendix B.2.4): each existing edge is removed with
    probability ``p_remove``; as many random non-edges are added back (the
    average degree stays about constant), and connectivity is repaired."""
    rng = np.random.default_rng(seed)
    n = graph.n
    adj = graph.adj.copy()
    np.fill_diagonal(adj, 0.0)
    removed = 0
    for (i, j) in graph.edges():
        if rng.random() < p_remove:
            adj[i, j] = adj[j, i] = 0.0
            removed += 1
    added = 0
    attempts = 0
    while added < removed and attempts < 50 * max(removed, 1):
        attempts += 1
        i, j = rng.integers(n), rng.integers(n)
        if i != j and adj[i, j] == 0:
            adj[i, j] = adj[j, i] = 1.0
            added += 1
    adj = _connect_components(_augment(adj), rng)
    return Graph(_augment(adj))


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


@dataclasses.dataclass(frozen=True)
class GraphSchedule:
    """A per-round sequence of client graphs (Appendix B.2.4). ``adjs``
    stacks the augmented adjacencies; the round step takes one ``(N, N)``
    slice a round."""

    adjs: np.ndarray  # (rounds, N, N) float32, each symmetric, diag == 1

    @property
    def rounds(self) -> int:
        return self.adjs.shape[0]

    @property
    def n(self) -> int:
        return self.adjs.shape[1]

    def graph(self, t: int) -> Graph:
        return Graph(self.adjs[t % self.rounds])

    def union(self) -> Graph:
        """The union graph over every scheduled round."""
        return union_graph(self.adjs)


def stack_schedule(adjs: np.ndarray, rounds: int) -> np.ndarray:
    """Cycle or crop a stacked schedule to exactly ``rounds`` ``(rounds, N,
    N)`` matrices: a shorter schedule cycles (a schedule is a topology
    process, not a fixed-length tape), a longer one is cropped."""
    adjs = np.asarray(adjs, dtype=np.float32)
    if adjs.ndim != 3 or adjs.shape[1] != adjs.shape[2]:
        raise ValueError(
            f"graph_schedule must stack (rounds, N, N) adjacencies; "
            f"got shape {adjs.shape}"
        )
    reps = -(-rounds // adjs.shape[0])
    return np.ascontiguousarray(np.tile(adjs, (reps, 1, 1))[:rounds])


def rewire_schedule(
    kind: str, n: int, avg_degree: float, rounds: int,
    p_rewire: float = 0.3, seed: int = 0,
) -> GraphSchedule:
    """Dynamically rewired ER/BA/RGG topologies (Appendix B.2.4): round 0 is
    ``make_graph(kind, ...)``, every later round rewires the one before
    (``rewire`` at ``p_rewire``): a Markov chain of connected graphs of
    about constant average degree."""
    g = make_graph(kind, n, avg_degree, seed=seed)
    adjs = [g.adj]
    for t in range(1, rounds):
        g = rewire(g, p_rewire, seed=seed + 1000003 * t)
        adjs.append(g.adj)
    return GraphSchedule(np.stack(adjs).astype(np.float32))


def symmetric_mask_drop(adj, u, p_drop: float):
    """The one symmetric edge-drop rule of ``drop_edges`` (numpy) and of
    the runner's per-round draw (``experiments/scenarios.bernoulli_drop``,
    torch): ``u`` is an ``(N, N)`` symmetric matrix of per-edge uniforms,
    each off-diagonal link drops where ``u < p_drop``, and the diagonal is
    kept (a client always keeps its own model). numpy arrays give a numpy
    array, torch tensors a tensor on their device."""
    n = adj.shape[-1]
    if isinstance(adj, np.ndarray):
        keep = (u >= p_drop).astype(adj.dtype)
        eye, maximum = np.eye(n, dtype=adj.dtype), np.maximum
    else:
        import torch

        keep = (u >= p_drop).to(adj.dtype)
        eye = torch.eye(n, dtype=adj.dtype, device=adj.device)
        maximum = torch.maximum
    return adj * maximum(keep, eye)


def drop_edges(adj: np.ndarray, p_drop: float,
               rng: np.random.Generator) -> np.ndarray:
    """One round of Bernoulli link failures: each undirected off-diagonal
    edge drops with probability ``p_drop`` (one draw per edge: failures
    are symmetric), the diagonal kept. No connectivity repair: dropout
    models failures, not topology design."""
    adj = _augment(adj.copy())
    n = adj.shape[0]
    u = np.triu(rng.random((n, n)).astype(np.float32), k=1)
    u = u + u.T
    return symmetric_mask_drop(adj, u, p_drop)


def dropout_schedule(
    graph: Graph, rounds: int, p_drop: float, seed: int = 0,
) -> GraphSchedule:
    """Per-round Bernoulli edge-dropout masks over a static base graph; a
    dropped link carries no traffic and costs no bytes."""
    rng = np.random.default_rng(seed)
    adjs = np.stack([drop_edges(graph.adj, p_drop, rng)
                     for _ in range(rounds)])
    return GraphSchedule(adjs.astype(np.float32))
