"""Greedy edge colouring of a client graph: the ``permute`` gossip schedule.

A proper edge colouring partitions the graph's edges into matchings; each
matching is a partner swap, a (partial) permutation of the clients. The
``permute`` wiring (core/gossip.mix_permute) accumulates one gather per
colour class, which reproduces the dense Eq. (1) average exactly, since
every neighbour appears in exactly one matching. By Vizing's theorem a
simple graph needs at most Δ+1 colours.

A numpy copy of the JAX package's module: the same graph gives the same
colour classes and permutations, bit for bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.topology import Graph


def greedy_edge_coloring(graph: Graph) -> list[list[tuple[int, int]]]:
    """Partition the edges into matchings (colour classes), largest first.

    Edges are taken in descending (deg_i + deg_j) order (a stable sort, so
    ties keep ``Graph.edges`` order), each into the first class where
    neither endpoint is used yet."""
    deg = graph.degrees
    edges = sorted(graph.edges(), key=lambda e: -(deg[e[0]] + deg[e[1]]))
    classes: list[list[tuple[int, int]]] = []
    used: list[set[int]] = []
    for (i, j) in edges:
        for cls, busy in zip(classes, used):
            if i not in busy and j not in busy:
                cls.append((i, j))
                busy.update((i, j))
                break
        else:
            classes.append([(i, j)])
            used.append({i, j})
    return classes


def matching_to_permutation(matching: list[tuple[int, int]], n: int) -> np.ndarray:
    """A matching as a self-inverse permutation: perm[i] = partner or i."""
    perm = np.arange(n)
    for (i, j) in matching:
        perm[i], perm[j] = j, i
    return perm


def permute_schedule(graph: Graph) -> list[np.ndarray]:
    """The gossip schedule: one permutation per colour class."""
    return [matching_to_permutation(m, graph.n) for m in greedy_edge_coloring(graph)]


def schedule_stats(graph: Graph) -> dict:
    classes = greedy_edge_coloring(graph)
    return {
        "n_colors": len(classes),
        "n_edges": len(graph.edges()),
        "max_degree": int(graph.degrees.max()),
        "bytes_ratio_vs_allgather": len(classes) / max(graph.n - 1, 1),
    }


def validate_coloring(graph: Graph) -> bool:
    """Every edge appears exactly once, and every class is a matching."""
    seen = set()
    for cls in greedy_edge_coloring(graph):
        endpoints: set[int] = set()
        for (i, j) in cls:
            e = (min(i, j), max(i, j))
            if e in seen or i in endpoints or j in endpoints:
                return False
            seen.add(e)
            endpoints.update((i, j))
    return seen == {(min(i, j), max(i, j)) for (i, j) in graph.edges()}
