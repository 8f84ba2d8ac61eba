"""Scenario engine: dynamic topologies, link dropout and client-system
heterogeneity as input to the runner.

The paper's headline claim is accuracy in low-connectivity networks; its
Appendix B.2.4 tests it on dynamically rewired topologies. A ``Scenario``
bundles those axes into one object that ``experiments/runner.py`` resolves
into per-round inputs of the round step:

- ``graph_schedule``: a per-round topology sequence
  (``graphs/topology.GraphSchedule``, e.g. ``rewire_schedule(...)``) or a
  raw ``(rounds, N, N)`` stack. The runner puts it on the device as a tape
  and reads round r's slice at the round counter, so a replayed round
  needs no host write between replays.
- ``dropout``: per-round Bernoulli link failures on top of the schedule
  (or the static graph). ``bernoulli_drop`` takes the round's ``(N, N)``
  uniforms, which ``draw_drop`` makes on a device generator seeded from
  ``seed``; a dropped link costs no bytes.
- ``data_stack``: marks a ``run_method_batch`` call whose ``data`` is a
  per-seed sequence of datasets.
- ``system``: a ``heterogeneity.ClientSystemModel`` (stragglers,
  availability, stale-gossip decay), with a stream of its own.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.graphs.topology import (
    Graph,
    GraphSchedule,
    stack_schedule,
    symmetric_mask_drop,
    union_graph,
)


def draw_drop(gen: torch.Generator, n: int) -> torch.Tensor:
    """One round's ``(N, N)`` uniforms in [0, 1) on ``gen``'s device, the
    input of ``bernoulli_drop`` (which reads the upper triangle only)."""
    return torch.rand((n, n), generator=gen, device=gen.device)


def bernoulli_drop(adj: torch.Tensor, u: torch.Tensor, p: float) -> torch.Tensor:
    """One round of Bernoulli link failures: the strict upper triangle of
    ``u`` mirrored (one draw per undirected edge: failures are symmetric),
    then ``topology.symmetric_mask_drop``, the rule ``drop_edges`` shares.
    Each off-diagonal link drops with probability ``p``; the diagonal is
    kept."""
    u = torch.triu(u, diagonal=1)
    return symmetric_mask_drop(adj, u + u.T, p)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A declarative experiment scenario; see the module docstring.

    ``seed`` drives the dropout stream (the schedule carries its own seed,
    ``system`` its own). ``schedule_stack`` and ``resolve`` turn it into
    the runner's inputs: a PRE-dropout ``(rounds, N, N)`` stack and the
    union graph.
    """

    graph_schedule: Any = None   # GraphSchedule | (rounds, N, N) ndarray
    dropout: float = 0.0         # per-round Bernoulli edge-drop probability
    data_stack: bool = False     # run_method_batch data is per-seed stacked
    seed: int = 0                # dropout stream
    system: Any = None           # heterogeneity.ClientSystemModel

    def __post_init__(self):
        if not 0.0 <= float(self.dropout) <= 1.0:
            raise ValueError(f"Scenario.dropout={self.dropout!r} must be in [0, 1]")

    @property
    def dynamic(self) -> bool:
        """Whether the scenario varies the effective topology (and so needs
        a step that takes the round's adjacency)."""
        return (self.graph_schedule is not None or self.dropout > 0.0
                or self.system is not None)

    def schedule_stack(self, rounds: int) -> np.ndarray | None:
        """The ``(rounds, N, N)`` PRE-dropout schedule (None without one);
        a shorter schedule cycles, a longer one is cropped."""
        if self.graph_schedule is None:
            return None
        adjs = (self.graph_schedule.adjs
                if isinstance(self.graph_schedule, GraphSchedule)
                else np.asarray(self.graph_schedule, dtype=np.float32))
        return stack_schedule(adjs, rounds)

    def resolve(self, graph: Graph | None, rounds: int) -> tuple[np.ndarray, Graph]:
        """The ``(rounds, N, N)`` PRE-dropout stack and its union graph.
        ``graph`` is the static base topology, needed without a schedule
        (a dropout- or heterogeneity-only scenario masks it every round).
        Dropout is drawn per round, not here."""
        if not self.dynamic:
            raise ValueError("static scenario: nothing to resolve")
        stack = self.schedule_stack(rounds)
        if stack is None:
            if graph is None:
                raise ValueError(
                    "a dropout- or heterogeneity-only scenario needs the base graph")
            stack = np.broadcast_to(graph.adj, (rounds,) + graph.adj.shape).astype(np.float32)
        return np.ascontiguousarray(stack, dtype=np.float32), union_graph(stack)
