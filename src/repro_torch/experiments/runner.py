"""Experiment driver: the round engines behind ``run_method`` and
``run_method_batch``.

The driver resolves the method through the registry and owns the rounds,
the learning-rate tape, the eval cadence, curve collection and
communication accounting. Every ``eval_every`` rounds (and after the last)
it evaluates the personalized models on the training data; the final
result evaluates them on the test split. Two engines run the same round:

- the loop (the default on the CPU, ``scan_rounds=False``): one call of
  the method's step per seed and round;
- the replay (the default on the card, ``scan_rounds=True``), the
  counterpart of the JAX package's ``lax.scan`` engine: one *capturable
  round*, a closure that reads every seed's state from static buffers,
  runs the method's unchanged step and writes each state tensor back
  into those buffers in place. Its learning
  rate comes from a device tape indexed by a device round counter that the
  round itself advances. On the card the round is captured once into a
  CUDA graph (after a warm-up on a throwaway copy of the state and
  generators) and replayed every round, with no host write between
  replays; on the CPU the same closure is called directly. A round whose
  method branches on the host (``Method.round_branch``: the sparse masks'
  update rounds) gets one graph per branch, picked by the host's round
  number. A failed capture raises, naming the method. A run on
  ``gossip_backend="ppermute"`` (send/recv between ranks) takes the loop
  on the card, and refuses ``scan_rounds=True`` there: capturing NCCL's
  send/recv in a CUDA graph waits for a multi-card run. The replayed run
  equals the loop bit for bit; ``extras`` reports ``n_captures`` (also as
  ``n_compiles``: the graphs captured, through
  ``telemetry.counters.compile_count``; 0 on the loop) and
  ``n_dispatches``.

Each round of either engine (the step, or the replay, and the wait for
the card) runs inside a ``torch.profiler.record_function`` span named
``ROUND_SPAN``: a profiler around ``run_method`` reads from it what each
round ran on the card. The kernels' launch counters tick in their
wrappers only, so a replayed run's counters hold what its warm-up and
capture launched, not its replays.

``RunConfig(cohort_size=K)`` samples K of N clients per round (both
engines): the step runs unchanged at size K on a compact gather of the
state, the data and the ``(K, K)`` adjacency minor, and the result is
scattered back in place, so inactive rows stay bit-untouched and dropped
clients cost no bytes. Cohorts come from a generator of their own, seeded
from the run's seed, drawn on the device.

``RunConfig(scenario=Scenario(...))`` (experiments/scenarios.py) runs
FedSPD on a topology that changes every round, on both engines. The
PRE-dropout adjacencies become a device tape ``(rounds, N, N)`` read at
the round (the replay reads it at its device round counter, as it reads
the lr tape): a graph schedule's, or the base graph's in every round for a
dropout- or heterogeneity-only scenario.
Link dropout draws ``(N, N)`` uniforms a round from a device generator of
its own (``bernoulli_drop``), and a ``ClientSystemModel`` draws its
timeouts and availability from another (``het_round``), whose staleness
carry the replay updates in place; ``masked_client_step`` keeps an
inactive client's rows bit-untouched and folds the activity weights into
the adjacency. The step's extras come in the JAX driver's order:
adjacency, cohort indices, activity weights. The streams are shared by
every seed of a batch, as in the JAX driver, and ``extras["staleness"]``
holds the final per-client staleness counters.

Both engines run either parameter representation: the packed plane, or
the per-leaf pytree engine (``RunConfig(param_plane=False)``), whose
states hold nested dicts of leaves; the replay's static buffers, its
throwaway copies and its write-back walk those leaves as they walk a
state's fields.

``RunConfig(telemetry=TelemetryConfig())`` computes the telemetry streams
(telemetry/metrics.py) inside the round, after the step: the collector is
built once a run from the method's first state (whether it carries ``u``,
centers with an ``(S, N)`` lead, masks, tracked bytes), the old ``u``,
``comm_bytes`` and masks are copied on the device before the step (which
updates some in place), and each stream is written into a device tape
``(rounds, ...)`` fp32 at the round: the host's ``r`` on the loop, the
device round counter on the replay, whose captured graph holds the
collector and the writes (no extra capture, no extra dispatch, no host
read). The adjacency it reads is the one the step mixed over: the
scenario's round after dropout, the per-seed or cohort graph, else the
paper graph, folded with the round's activity weights under a
``ClientSystemModel``, whose staleness carry after the round feeds the
histogram. The tapes reach the host once, after the last round, as
``RunResult.telemetry``; without a system model ``extras["staleness"]`` is
then the all-zero counters, as in the JAX package.

The run's generators: one seeded from ``seed`` initialises the state, and
a stream forked from it after the init feeds the rounds (FedSPD forks its
own into its state instead). Evaluation draws (pFedMe's personalization)
come from a copy of the run's stream, so evaluating does not change the
training trajectory. ``run_method_batch`` runs k seeds, each with its own
state and generators, so seed i's result equals ``run_method`` of that
seed (with the batch's graph and seed i's data); under ``scan_rounds`` one
graph holds every seed's round.

Communication: a method's ``comm_model`` is either "tracked" (FedSPD's
data-dependent bytes, read from ``state.comm_bytes``) or "static"
(per-round bytes × rounds), as in the JAX package. These are logical
bytes (the models' own dtypes); ``RunResult.wire_bytes`` is the physical
count under the run's codec and sparse format, an exact static ratio of
the logical one, for FedSPD and the baselines alike. A baseline's codec
draws its rounding noise from the run's stream (the step's ``gen``),
which the replay registers with its graph as it does FedSPD's own.
"""
from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace
from typing import Callable

import numpy as np
import torch

from repro_torch.comm.codecs import make_channel, sparse_wire_model_bytes
from repro_torch.configs.paper_cnn import PaperExpConfig
from repro_torch.data.synthetic import ClientDataset
from repro_torch.device import (
    capture,
    copy_generator,
    fork_generator,
    make_generator,
    resolve_device,
    synchronize,
    warm_up,
)
from repro_torch.experiments.config import RunConfig
from repro_torch.experiments.heterogeneity import (
    apply_client_weights,
    draw_het,
    het_round,
    masked_client_step,
)
from repro_torch.experiments.registry import (
    ExperimentContext,
    FedSPDMethod,
    Method,
    build_context,
    get_method,
)
from repro_torch.experiments.scenarios import Scenario, bernoulli_drop, draw_drop
from repro_torch.graphs.topology import Graph, make_graph, union_graph
from repro_torch.telemetry.config import TelemetryConfig
from repro_torch.telemetry.counters import compile_count
from repro_torch.telemetry.metrics import centers_lead, make_collector, stream_shapes

# the profiler span around each round (see the module docstring)
ROUND_SPAN = "repro_torch.round"


@dataclasses.dataclass
class RunResult:
    method: str
    acc_per_client: np.ndarray  # (N,)
    mean_acc: float
    std_acc: float
    comm_bytes: float   # logical bytes (original dtypes)
    wire_bytes: float   # physical bytes: equal to comm_bytes without a codec
    curve: list         # [(round, mean train acc)]
    wall_s: float
    extras: dict        # method diagnostics; "round_ms": per-round times;
                        # "n_captures" (= "n_compiles"), "n_dispatches";
                        # "state", "pack_spec" (None on the pytree engine)
                        # with options["keep_state"]; "staleness" under a
                        # ClientSystemModel or with telemetry
    telemetry: dict | None = None   # {"rounds": R, "streams": {name: (R, ...)
                                    # fp32}} with RunConfig.telemetry on


def _require_dynamic_graph(m: Method, what: str) -> None:
    if not m.supports_dynamic_graph:
        raise ValueError(
            f"method {m.name!r} does not support {what} — its step does "
            "not accept the per-round adjacency (set supports_dynamic_graph "
            "after threading adj through the step)")


def _wire_bytes(ctx: ExperimentContext, logical: float) -> float:
    """Physical bytes under the run's codec: every message is one model's
    plane slice, so the per-message ratio (``Channel.wire_model_bytes``
    over the logical model bytes) scales the logical count exactly. A
    sparse run (density < 1) ships the mask-then-encode format instead:
    nnz payload plus support bitmap (``sparse_wire_model_bytes``)."""
    cfg, sp = ctx.opt("comm"), ctx.opt("sparse")
    x, model_b = ctx.pack_spec.size, ctx.pack_spec.model_bytes
    if sp is not None and sp.enabled:
        per_msg = sparse_wire_model_bytes(cfg, x, sp.k_active(x))
        return logical * (per_msg / float(model_b))
    ch = make_channel(cfg, x)
    if ch is None:
        return logical
    return logical * ch.wire_ratio(model_b)


# --------------------------------------------------------------------------
# Cohort subsampling (RunConfig.cohort_size)
# --------------------------------------------------------------------------


def _stream_seed(seed: int, tag: int) -> int:
    """A stream's seed, derived from ``seed`` and apart from it and from
    the other streams' (the JAX driver folds a tag into a key: 0x5EED for
    the cohorts, 0x51AC for heterogeneity)."""
    return int(np.random.SeedSequence((int(seed), tag)).generate_state(
        1, np.uint64)[0])


def _cohort_indices(gen: torch.Generator, n: int, k: int) -> torch.Tensor:
    """This round's active cohort on ``gen``'s device: K of N clients
    without replacement (the first K of a random permutation, by sorted
    uniform keys), SORTED so that gather and scatter keep client order."""
    keys = torch.rand(n, generator=gen, device=gen.device)
    return torch.sort(torch.argsort(keys, stable=True)[:k]).values


def _cohort_step(step: Callable, axes) -> Callable:
    """Run a dynamic-graph step on a compact K-client cohort.

    ``axes`` maps each state field to its client axis (None = a global
    field threaded through whole). The wrapper gathers the active rows of
    the state, the training data and the adjacency minor, runs the
    UNCHANGED step at size K, and scatters the results back into the
    state's tensors in place; the step's comm accounting sees the ``(K,
    K)`` minor, so inactive clients cost zero bytes."""

    def take(v, ax, idx):
        return v if v is None or ax is None else v.index_select(ax, idx)

    def put(full, sub, ax, idx):
        if full is None or ax is None:
            return sub
        return full.index_copy_(ax, idx, sub)

    def stepc(state, train, gen, lr, adj, active):
        sub = type(state)(*(take(v, a, active) for v, a in zip(state, axes)))
        sub_train = {k: v.index_select(0, active) for k, v in train.items()}
        sub_adj = adj.index_select(0, active).index_select(1, active)
        sub, aux = step(sub, sub_train, gen, lr, sub_adj)
        new = type(state)(*(put(v, s, a, active)
                            for v, s, a in zip(state, sub, axes)))
        return new, aux

    return stepc


# --------------------------------------------------------------------------
# Telemetry (RunConfig.telemetry)
# --------------------------------------------------------------------------


class _Telemetry:
    """One seed's telemetry: the collector, built once a run from the
    method's first state as the JAX package builds it, the paper graph's
    adjacency (what a step without an adjacency extra mixes over) and the
    device tapes ``(rounds, ...)`` fp32 the rounds write their streams
    into."""

    def __init__(self, m: Method, ctx: ExperimentContext, state,
                 cfg: TelemetryConfig, rounds: int):
        s, n = ctx.n_clusters, ctx.n_clients
        comm = m.comm_model(ctx)
        self.tracked = comm.kind == "tracked" and hasattr(state, "comm_bytes")
        u = getattr(state, "u", None)
        self.has_u = isinstance(u, torch.Tensor) and tuple(u.shape[-2:]) == (n, s)
        self.has_mask = getattr(state, "mask", None) is not None
        has_plane = hasattr(state, "centers") and centers_lead(state.centers) == (s, n)
        self.collect = make_collector(
            cfg, n_clusters=s, n_clients=n, wire_ratio=_wire_bytes(ctx, 1.0),
            per_round_bytes=None if self.tracked else comm.per_round_bytes,
            has_u=self.has_u, has_plane=has_plane, has_mask=self.has_mask)
        self.adj = torch.as_tensor(ctx.graph.adj, dtype=torch.float32, device=ctx.device)
        self.rounds = rounds
        self.tapes = {name: torch.zeros((rounds, *tail), dtype=torch.float32,
                                        device=ctx.device)
                      for name, tail in stream_shapes(cfg, s).items()}

    def before(self, state) -> SimpleNamespace:
        """Device copies of what the streams read of the old state (the
        step updates the plane, and a cohort every client-axis field, in
        place)."""
        return SimpleNamespace(
            u=state.u.clone() if self.has_u else None,
            comm_bytes=state.comm_bytes.clone() if self.tracked else None,
            mask=state.mask.clone() if self.has_mask else None)

    def after(self, at, old, new, adj, weights, stale) -> None:
        """The round's streams, written into the tapes at ``at``: the host's
        round (the loop) or the device round counter (the replay)."""
        adj = self.adj if adj is None else adj
        if weights is not None:
            adj = apply_client_weights(adj, weights)
        streams = self.collect(old, new, adj, weights=weights, stale=stale)
        for name, v in streams.items():
            tape = self.tapes[name]
            if isinstance(at, torch.Tensor):
                tape.index_copy_(0, at, v.unsqueeze(0))
            else:
                tape[at].copy_(v)

    def result(self) -> dict:
        """The tapes on the host: one copy each, after the last round."""
        return {"rounds": self.rounds,
                "streams": {name: t.cpu().numpy() for name, t in self.tapes.items()}}


# --------------------------------------------------------------------------
# One seed's run, and what the captured round needs of a state
# --------------------------------------------------------------------------


class _Seed:
    """One seed's context, state, generators and round step. ``adj`` is
    the round's adjacency extra (a per-seed graph, or the graph a cohort
    takes its minor of) unless a scenario gives it, ``cohort`` K or None;
    with ``het`` the step runs under ``masked_client_step``; with
    ``telemetry`` (a TelemetryConfig) each round collects its streams."""

    def __init__(self, m: Method, ctx: ExperimentContext, seed: int,
                 adj: torch.Tensor | None, cohort: int | None, het: bool = False,
                 telemetry: TelemetryConfig | None = None):
        self.ctx, self.adj, self.cohort = ctx, adj, cohort
        gen = make_generator(ctx.device, seed)
        self.state = m.init(ctx, gen)
        self.gen = fork_generator(gen)
        self.step = m.make_step(ctx)
        self.cgen = None
        if cohort is not None:
            self.step = _cohort_step(self.step, m.cohort_axes(ctx, self.state))
            self.cgen = make_generator(ctx.device, _stream_seed(seed, 0x5EED))
        if het:
            # outside the cohort gather: the weights cover every client
            self.step = masked_client_step(self.step, m.cohort_axes(ctx, self.state))
        self.telemetry = (None if telemetry is None else
                          _Telemetry(m, ctx, self.state, telemetry, ctx.exp.rounds))
        self.aux, self.curve = None, []

    def round(self, state, gen, cgen, lr, scen=None, at=None):
        """One round of this seed's step from ``state`` with the given
        generators (the seed's own, or a warm-up's copies); ``scen`` is the
        scenario's (adjacency, activity weights, staleness counters; the
        last two None without a system model) for the round. With
        telemetry the round's streams go into the tapes at round ``at``."""
        adj = self.adj if scen is None else scen[0]
        aw, stale = (None, None) if scen is None else scen[1:]
        extras = () if adj is None else (adj,)
        if self.cohort is not None:
            extras += (_cohort_indices(cgen, self.ctx.n_clients, self.cohort),)
        if aw is not None:
            extras += (aw,)
        tel = self.telemetry
        old = None if tel is None else tel.before(state)
        new, aux = self.step(state, self.ctx.train, gen, lr, *extras)
        if tel is not None:
            tel.after(at, old, new, adj, aw, stale)
        return new, aux


class _ScenarioRun:
    """A run's scenario on its device, shared by every seed: the round's
    adjacency (read from the tape at the round), the dropout stream, the
    heterogeneity stream and its carry. The
    generators and the carry are the mutable part (``bufs``): a warm-up
    runs on copies of them, the replay on the buffers it was captured
    over."""

    def __init__(self, scenario: Scenario, tape: np.ndarray, device: torch.device):
        self.n, self.p = tape.shape[1], float(scenario.dropout)
        self.tape = torch.as_tensor(tape, device=device)
        self.het = scenario.system
        dgen = hgen = carry = None
        if self.p > 0.0:
            dgen = make_generator(device, _stream_seed(scenario.seed, 0xD809))
        if self.het is not None:
            self.speeds = torch.as_tensor(self.het.resolve_speeds(self.n), device=device)
            hgen = make_generator(device, _stream_seed(self.het.seed, 0x51AC))
            carry = self.het.init_carry(self.n, device)
        self.bufs = (dgen, hgen, carry)

    def gens(self) -> list:
        return [g for g in self.bufs[:2] if g is not None]

    def copies(self) -> tuple:
        """Throwaway copies of the generators and the carry."""
        dgen, hgen, carry = self.bufs
        return (None if dgen is None else copy_generator(dgen),
                None if hgen is None else copy_generator(hgen),
                None if carry is None else type(carry)(*(t.clone() for t in carry)))

    def round(self, r, bufs) -> tuple:
        """Round ``r``'s (adjacency, activity weights, staleness counters),
        drawn from ``bufs`` (the last two None without a system model); the
        carry is updated in place. ``r`` is the host's round (the loop) or
        the device round counter (the replay)."""
        dgen, hgen, carry = bufs
        if isinstance(r, torch.Tensor):
            adj = self.tape.index_select(0, r).reshape(self.n, self.n)
        else:
            adj = self.tape[r]
        if self.p > 0.0:
            adj = bernoulli_drop(adj, draw_drop(dgen, self.n), self.p)
        if self.het is None:
            return adj, None, None
        new, aw = het_round(self.het, self.speeds, carry, *draw_het(hgen, self.n))
        carry.stale.copy_(new.stale)
        carry.avail.copy_(new.avail)
        return adj, aw, carry.stale


def _fields(state) -> tuple:
    """A state's top-level parts: a bare tensor or a tree (the pytree
    engine's baseline states) is one part, a NamedTuple its fields."""
    return (state,) if isinstance(state, (torch.Tensor, dict)) else tuple(state)


def _at_round(state, r: int):
    """``state`` with its host round counter at ``r`` (states without one
    as they are)."""
    if hasattr(state, "_fields") and "round" in state._fields:
        return state._replace(round=r)
    return state


def _copy_state(state):
    """A throwaway copy: tensors cloned, generators copied, through the
    fields of a NamedTuple and the leaves of a tree."""
    if isinstance(state, torch.Tensor):
        return state.clone()
    if isinstance(state, torch.Generator):
        return copy_generator(state)
    if isinstance(state, dict):
        return {k: _copy_state(v) for k, v in state.items()}
    if isinstance(state, tuple):
        return type(state)(*map(_copy_state, state))
    return state


def _write_back(buf, new) -> None:
    """Copy every tensor of the step's new state into the static buffer
    it replaces, through the fields of a NamedTuple and the leaves of a
    tree (a tensor the step updated in place is the buffer)."""
    if isinstance(buf, torch.Tensor):
        if new is not buf:
            buf.copy_(new)
    elif isinstance(buf, dict):
        for k, b in buf.items():
            _write_back(b, new[k])
    elif isinstance(buf, tuple):
        for b, v in zip(buf, new):
            _write_back(b, v)


class _CapturedRound:
    """One round of every seed over static buffers: the seeds' own states
    and generators, the lr tape and the round counter. On the card it is
    captured once into a CUDA graph and ``__call__`` replays it; on the
    CPU ``__call__`` runs the closure."""

    def __init__(self, method: str, seeds: list, tape: torch.Tensor,
                 ctr: torch.Tensor, r: int, device: torch.device,
                 scenario: _ScenarioRun | None = None):
        def body(bufs, sbufs, ctr):
            lr = tape.index_select(0, ctr).reshape(())
            scen = None if scenario is None else scenario.round(ctr, sbufs)
            auxs = []
            for sd, (state, gen, cgen) in zip(seeds, bufs):
                new, aux = sd.round(_at_round(state, r), gen, cgen, lr, scen, at=ctr)
                _write_back(state, new)
                auxs.append(aux)
            ctr.add_(1)
            return auxs

        real = [(sd.state, sd.gen, sd.cgen) for sd in seeds]
        sreal = None if scenario is None else scenario.bufs
        self.graph, self.aux = None, None
        if device.type != "cuda":
            self._run = lambda: body(real, sreal, ctr)
            return
        copies = [(_copy_state(st), copy_generator(g),
                   None if cg is None else copy_generator(cg)) for st, g, cg in real]
        scopies = None if scenario is None else scenario.copies()
        gens = [g for st, gen, cg in real
                for g in (gen, cg, *_fields(st)) if isinstance(g, torch.Generator)]
        gens += [] if scenario is None else scenario.gens()
        out = []
        try:
            warm_up(lambda: body(copies, scopies, ctr.clone()), device)
            del copies, scopies
            self.graph = capture(lambda: out.append(body(real, sreal, ctr)), gens)
        except Exception as e:
            raise RuntimeError(
                f"scan_rounds: {method!r}'s round (round {r}) could not be "
                f"captured into a CUDA graph: {e} — RunConfig(scan_rounds="
                "False) runs the loop engine") from e
        self.aux = out[0]

    def __call__(self) -> list:
        """One round; returns each seed's aux (on the card the graph's
        outputs, overwritten by its next replay)."""
        if self.graph is None:
            return self._run()
        self.graph.replay()
        return self.aux


def _detached(aux):
    """A graph output's copy that outlives the graph and its pool."""
    if isinstance(aux, dict):
        return {k: _detached(v) for k, v in aux.items()}
    return aux.clone() if isinstance(aux, torch.Tensor) else aux


# --------------------------------------------------------------------------
# The engines
# --------------------------------------------------------------------------


def _after_round(m: Method, seeds: list, r: int, rounds: int, cfg: RunConfig) -> None:
    """The caller's ``on_round`` hook, then the train-curve evaluation at
    the ``eval_every`` cadence (and after the last round)."""
    if cfg.on_round is not None:
        cfg.on_round(r)
    if r % cfg.eval_every == 0 or r == rounds - 1:
        for sd in seeds:
            acc = m.evaluate(sd.ctx, sd.state, sd.ctx.train, copy_generator(sd.gen))
            sd.curve.append((r, float(acc.mean())))


def _timed(device: torch.device, fn: Callable) -> float:
    """``fn`` and the wait for the card, in ms, inside a ``ROUND_SPAN``."""
    synchronize(device)
    with torch.profiler.record_function(ROUND_SPAN):
        t = time.perf_counter()
        fn()
        synchronize(device)
        return (time.perf_counter() - t) * 1e3


def _loop(m: Method, seeds: list, lrs: torch.Tensor, rounds: int,
          cfg: RunConfig, device: torch.device,
          scenario: _ScenarioRun | None = None) -> dict:
    def one_round(r):
        scen = None if scenario is None else scenario.round(r, scenario.bufs)
        for sd in seeds:
            sd.state, sd.aux = sd.round(sd.state, sd.gen, sd.cgen, lrs[r], scen, at=r)

    round_ms = []
    for r in range(rounds):
        round_ms.append(_timed(device, lambda: one_round(r)))
        _after_round(m, seeds, r, rounds, cfg)
    return {"round_ms": round_ms, "n_captures": 0, "n_compiles": 0,
            "n_dispatches": rounds * len(seeds)}


def _replay(m: Method, seeds: list, lrs: torch.Tensor, rounds: int,
            cfg: RunConfig, device: torch.device,
            scenario: _ScenarioRun | None = None) -> dict:
    ctr = torch.zeros(1, dtype=torch.int64, device=device)
    by_branch, round_ms, capture_ms, auxs = {}, [], [], None
    for r in range(rounds):
        branch = m.round_branch(seeds[0].ctx, r)
        if branch not in by_branch:
            t = time.perf_counter()
            by_branch[branch] = _CapturedRound(m.name, seeds, lrs, ctr, r, device,
                                               scenario)
            capture_ms.append((time.perf_counter() - t) * 1e3)
        run = by_branch[branch]
        out = []
        round_ms.append(_timed(device, lambda: out.append(run())))
        auxs = out[0]
        for sd in seeds:
            sd.state = _at_round(sd.state, r + 1)
        _after_round(m, seeds, r, rounds, cfg)
    for sd, aux in zip(seeds, auxs or [None] * len(seeds)):
        sd.aux = _detached(aux)
    n = compile_count(by_branch)
    return {"round_ms": round_ms, "capture_ms": capture_ms,
            "n_captures": n, "n_compiles": n, "n_dispatches": rounds}


# --------------------------------------------------------------------------
# The shared driver
# --------------------------------------------------------------------------


def _result(m: Method, sd: _Seed, acc: torch.Tensor, t0: float,
            engine: dict) -> RunResult:
    ctx, state = sd.ctx, sd.state
    comm_model = m.comm_model(ctx)
    if comm_model.kind == "tracked":
        comm = float(state.comm_bytes)
    else:
        comm = comm_model.per_round_bytes * ctx.exp.rounds
    extras = m.extras(ctx, state, sd.aux)
    extras.update(engine)
    if ctx.opt("keep_state"):
        # serve export (experiments/export.py) lifts the cluster plane
        # from the final state through the run's own packing
        extras["state"] = state
        extras["pack_spec"] = m.plane_spec(ctx)   # None on the pytree engine
    acc = acc.cpu().numpy()
    return RunResult(
        method=m.name, acc_per_client=acc, mean_acc=float(acc.mean()),
        std_acc=float(acc.std()), comm_bytes=comm,
        wire_bytes=_wire_bytes(ctx, comm),
        curve=sd.curve, wall_s=time.time() - t0, extras=extras,
        telemetry=None if sd.telemetry is None else sd.telemetry.result(),
    )


def _stack_data(data, seeds: tuple, entry: str) -> list:
    """One dataset per seed: a single ClientDataset is shared; a sequence
    gives seed i its own (the paper's per-seed-dataset protocol), all of
    one shape."""
    if isinstance(data, ClientDataset):
        return [data] * len(seeds)
    datasets = list(data)
    if len(datasets) != len(seeds):
        raise ValueError(
            f"{entry}: stacked data: got {len(datasets)} datasets for "
            f"{len(seeds)} seeds {tuple(seeds)}")
    for i, d in enumerate(datasets[1:], start=1):
        if (d.x.shape != datasets[0].x.shape
                or d.n_classes != datasets[0].n_classes
                or d.n_clusters != datasets[0].n_clusters):
            raise ValueError(
                f"{entry}: stacked datasets must share shapes/classes/"
                f"clusters (one round runs every seed) — the dataset at "
                f"seed index {i} (seed {seeds[i]}) differs from seed index 0")
    return datasets


def _stack_graphs(m: Method, graph, seeds: tuple, entry: str):
    """Per-seed graphs (a sequence in ``graph``): ``(k, N, N)`` adjacencies
    that ride the step's ``adj``, and the union graph for the context."""
    if graph is None or isinstance(graph, Graph):
        return None, graph
    graphs = list(graph)
    if len(graphs) != len(seeds):
        raise ValueError(
            f"{entry}: per-seed graphs: got {len(graphs)} graphs for "
            f"{len(seeds)} seeds {tuple(seeds)}")
    _require_dynamic_graph(m, "per-seed graphs")
    adj = np.stack([g.adj for g in graphs]).astype(np.float32)
    return adj, union_graph(adj)


def _resolve_scenario(m: Method, scenario: Scenario | None, graph, exp: PaperExpConfig,
                      data: ClientDataset, seed: int, adj_seeds):
    """(the PRE-dropout ``(rounds, N, N)`` tape or None, the context's graph).

    A schedule resolves to its stack; a dropout- or heterogeneity-only
    scenario to the base graph (the given one, else the one the context
    would build) in every round. The context takes the union graph. A
    static scenario is none."""
    if scenario is None or not scenario.dynamic:
        return None, graph
    if adj_seeds is not None:
        raise ValueError(
            "per-seed graphs and a dynamic scenario schedule are mutually "
            "exclusive (one adjacency per step)")
    _require_dynamic_graph(m, "dynamic-topology scenarios")
    if graph is None and scenario.graph_schedule is None:
        graph = make_graph(exp.graph_kind, data.n_clients, exp.avg_degree, seed=seed)
    stack, union = scenario.resolve(graph, exp.rounds)
    if stack.shape[1] != data.n_clients:
        raise ValueError(
            f"graph_schedule has {stack.shape[1]} clients, the data {data.n_clients}")
    return stack, union


def _drive(entry: str, method: str, data, exp: PaperExpConfig, graph,
           seeds: tuple, cfg: RunConfig) -> list:
    t0 = time.time()
    m = get_method(method)
    options = cfg.resolve_options()
    if options.get("comm") is not None and "comm" not in m.features:
        raise ValueError(f"RunConfig.comm on {method!r}: the method takes no wire codec")
    if options.get("sparse") is not None and "sparse" not in m.features:
        # the JAX baselines would ignore the masks and still charge sparse
        # wire bytes: the port refuses instead
        raise ValueError(
            f"RunConfig.sparse on {method!r}: the port runs sparse masks in "
            "FedSPD only (a JAX baseline ignores them but charges their wire "
            "bytes)")
    ppermute = options["gossip_backend"] == "ppermute"
    if ppermute and not isinstance(m, FedSPDMethod):
        raise ValueError(
            "unknown baseline gossip backend 'ppermute'; expected one of "
            "('reference', 'cuda')")
    device = resolve_device(cfg.device)
    if ppermute and cfg.scan_rounds and device.type == "cuda":
        raise ValueError(
            "scan_rounds=True with gossip_backend='ppermute' on CUDA: capturing "
            "NCCL send/recv in a CUDA graph waits for a multi-card run; leave "
            "scan_rounds unset (the loop)")
    scenario = cfg.scenario
    if (entry == "run_method_batch" and scenario is not None and scenario.data_stack
            and isinstance(data, ClientDataset)):
        raise ValueError(
            f"{entry}: scenario.data_stack=True needs a per-seed sequence of "
            "datasets in `data`")
    datasets = _stack_data(data, seeds, entry)
    adjs, graph = _stack_graphs(m, graph, seeds, entry)
    tape, graph = _resolve_scenario(m, scenario, graph, exp, datasets[0], seeds[0], adjs)
    # one graph for every seed: the given one, else the first seed's
    ctx0 = build_context(datasets[0], exp, device, graph=graph, seed=seeds[0],
                         options=options)
    ctxs = [ctx0] + [build_context(d, exp, device, graph=ctx0.graph, seed=s,
                                   options=options)
                     for d, s in zip(datasets[1:], seeds[1:])]
    cohort = cfg.cohort_size
    if cohort is not None:
        cohort = int(cohort)
        if not 0 < cohort <= ctx0.n_clients:
            raise ValueError(
                f"{entry}: cohort_size={cohort} must be in 1..N={ctx0.n_clients}")
        if adjs is None and tape is None:
            adjs = np.stack([ctx0.graph.adj] * len(seeds)).astype(np.float32)
    scen = None if tape is None else _ScenarioRun(scenario, tape, device)
    het = scen is not None and scen.het is not None
    telem = cfg.telemetry if cfg.telemetry is not None and cfg.telemetry.enabled else None
    runs = [_Seed(m, ctx, s, None if adjs is None else
                  torch.as_tensor(a, dtype=torch.float32, device=device), cohort, het,
                  telem)
            for ctx, s, a in zip(ctxs, seeds, adjs if adjs is not None
                                 else [None] * len(seeds))]
    lrs = torch.as_tensor(m.lr_schedule(ctx0), device=device)
    replay = (cfg.scan_rounds if cfg.scan_rounds is not None
              else device.type == "cuda" and not ppermute)
    engine = _replay if replay else _loop
    stats = engine(m, runs, lrs, exp.rounds, cfg, device, scen)
    if het:
        # shared by every seed, as the streams are
        stats["staleness"] = scen.bufs[2].stale.cpu().numpy()
    elif telem is not None:
        # with telemetry, a run without a system model reports its all-zero
        # counters rather than no key, as the JAX package does
        stats["staleness"] = np.zeros((ctx0.n_clients,), np.int32)
    results = []
    for sd in runs:
        acc = m.evaluate(sd.ctx, sd.state, sd.ctx.test, copy_generator(sd.gen))
        results.append(_result(m, sd, acc, t0, dict(stats)))
    return results


def run_method(method: str, data: ClientDataset, exp: PaperExpConfig,
               graph: Graph | None = None, seed: int = 0,
               cfg: RunConfig | None = None) -> RunResult:
    """Run one method for ``exp.rounds`` rounds on ``cfg.device`` (the card
    by default; raises ``RuntimeError`` without one unless
    ``cfg=RunConfig(device="cpu")``). On the card it replays one captured
    round (``cfg.scan_rounds=False`` runs the loop); ``cfg.cohort_size``
    samples K clients a round; ``cfg.scenario`` varies the topology."""
    return _drive("run_method", method, data, exp, graph, (int(seed),),
                  cfg if cfg is not None else RunConfig())[0]


def run_method_batch(method: str, data, exp: PaperExpConfig,
                     seeds=(0, 1, 2), graph=None,
                     cfg: RunConfig | None = None) -> list[RunResult]:
    """Run k seeds, each with its own state and generators; returns one
    RunResult per seed. Seed i's result equals ``run_method(seed=seeds[i])``
    with the batch's graph and seed i's data, bit for bit, on either
    engine; replayed, one graph holds every seed's round.

    - shared data and graph (the default): one graph, the first seed's
      (as the JAX driver builds it), unless ``graph`` is given;
    - stacked data: ``data`` as a sequence of per-seed ClientDatasets of
      one shape (the paper's Tables 2–3 protocol);
    - per-seed graphs: ``graph`` as a sequence (methods with
      ``supports_dynamic_graph``): seed i's adjacency rides its step's
      ``adj``, and the context takes the union graph;
    - a dynamic ``cfg.scenario``: its dropout and heterogeneity streams
      are shared by every seed (one draw a round, as in the JAX driver),
      so each seed still equals its single run; it excludes per-seed
      graphs, and ``scenario.data_stack`` requires stacked data."""
    return _drive("run_method_batch", method, data, exp, graph,
                  tuple(int(s) for s in seeds),
                  cfg if cfg is not None else RunConfig())
