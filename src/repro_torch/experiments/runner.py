"""Experiment driver: the loop engine behind ``run_method``.

``run_method`` resolves the method through the registry and owns the round
loop, the learning-rate schedule, the eval cadence, curve collection and
communication accounting. A round is one call of the method's step; every
``eval_every`` rounds (and after the last) the driver evaluates the
personalized models on the training data. The final result evaluates them
on the test split.

The run's generators: one seeded from ``seed`` initialises the state, and
a stream forked from it after the init feeds the rounds (FedSPD forks its
own into its state instead). Evaluation draws (pFedMe's personalization)
come from a copy of the run's stream, so evaluating does not change the
training trajectory.

Communication: a method's ``comm_model`` is either "tracked" (FedSPD's
data-dependent bytes, read from ``state.comm_bytes``) or "static"
(per-round bytes × rounds), as in the JAX package. These are logical
bytes (the models' own dtypes); ``RunResult.wire_bytes`` is the physical
count under the run's codec and sparse format, an exact static ratio of
the logical one.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.comm.codecs import make_channel, sparse_wire_model_bytes
from repro_torch.configs.paper_cnn import PaperExpConfig
from repro_torch.data.synthetic import ClientDataset
from repro_torch.device import (
    copy_generator,
    fork_generator,
    make_generator,
    resolve_device,
    synchronize,
)
from repro_torch.experiments.config import RunConfig
from repro_torch.experiments.registry import (
    ExperimentContext,
    Method,
    build_context,
    get_method,
)
from repro_torch.graphs.topology import Graph


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
                        # "state", "pack_spec" with options["keep_state"]


def _lr_schedule(exp: PaperExpConfig) -> np.ndarray:
    """The rounds' learning rates lr0 · decay^r, taken in Python floats and
    stored in fp32 (the JAX driver's tape)."""
    return np.asarray([exp.lr0 * (exp.lr_decay ** r) for r in range(exp.rounds)],
                      np.float32)


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


def _result(m: Method, ctx: ExperimentContext, state, aux, acc, curve,
            t0: float, round_ms: list) -> RunResult:
    comm_model = m.comm_model(ctx)
    if comm_model.kind == "tracked":
        comm = float(state.comm_bytes)
    else:
        comm = comm_model.per_round_bytes * ctx.exp.rounds
    extras = m.extras(ctx, state, aux)
    extras["round_ms"] = round_ms
    if ctx.opt("keep_state"):
        # serve export (experiments/export.py) lifts the cluster plane
        # from the final state through the run's own packing
        extras["state"] = state
        extras["pack_spec"] = ctx.pack_spec
    acc = acc.cpu().numpy()
    return RunResult(
        method=m.name, acc_per_client=acc, mean_acc=float(acc.mean()),
        std_acc=float(acc.std()), comm_bytes=comm,
        wire_bytes=_wire_bytes(ctx, comm),
        curve=curve, wall_s=time.time() - t0, extras=extras,
    )


def _drive(method: str, data: ClientDataset, exp: PaperExpConfig,
           graph: Graph | None, seed: int, cfg: RunConfig) -> RunResult:
    t0 = time.time()
    m = get_method(method)
    options = cfg.resolve_options()
    for feature in ("comm", "sparse"):
        if options.get(feature) is not None and feature not in m.features:
            raise ValueError(
                f"RunConfig.{feature} on {method!r} is not ported: the port "
                f"runs {feature} in FedSPD only (the baselines' compressed "
                "exchange comes later)")
    device = resolve_device(cfg.device)
    ctx = build_context(data, exp, device, graph=graph, seed=seed,
                        options=options)
    gen = make_generator(device, seed)
    state = m.init(ctx, gen)
    gen = fork_generator(gen)
    step = m.make_step(ctx)
    lrs = _lr_schedule(exp)
    curve, round_ms, aux = [], [], None
    for r in range(exp.rounds):
        synchronize(device)
        t = time.perf_counter()
        state, aux = step(state, ctx.train, gen, float(lrs[r]))
        synchronize(device)
        round_ms.append((time.perf_counter() - t) * 1e3)
        if r % cfg.eval_every == 0 or r == exp.rounds - 1:
            acc = m.evaluate(ctx, state, ctx.train, copy_generator(gen))
            curve.append((r, float(acc.mean())))
    acc = m.evaluate(ctx, state, ctx.test, copy_generator(gen))
    return _result(m, ctx, state, aux, acc, curve, t0, round_ms)


def run_method(method: str, data: ClientDataset, exp: PaperExpConfig,
               graph: Graph | None = None, seed: int = 0,
               cfg: RunConfig | None = None) -> RunResult:
    """Run one method for ``exp.rounds`` rounds on ``cfg.device`` (the card
    by default; raises ``RuntimeError`` without one unless
    ``cfg=RunConfig(device="cpu")``)."""
    return _drive(method, data, exp, graph, seed,
                  cfg if cfg is not None else RunConfig())
