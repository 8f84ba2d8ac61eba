"""Method registry: FL algorithms behind one contract.

The driver (experiments/runner.py) knows nothing about individual
algorithms; each registers a ``Method`` adapter here:

    init(ctx, gen)                 -> state
    make_step(ctx)                 -> step(state, train, gen, lr, *extras)
                                      -> (state, aux)
    personalize(ctx, state, gen)   -> params, leaves (N, ...)
    comm_model(ctx)                -> CommModel: static per-round bytes, or
                                      "tracked" (read from state.comm_bytes)
    evaluate(ctx, state, on, gen)  -> (N,) per-client accuracy
    extras(ctx, state, aux)        -> dict of host-side diagnostics

``gen`` is a ``torch.Generator`` on the run's device and ``lr`` the
round's fp32 learning rate (a 0-d tensor on the device, read from the
tape ``lr_schedule`` gives), both owned by the driver (FedSPD draws from
the stream in its state). A method with ``supports_dynamic_graph`` takes
the round's ``(N, N)`` adjacency as the first extra (per-seed graphs, a
cohort's minor, a scenario's round); ``cohort_axes`` maps its state's fields to their client
axis for cohort subsampling; ``round_branch(ctx, r)`` names the host-side
branch round r takes (a captured round needs one graph per branch).

The port has every id of the JAX registry: FedSPD (``"fedspd"``, paper
Algorithm 1, with a wire codec, DisPFL sparse masks and cosine alignment
as options), ``"fedspd_permute"`` (the same on the edge-coloured permute
wiring) and the paper's six baselines (``"local"``, and ``dfl_``/``cfl_``
× ``fedavg``, ``fedem``, ``ifca``, ``fedsoft``, ``pfedme``). Every
baseline takes ``comm`` (a wire codec on its exchange; ``local``
exchanges nothing, so it only accepts one, as in JAX); a baseline given
``sparse`` raises ``ValueError``.

Every id runs on both parameter representations (``Method.plane_spec``):
the packed plane (the port's default, ``options["param_plane"]`` unset
or True) or the per-leaf pytree engine (``param_plane=False``, the JAX
package's default), where states hold nested dicts of leaves and no
codec, sparse mask or cohort runs, as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Hashable

import numpy as np
import torch

from repro_torch.baselines import fedavg, fedem, fedsoft, ifca, local, pfedme
from repro_torch.baselines.common import init_planes, mixing_matrix, per_client_eval
from repro_torch.comm.codecs import Channel, join_ef, make_channel
from repro_torch.configs.paper_cnn import PaperExpConfig
from repro_torch.core.fedspd import (
    FedSPDConfig,
    FedSPDState,
    final_phase,
    make_round_step,
    round_lr,
    seeded_init,
)
from repro_torch.core.gossip import GossipSpec, make_mix_fn
from repro_torch.core.packing import PackSpec, make_pack_spec
from repro_torch.core.sparse import SparseConfig, init_masks
from repro_torch.device import make_generator
from repro_torch.graphs.topology import Graph, complete, make_graph
from repro_torch.models.smallnets import make_classifier


@dataclasses.dataclass(frozen=True)
class ExperimentContext:
    """Everything a Method needs to build its state and step function."""

    exp: PaperExpConfig
    graph: Graph
    n_clients: int
    n_clusters: int
    model_init: Callable[[torch.Generator], dict]
    apply_fn: Callable
    loss_fn: Callable
    pel_fn: Callable        # per-example loss (clustering / EM steps)
    acc_fn: Callable
    pack_spec: PackSpec     # the model's layout; .model_bytes for comm
    train: dict             # {"inputs": (N, M, d), "targets": (N, M)}
    test: dict
    device: torch.device
    options: dict = dataclasses.field(default_factory=dict)

    def opt(self, name: str, default=None):
        return self.options.get(name, default)


def build_context(data, exp: PaperExpConfig, device: torch.device,
                  graph: Graph | None = None, seed: int = 0,
                  options: dict | None = None) -> ExperimentContext:
    """The shared experiment context from a ClientDataset, on ``device``."""
    if graph is None:
        graph = make_graph(exp.graph_kind, data.n_clients, exp.avg_degree,
                           seed=seed)
    dim, n_classes = data.x.shape[-1], data.n_classes
    params0, apply_fn, loss_fn, pel_fn, acc_fn = make_classifier(
        exp.model, make_generator(device, seed), dim, n_classes)

    def model_init(gen):
        return make_classifier(exp.model, gen, dim, n_classes)[0]

    spec = make_pack_spec(params0)

    def on_device(x, y):
        return {"inputs": torch.as_tensor(x, dtype=torch.float32, device=device),
                "targets": torch.as_tensor(y, dtype=torch.int64, device=device)}

    return ExperimentContext(
        exp=exp, graph=graph, n_clients=data.n_clients,
        n_clusters=data.n_clusters, model_init=model_init, apply_fn=apply_fn,
        loss_fn=loss_fn, pel_fn=pel_fn, acc_fn=acc_fn, pack_spec=spec,
        train=on_device(data.x, data.y),
        test=on_device(data.x_test, data.y_test), device=device,
        options=dict(options or {}),
    )


@dataclasses.dataclass(frozen=True)
class CommModel:
    """How the driver accounts bytes: a static per-round cost, or "tracked"
    (FedSPD's data-dependent point-to-point cost accumulated in state)."""

    kind: str               # "static" | "tracked"
    per_round_bytes: float = 0.0


def edges_bytes(graph: Graph, model_b: int, models: int = 1) -> float:
    """Multicast DFL round cost: each client sends ``models`` models per
    directed neighbor link (the adjacency carries self loops)."""
    directed_links = float(graph.adj.sum() - graph.n)
    return directed_links * model_b * models


def star_bytes(n: int, model_b: int, models: int = 1) -> float:
    """Centralized round cost: every client uploads + downloads per model."""
    return 2.0 * n * model_b * models


class Method:
    """Base adapter; subclasses implement init/make_step/personalize/
    comm_model; evaluate and extras have defaults. ``features`` names the
    ``RunConfig`` options the method takes beyond the common ones."""

    name: str = ""
    centralized: bool = False
    features: tuple = ()
    supports_dynamic_graph: bool = False

    def init(self, ctx: ExperimentContext, gen: torch.Generator):
        raise NotImplementedError

    def make_step(self, ctx: ExperimentContext) -> Callable:
        raise NotImplementedError

    def personalize(self, ctx: ExperimentContext, state,
                    gen: torch.Generator | None = None) -> dict:
        raise NotImplementedError

    def comm_model(self, ctx: ExperimentContext) -> CommModel:
        raise NotImplementedError

    def evaluate(self, ctx: ExperimentContext, state, on: dict,
                 gen: torch.Generator | None = None) -> torch.Tensor:
        """Per-client accuracy of the personalized models on ``on``."""
        params = self.personalize(ctx, state, gen)
        with torch.no_grad():
            return per_client_eval(ctx.acc_fn, params, on)

    def extras(self, ctx: ExperimentContext, state, aux: dict) -> dict:
        return {}

    def lr_schedule(self, ctx: ExperimentContext) -> np.ndarray:
        """The rounds' learning rates ``(rounds,)`` fp32: lr0 · decay^r,
        taken in Python floats and stored in fp32 (the JAX driver's
        tape)."""
        exp = ctx.exp
        return np.asarray([exp.lr0 * (exp.lr_decay ** r) for r in range(exp.rounds)],
                          np.float32)

    def round_branch(self, ctx: ExperimentContext, r: int) -> Hashable:
        """The branch round ``r`` takes on the host: rounds of one branch
        run the same ops (one captured graph each)."""
        return None

    def cohort_axes(self, ctx: ExperimentContext, state):
        """Per-field client-axis map for cohort subsampling
        (``RunConfig.cohort_size``): a state-shaped container giving, for
        each field, the axis that indexes clients (None = a global field
        threaded through whole). Methods opt in by overriding."""
        raise ValueError(
            f"method {self.name!r} does not support cohort subsampling "
            "(RunConfig.cohort_size) — its adapter defines no per-field "
            "client-axis map; override Method.cohort_axes")

    def plane_spec(self, ctx: ExperimentContext) -> PackSpec | None:
        """The run's PackSpec on the packed plane (``param_plane`` True or
        unset: the port's default), None on the pytree engine
        (``param_plane=False``)."""
        return ctx.pack_spec if ctx.opt("param_plane", True) else None

    def mixing(self, ctx: ExperimentContext) -> torch.Tensor:
        """(N, N) averaging weights on the run's device: exact global mean
        (centralized) or Metropolis gossip over the client graph
        (decentralized)."""
        return torch.as_tensor(
            mixing_matrix(ctx.graph, ctx.n_clients, self.centralized),
            device=ctx.device)

    def _static_comm(self, ctx: ExperimentContext, models: int = 1) -> CommModel:
        """Every client ships ``models`` models per round: over each
        directed link (decentralized) or up and down to a server."""
        mb = ctx.pack_spec.model_bytes
        per_round = (star_bytes(ctx.n_clients, mb, models) if self.centralized
                     else edges_bytes(ctx.graph, mb, models))
        return CommModel(kind="static", per_round_bytes=per_round)

    def _channel(self, ctx: ExperimentContext) -> Channel | None:
        """The run's wire channel, or None without a compressing codec
        (``codec="fp32"`` included: the uncompressed exchange stays bit
        for bit what it was). A codec needs the plane, as in JAX."""
        ch = make_channel(ctx.opt("comm"), ctx.pack_spec.size)
        if ch is not None and self.plane_spec(ctx) is None:
            raise ValueError(
                f"comm codec {ch.cfg.codec!r} operates on the packed "
                "parameter plane; run with param_plane=True (run_method "
                "enables it automatically when comm is set)")
        return ch

    def _with_ef(self, ctx: ExperimentContext, state, prefix: tuple | None = None):
        """``state`` with the error-feedback residual in its ``ef`` field
        when the run's channel carries one (as it is otherwise). ``prefix``
        is the residual's batch shape: one message per client by default;
        FedEM ships (S, N)."""
        ch = self._channel(ctx)
        if ch is None or not ch.has_ef:
            return state
        return state._replace(
            ef=ch.init_residual(prefix or (ctx.n_clients,), device=ctx.device))


_REGISTRY: dict[str, Method] = {}


def register(method: Method) -> Method:
    if not method.name:
        raise ValueError("method must set a name")
    if method.name in _REGISTRY:
        raise ValueError(f"duplicate method {method.name!r}")
    _REGISTRY[method.name] = method
    return method


def get_method(name: str) -> Method:
    if name not in _REGISTRY:
        raise KeyError(f"unknown method {name!r}; available: {available_methods()}")
    return _REGISTRY[name]


def available_methods() -> tuple[str, ...]:
    return tuple(_REGISTRY)


class FedSPDMethod(Method):
    """Paper Algorithm 1 behind the registry contract, on the packed
    ``(S, N, X)`` plane or the pytree engine. ``mode`` is the gossip wiring ("dense" or
    "permute"; ``ctx.options["mode"]`` overrides it), coloured over the
    context's graph (the union graph under per-seed graphs or a
    scenario, so every round's adjacency is a subgraph of it). The
    exchange runs the CUDA kernels on the "cuda" backend (their plain
    versions on CPU tensors). Takes ``comm`` (a wire codec), ``sparse``
    (DisPFL masks) and ``cos_align_threshold``."""

    features = ("comm", "sparse")
    supports_dynamic_graph = True

    def __init__(self, name: str, mode: str = "dense"):
        self.name = name
        self.mode = mode

    def _fcfg(self, ctx: ExperimentContext) -> FedSPDConfig:
        exp = ctx.exp
        return FedSPDConfig(
            n_clients=ctx.n_clients, n_clusters=ctx.n_clusters, tau=exp.tau,
            batch=exp.batch, lr0=exp.lr0, lr_decay=exp.lr_decay,
            tau_final=ctx.opt("tau_final", exp.tau_final),
            dp_clip=ctx.opt("dp_clip", 0.0),
            dp_noise_multiplier=ctx.opt("dp_noise_multiplier", 0.0),
        )

    def _sparse(self, ctx: ExperimentContext) -> SparseConfig | None:
        """The run's SparseConfig; masks live on the packed X axis, so any
        config (density 1.0 too) needs the plane, as in JAX."""
        sp = ctx.opt("sparse")
        if sp is not None and self.plane_spec(ctx) is None:
            raise ValueError(
                f"sparse training (density={sp.density}) runs on the "
                "packed parameter plane; set RunConfig(param_plane=True) "
                "(run_method enables it automatically when sparse is set)")
        if sp is not None and sp.enabled and ctx.opt("gossip_backend") == "ppermute":
            raise ValueError(
                "sparse training is not available on the ppermute backend "
                "— the collective schedule ships raw plane rows, not "
                "masked payloads")
        return sp

    def init(self, ctx, gen):
        state = self._with_ef(ctx, seeded_init(gen, ctx.model_init, self._fcfg(ctx),
                                               ctx.loss_fn, ctx.train,
                                               self.plane_spec(ctx)))
        sp = self._sparse(ctx)
        if sp is not None:
            # masks ride along even at density 1.0 (all ones, no draw)
            state = state._replace(
                mask=init_masks(gen, ctx.n_clients, ctx.pack_spec.size, sp))
        return state

    def _spec(self, ctx: ExperimentContext) -> GossipSpec:
        return GossipSpec.from_graph(
            ctx.graph, mode=ctx.opt("mode", self.mode),
            cos_align_threshold=ctx.opt("cos_align_threshold", -1.0))

    def make_step(self, ctx):
        spec = self._spec(ctx)
        comm = ctx.opt("comm")
        ps = self.plane_spec(ctx)
        mix_fn = make_mix_fn(spec, ctx.opt("gossip_backend", "cuda"), comm=comm,
                             plane=ps is not None)
        step = make_round_step(ctx.loss_fn, ctx.pel_fn, spec, self._fcfg(ctx),
                               pack_spec=ps, mix_fn=mix_fn,
                               comm=comm, sparse=self._sparse(ctx))

        def wrapped(state, train, gen, lr, adj=None):
            # the round step draws from state.gen; the driver's gen is for
            # the uniform signature. lr comes from the driver's tape of
            # FedSPD's own schedule (lr_schedule); None runs that schedule
            # from state.round
            del gen
            return step(state, train, adj, lr=lr)

        return wrapped

    def lr_schedule(self, ctx):
        """FedSPD's own schedule, ``round_lr`` of each round (fp32 ops)."""
        cfg = self._fcfg(ctx)
        return np.asarray([round_lr(cfg, r) for r in range(ctx.exp.rounds)],
                          np.float32)

    def round_branch(self, ctx, r):
        """Whether round r updates the sparse masks (RigL), the one branch
        FedSPD's step takes on the host."""
        sp = self._sparse(ctx)
        return sp is not None and sp.enabled and sp.update_due(r)

    def cohort_axes(self, ctx, state):
        """centers (S, N, X) on axis 1; u, z, ef and mask on axis 0; round,
        gen and comm_bytes global. The packed plane and the dense wiring
        only, as in JAX (a client-system scenario masks its rows through
        the same map)."""
        if self.plane_spec(ctx) is None:
            raise ValueError(
                "cohort subsampling and client-system heterogeneity "
                "(Scenario.system) run on the packed (S, N, X) parameter "
                "plane; set RunConfig(param_plane=True)")
        if ctx.opt("mode", self.mode) != "dense":
            raise ValueError(
                "cohort subsampling needs the dense gossip wiring — the "
                "permute edge coloring is sized to the full client axis")
        if ctx.opt("gossip_backend") == "ppermute":
            raise ValueError(
                "cohort subsampling is not available on the ppermute "
                "backend (one device per client row)")
        return FedSPDState(
            centers=1, u=0, z=0, round=None, gen=None, comm_bytes=None,
            ef=None if state.ef is None else 0,
            mask=None if state.mask is None else 0)

    def personalize(self, ctx, state, gen=None):
        with torch.enable_grad():
            return final_phase(state, ctx.loss_fn, ctx.train, self._fcfg(ctx),
                               self.plane_spec(ctx))

    def comm_model(self, ctx):
        return CommModel(kind="tracked")

    def extras(self, ctx, state, aux):
        out = {"u": state.u.cpu().numpy()}
        if aux and "consensus" in aux:
            out["consensus"] = aux["consensus"].cpu().numpy()
        return out


# --------------------------------------------------------------------------
# Baselines
# --------------------------------------------------------------------------


class LocalMethod(Method):
    """No exchange: a wire codec is accepted and changes nothing (its
    bytes are 0 either way), as in the JAX registry."""

    name = "local"
    features = ("comm",)

    def init(self, ctx, gen):
        return init_planes(gen, ctx.model_init, ctx.n_clients, self.plane_spec(ctx))

    def make_step(self, ctx):
        return local.make_step(ctx.loss_fn, tau=ctx.exp.tau,
                               batch=ctx.exp.batch, pack_spec=self.plane_spec(ctx))

    def personalize(self, ctx, state, gen=None):
        return local.personalized_params(state, self.plane_spec(ctx))

    def comm_model(self, ctx):
        return CommModel(kind="static", per_round_bytes=0.0)


class _PairedMethod(Method):
    """A baseline registered as a ``dfl_`` and a ``cfl_`` variant. Its
    exchange takes the run's wire codec (``comm``); with error feedback
    the state carries the residual."""

    features = ("comm",)

    def __init__(self, name: str, centralized: bool):
        self.name = name
        self.centralized = centralized


class FedAvgMethod(_PairedMethod):
    def init(self, ctx, gen):
        plane = init_planes(gen, ctx.model_init, ctx.n_clients, self.plane_spec(ctx))
        ch = self._channel(ctx)
        ef = (ch.init_residual((ctx.n_clients,), device=ctx.device)
              if ch is not None else None)
        return join_ef(plane, ef, ch)

    def make_step(self, ctx):
        return fedavg.make_step(ctx.loss_fn, self.mixing(ctx), tau=ctx.exp.tau,
                                batch=ctx.exp.batch, pack_spec=self.plane_spec(ctx),
                                channel=self._channel(ctx))

    def personalize(self, ctx, state, gen=None):
        return fedavg.personalized_params(state, self.plane_spec(ctx),
                                          channel=self._channel(ctx))

    def comm_model(self, ctx):
        return self._static_comm(ctx)


class FedEMMethod(_PairedMethod):
    """Trains and exchanges ALL S cluster models per round (S× comm);
    personalized prediction is the u-weighted probability mixture, so
    ``evaluate`` overrides the personalize-based default."""

    def init(self, ctx, gen):
        state = fedem.init_state(gen, ctx.model_init, ctx.n_clients,
                                 ctx.n_clusters, self.plane_spec(ctx))
        # FedEM ships every one of the S stacks each round
        return self._with_ef(ctx, state, prefix=(ctx.n_clusters, ctx.n_clients))

    def make_step(self, ctx):
        return fedem.make_step(ctx.pel_fn, self.mixing(ctx), tau=ctx.exp.tau,
                               batch=ctx.exp.batch, s_clusters=ctx.n_clusters,
                               pack_spec=self.plane_spec(ctx), channel=self._channel(ctx))

    def personalize(self, ctx, state, gen=None):
        """The u-weighted parameter average, for serve-style export;
        accuracy uses the probability mixture."""
        return fedem.personalize(state, self.plane_spec(ctx))

    def evaluate(self, ctx, state, on, gen=None):
        with torch.no_grad():
            return fedem.personalized_accuracy(ctx.apply_fn, state, on,
                                               self.plane_spec(ctx))

    def comm_model(self, ctx):
        return self._static_comm(ctx, models=ctx.n_clusters)

    def extras(self, ctx, state, aux):
        return {"u": state.u.cpu().numpy()}


class IFCAMethod(_PairedMethod):
    def init(self, ctx, gen):
        return self._with_ef(ctx, ifca.init_state(gen, ctx.model_init, ctx.n_clients,
                                                  ctx.n_clusters, self.plane_spec(ctx)))

    def make_step(self, ctx):
        g_eff = complete(ctx.n_clients) if self.centralized else ctx.graph
        return ifca.make_step(ctx.loss_fn, ctx.pel_fn, GossipSpec.from_graph(g_eff),
                              tau=ctx.exp.tau, batch=ctx.exp.batch,
                              pack_spec=self.plane_spec(ctx), channel=self._channel(ctx))

    def personalize(self, ctx, state, gen=None):
        return ifca.personalized_params(state, self.plane_spec(ctx))

    def comm_model(self, ctx):
        return self._static_comm(ctx)

    def extras(self, ctx, state, aux):
        return {"choice": state.choice.cpu().numpy()}


class FedSoftMethod(_PairedMethod):
    def init(self, ctx, gen):
        return self._with_ef(ctx, fedsoft.init_state(gen, ctx.model_init, ctx.n_clients,
                                                     ctx.n_clusters, self.plane_spec(ctx)))

    def make_step(self, ctx):
        return fedsoft.make_step(ctx.loss_fn, ctx.pel_fn, self.mixing(ctx),
                                 tau=ctx.exp.tau, batch=ctx.exp.batch,
                                 s_clusters=ctx.n_clusters,
                                 pack_spec=self.plane_spec(ctx), channel=self._channel(ctx))

    def personalize(self, ctx, state, gen=None):
        return fedsoft.personalized_params(state, self.plane_spec(ctx))

    def comm_model(self, ctx):
        return self._static_comm(ctx)

    def extras(self, ctx, state, aux):
        return {"u": state.u.cpu().numpy()}


class PFedMeMethod(_PairedMethod):
    def init(self, ctx, gen):
        return self._with_ef(ctx, pfedme.init_state(gen, ctx.model_init, ctx.n_clients,
                                                    self.plane_spec(ctx)))

    def make_step(self, ctx):
        return pfedme.make_step(ctx.loss_fn, self.mixing(ctx), tau=ctx.exp.tau,
                                batch=ctx.exp.batch, pack_spec=self.plane_spec(ctx),
                                channel=self._channel(ctx))

    def personalize(self, ctx, state, gen=None):
        """A fresh inner solve from the final w, drawing from ``gen``
        (the driver hands a copy of the run's stream)."""
        if gen is None:
            raise ValueError("pFedMe's personalization draws batches: pass gen")
        with torch.enable_grad():
            return pfedme.personalized_params(state, ctx.loss_fn, ctx.train, gen,
                                              batch=ctx.exp.batch,
                                              pack_spec=self.plane_spec(ctx))

    def comm_model(self, ctx):
        return self._static_comm(ctx)


# --------------------------------------------------------------------------
# Registrations: FedSPD + all six baselines, dfl_ and cfl_ variants
# --------------------------------------------------------------------------

register(FedSPDMethod("fedspd"))
register(FedSPDMethod("fedspd_permute", mode="permute"))
register(LocalMethod())
for _cls, _base in (
    (FedAvgMethod, "fedavg"),
    (FedEMMethod, "fedem"),
    (IFCAMethod, "ifca"),
    (FedSoftMethod, "fedsoft"),
    (PFedMeMethod, "pfedme"),
):
    register(_cls(f"dfl_{_base}", centralized=False))
    register(_cls(f"cfl_{_base}", centralized=True))
