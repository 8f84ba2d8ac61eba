"""Method registry: FL algorithms behind one contract.

The driver (experiments/runner.py) knows nothing about individual
algorithms; each registers a ``Method`` adapter here:

    init(ctx, gen)                 -> state
    make_step(ctx)                 -> step(state, train) -> (state, aux)
    personalize(ctx, state)        -> params, leaves (N, ...)
    evaluate(ctx, state, on)       -> (N,) per-client accuracy
    extras(ctx, state, aux)        -> dict of host-side diagnostics

The port has FedSPD (``"fedspd"``, paper Algorithm 1 on the packed plane)
so far; the JAX package's other twelve ids raise ``ValueError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.paper_cnn import PaperExpConfig
from repro_torch.core.fedspd import (
    FedSPDConfig,
    final_phase,
    make_round_step,
    seeded_init,
)
from repro_torch.core.gossip import GossipSpec, make_mix_fn
from repro_torch.core.packing import PackSpec, make_pack_spec
from repro_torch.device import make_generator
from repro_torch.graphs.topology import Graph, make_graph
from repro_torch.models.smallnets import make_classifier

# registered by the JAX package and not ported yet
UNPORTED_METHODS = (
    "fedspd_permute", "local",
    "dfl_fedavg", "cfl_fedavg", "dfl_fedem", "cfl_fedem",
    "dfl_ifca", "cfl_ifca", "dfl_fedsoft", "cfl_fedsoft",
    "dfl_pfedme", "cfl_pfedme",
)


@dataclasses.dataclass(frozen=True)
class ExperimentContext:
    """Everything a Method needs to build its state and step function."""

    exp: PaperExpConfig
    graph: Graph
    n_clients: int
    n_clusters: int
    model_init: Callable[[torch.Generator], dict]
    loss_fn: Callable
    pel_fn: Callable        # per-example loss (clustering)
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
    params0, _, loss_fn, pel_fn, acc_fn = make_classifier(
        exp.model, make_generator(device, seed), dim, n_classes)

    def model_init(gen):
        return make_classifier(exp.model, gen, dim, n_classes)[0]

    spec = make_pack_spec(params0)

    def on_device(x, y):
        return {"inputs": torch.as_tensor(x, dtype=torch.float32, device=device),
                "targets": torch.as_tensor(y, dtype=torch.int64, device=device)}

    return ExperimentContext(
        exp=exp, graph=graph, n_clients=data.n_clients,
        n_clusters=data.n_clusters, model_init=model_init, loss_fn=loss_fn,
        pel_fn=pel_fn, acc_fn=acc_fn, pack_spec=spec, train=on_device(data.x, data.y),
        test=on_device(data.x_test, data.y_test), device=device,
        options=dict(options or {}),
    )


def per_client_eval(metric_fn: Callable, params: dict, data: dict) -> torch.Tensor:
    """metric_fn batched over the client axis -> ``(N,)``."""
    return metric_fn(params, {"x": data["inputs"], "y": data["targets"]})


class Method:
    """Base adapter; subclasses implement init/make_step/personalize. A
    state carries its cumulative logical bytes in ``state.comm_bytes``."""

    name: str = ""

    def init(self, ctx: ExperimentContext, gen: torch.Generator):
        raise NotImplementedError

    def make_step(self, ctx: ExperimentContext) -> Callable:
        raise NotImplementedError

    def personalize(self, ctx: ExperimentContext, state) -> dict:
        raise NotImplementedError

    def evaluate(self, ctx: ExperimentContext, state, on: dict) -> torch.Tensor:
        """Per-client accuracy of the personalized models on ``on``."""
        with torch.no_grad():
            return per_client_eval(ctx.acc_fn, self.personalize(ctx, state), on)

    def extras(self, ctx: ExperimentContext, state, aux: dict) -> dict:
        return {}


_REGISTRY: dict[str, Method] = {}


def register(method: Method) -> Method:
    if not method.name:
        raise ValueError("method must set a name")
    if method.name in _REGISTRY:
        raise ValueError(f"duplicate method {method.name!r}")
    _REGISTRY[method.name] = method
    return method


def get_method(name: str) -> Method:
    if name in UNPORTED_METHODS:
        raise ValueError(
            f"method {name!r} is not ported yet; the port has "
            f"{available_methods()}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown method {name!r}; available: {available_methods()}")
    return _REGISTRY[name]


def available_methods() -> tuple[str, ...]:
    return tuple(_REGISTRY)


class FedSPDMethod(Method):
    """Paper Algorithm 1 behind the registry contract, on the packed
    ``(S, N, X)`` plane; the exchange runs the CUDA kernels (their plain
    versions on CPU tensors)."""

    def __init__(self, name: str):
        self.name = name

    def _fcfg(self, ctx: ExperimentContext) -> FedSPDConfig:
        exp = ctx.exp
        return FedSPDConfig(
            n_clients=ctx.n_clients, n_clusters=ctx.n_clusters, tau=exp.tau,
            batch=exp.batch, lr0=exp.lr0, lr_decay=exp.lr_decay,
            tau_final=ctx.opt("tau_final", exp.tau_final),
            dp_clip=ctx.opt("dp_clip", 0.0),
            dp_noise_multiplier=ctx.opt("dp_noise_multiplier", 0.0),
        )

    def init(self, ctx, gen):
        return seeded_init(gen, ctx.model_init, self._fcfg(ctx), ctx.loss_fn,
                           ctx.train, ctx.pack_spec)

    def make_step(self, ctx):
        spec = GossipSpec.from_graph(ctx.graph)
        mix_fn = make_mix_fn(spec, ctx.opt("gossip_backend", "cuda"))
        return make_round_step(ctx.loss_fn, ctx.pel_fn, spec, self._fcfg(ctx),
                               pack_spec=ctx.pack_spec, mix_fn=mix_fn)

    def personalize(self, ctx, state):
        with torch.enable_grad():
            return final_phase(state, ctx.loss_fn, ctx.train, self._fcfg(ctx),
                               ctx.pack_spec)

    def extras(self, ctx, state, aux):
        out = {"u": state.u.cpu().numpy()}
        if aux and "consensus" in aux:
            out["consensus"] = aux["consensus"].cpu().numpy()
        return out


register(FedSPDMethod("fedspd"))
