"""Meta-device input specs for every (arch × input shape × step): the JAX
package's ``launch/specs.py``.

``input_specs`` / ``build_dryrun`` give every input of a step as a meta
tensor of its global shape (no storage), each paired with its spec from
``launch/sharding.py`` (the counterpart of JAX's ``ShapeDtypeStruct`` with
a ``NamedSharding``), so ``launch/dryrun.py`` can run one rank's share of
the full production step on the meta device and count its work
(``roofline/analysis.py``). ``mesh`` is a ``launch/mesh.MeshShape``: the
production mesh by its axis sizes, without its ranks.

How the port runs on that mesh decides a rank's share
(``DryrunCase.local_args``, by ``DryrunCase.shares``): the client axis
and the batch split over the data axes; the model axis is replicated
(each rank of a data row computes its client's, or its requests', whole
model: ``launch/mesh.py``), so a dim over ``"model"`` stays whole, and a
cache splits only by its requests (the registry's decode runs a request's
whole cache; a batch the data axes do not divide, long_500k's one
request, runs whole on every rank). The FedSPD step is
``make_fedspd_train_step(mesh=...)`` on the packed plane, one client a
data row, its exchange the send/recv schedule
(``make_ppermute_gossip_mix``), its collectives the dry-run's counting
stand-in (``roofline/analysis.counting_collectives``), which
``launch/dryrun.run_case`` installs around the call.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.configs.base import INPUT_SHAPES, ArchConfig, get_config
from repro_torch.core.fedspd import FedSPDConfig, FedSPDState
from repro_torch.core.packing import make_pack_spec
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import MeshShape, dp_axes, dp_size, mesh_sizes
from repro_torch.launch.steps import (
    arch_for_shape,
    make_decode_step,
    make_fedspd_train_step,
    make_gossip,
    make_plain_train_step,
    make_prefill_step,
    supports_shape,
)
from repro_torch.models.registry import ModelBundle, build_model

PyTree = Any
META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class DryrunMesh(MeshShape):
    """Rank 0 of a mesh of ``shape`` for the dry-run's step: what
    ``launch/sharding.ClientGroup`` and ``make_ppermute_gossip_mix`` ask a
    ``DeviceMesh`` (its names, its rank table, this rank's coordinate and
    groups), with no process group behind it."""

    @property
    def mesh_dim_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def mesh(self) -> torch.Tensor:
        return torch.arange(math.prod(self.shape.values())).reshape(
            tuple(self.shape.values()))

    def get_coordinate(self) -> list:
        return [0] * len(self.shape)

    def get_group(self, name):
        return ("dry-run group", name)


def _dp(mesh):
    return shd._axes(dp_axes(mesh))


def param_specs(bundle: ModelBundle, mesh) -> tuple[dict, dict]:
    """(meta parameters, their specs) of one model (the tensor-parallel
    rules; the port replicates the model axis when it runs them)."""
    params = bundle.init(None)
    return params, shd.params_pspecs(params, mesh)


def fedspd_state_specs(bundle: ModelBundle, fcfg: FedSPDConfig, mesh,
                       replicate_model_dims: bool = False,
                       pack_spec=None) -> tuple[FedSPDState, FedSPDState]:
    """(meta FL state, its specs): centers ``(S, N, ·)`` client-sharded,
    a tree as JAX's (``pack_spec=None``) or the port's packed ``(S, N,
    X)`` plane; u ``(N, S)`` fp32, z ``(N, 1)`` int64 (the port's index
    dtype; JAX's int32), comm_bytes ``()`` fp32; ``round`` 0 and no
    generator (the dry-run injects nothing it would draw)."""
    dp = _dp(mesh)
    lead = (fcfg.n_clusters, fcfg.n_clients)
    if pack_spec is not None:
        centers = torch.empty(lead + (pack_spec.size,), device=META)
        centers_spec = (None, dp, None)
    else:
        params = bundle.init(None)
        centers = shd._tree_map_with_path(
            lambda _, leaf: torch.empty(lead + tuple(leaf.shape), dtype=leaf.dtype,
                                        device=META), params)

        def spec(path, leaf):
            inner = ((None,) * len(leaf.shape) if replicate_model_dims
                     else shd.param_spec(path, tuple(leaf.shape), mesh))
            return (None, dp) + tuple(inner)

        centers_spec = shd._tree_map_with_path(spec, params)
    state = FedSPDState(
        centers=centers, u=torch.empty((fcfg.n_clients, fcfg.n_clusters), device=META),
        z=torch.empty((fcfg.n_clients, 1), dtype=torch.int64, device=META), round=0,
        gen=None, comm_bytes=torch.empty((), device=META))
    specs = FedSPDState(centers=centers_spec, u=(dp, None), z=(dp, None), round=(), gen=(),
                        comm_bytes=())
    return state, specs


def _token_batch(cfg: ArchConfig, lead_shape: tuple, seq_len: int, mesh,
                 lead_spec: tuple) -> tuple[dict, dict]:
    batch = {"tokens": torch.empty(lead_shape + (seq_len,), dtype=torch.int64, device=META)}
    specs = {"tokens": (*lead_spec, None)}
    if cfg.family == "audio":
        d_enc = cfg.encoder_d_model or cfg.d_model
        batch["frames"] = torch.empty(lead_shape + (cfg.encoder_frames, d_enc), device=META)
        specs["frames"] = (*lead_spec, None, None)
    return batch, specs


def cache_specs(bundle: ModelBundle, batch: int, max_len: int, mesh) -> tuple[dict, dict]:
    cache = bundle.init_cache(batch, max_len, device="meta")
    return cache, shd.cache_pspecs(cache, mesh)


def _local(arg, spec, mesh):
    """``arg``'s share on rank 0: each dim its spec puts over data axes
    split over them (a narrow view; the model axis stays whole)."""
    if isinstance(arg, torch.Tensor):
        sizes = mesh_sizes(mesh)
        out = arg
        for d, entry in enumerate(spec):
            axes = entry if isinstance(entry, tuple) else (entry,)
            parts = math.prod(sizes[a] for a in axes if a in dp_axes(mesh))
            if parts > 1:
                out = out.narrow(d, 0, -(-arg.shape[d] // parts))
        return out
    if isinstance(arg, tuple) and hasattr(arg, "_fields"):
        return type(arg)(*(_local(a, s, mesh) for a, s in zip(arg, spec)))
    if isinstance(arg, dict):
        return {k: _local(v, spec[k], mesh) for k, v in arg.items()}
    if isinstance(arg, tuple):
        return tuple(_local(a, s, mesh) for a, s in zip(arg, spec))
    return arg


@dataclasses.dataclass(frozen=True)
class DryrunCase:
    """One dry-run target: ``fn(*args)`` with meta args of their global
    shapes, their sharding rules' ``specs``, and ``shares``, the specs of
    how the port splits them (both of ``args``' structure)."""
    arch: str
    shape: str
    step_kind: str  # fedspd | plain | prefill | decode
    fn: Callable
    args: tuple
    specs: tuple
    shares: tuple
    mesh: MeshShape
    note: str = ""

    def local_args(self) -> tuple:
        """Rank 0's share of ``args`` (views, no copy)."""
        return _local(self.args, self.shares, self.mesh)


def _by_request(cache: dict, split) -> dict:
    """A cache's shares: the request dim (1, after the layer stack) over
    ``split`` (the data axes, or None), every other dim whole."""
    return {k: (None, split) + (None,) * (v.dim() - 2) if v.dim() >= 2 else (None,) * v.dim()
            for k, v in cache.items()}


def build_dryrun(
    arch: str,
    shape_name: str,
    mesh: MeshShape,
    *,
    step_kind: str = "auto",
    attn_mode: str = "blocked",
    gossip_mode: str = "dense",
    n_clusters: int = 2,
    tau: int = 1,
    cfg_override: ArchConfig | None = None,
) -> DryrunCase:
    """Assemble (step fn, meta inputs and their specs) for one dry-run
    combination. JAX's ``remat``, ``scan_unroll`` and ``layout`` have no
    counterpart: the port keeps activations, runs its layers as a loop,
    and replicates the model axis (``launch/dryrun.py`` refuses the
    layouts that split a client's batch over it)."""
    shape = INPUT_SHAPES[shape_name]
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    ok, why = supports_shape(cfg, shape_name)
    if not ok:
        raise ValueError(f"{arch} × {shape_name}: {why}")
    cfg, note = arch_for_shape(cfg, shape_name)
    if step_kind == "auto":
        step_kind = "fedspd" if shape.kind == "train" else shape.kind
    mesh = DryrunMesh(dict(mesh_sizes(mesh)))
    dp, dp_n = _dp(mesh), dp_size(mesh)
    notes = [note] if note else []

    if step_kind in ("fedspd", "plain"):
        # the training route: attention "ref", the SSD chunked, under autograd
        bundle = build_model(cfg, train=True)
    else:
        bundle = build_model(cfg, attn_mode=attn_mode)

    if step_kind == "fedspd":
        n_clients = dp_n
        per_client = max(1, shape.global_batch // n_clients)
        fcfg = FedSPDConfig(n_clients=n_clients, n_clusters=n_clusters, tau=tau,
                            batch=per_client, regime="stream")
        gossip = make_gossip(n_clients, mesh_sizes(mesh).get("pod", 1),
                             mode="permute" if gossip_mode == "permute" else "dense")
        pack_spec = make_pack_spec(bundle.init(None))
        state, state_specs = fedspd_state_specs(bundle, fcfg, mesh, pack_spec=pack_spec)
        batch, batch_specs = _token_batch(cfg, (n_clients, per_client), shape.seq_len, mesh,
                                          (dp,))
        built = []

        def fn(state, batch):
            # built on the first call, inside the counting stand-in: a
            # three-axis mesh's client groups are made by the process group
            if not built:
                built.append(make_fedspd_train_step(bundle, gossip, fcfg,
                                                    pack_spec=pack_spec, mesh=mesh))
            return built[0](state, batch)

        args, specs = (state, batch), (state_specs, batch_specs)
        shares = specs
        notes.append(f"N={n_clients} clients, {per_client} seq/client, one client a data "
                     "row (model axis replicated), the send/recv gossip")

    elif step_kind == "plain":
        fn = make_plain_train_step(bundle)
        params, pspecs = param_specs(bundle, mesh)
        opt_state = fn.init(params)
        batch, batch_specs = _token_batch(cfg, (shape.global_batch,), shape.seq_len, mesh,
                                          (dp,))
        args = (params, opt_state, batch)
        specs = shares = (pspecs, _replicated(opt_state), batch_specs)
        notes.append("a data-parallel rank's share (model axis replicated); the port's "
                     "step holds no gradient all-reduce")

    elif step_kind == "prefill":
        fn = make_prefill_step(bundle)
        params, pspecs = param_specs(bundle, mesh)
        batch, batch_specs = _token_batch(cfg, (shape.global_batch,), shape.seq_len, mesh,
                                          (dp,))
        cache, cspecs = cache_specs(bundle, shape.global_batch, shape.seq_len, mesh)
        args, specs = (params, batch, cache), (pspecs, batch_specs, cspecs)
        shares = (pspecs, batch_specs, _by_request(cache, dp))
        notes.append("a data-parallel rank's requests (model axis replicated)")

    elif step_kind == "decode":
        fn = make_decode_step(bundle)
        params, pspecs = param_specs(bundle, mesh)
        cache, cspecs = cache_specs(bundle, shape.global_batch, shape.seq_len, mesh)
        b_spec = dp if shape.global_batch % dp_n == 0 else None
        tokens = torch.empty((shape.global_batch, 1), dtype=torch.int64, device=META)
        args, specs = (params, cache, tokens), (pspecs, cspecs, (b_spec, None))
        shares = (pspecs, _by_request(cache, b_spec), (b_spec, None))
        notes.append("a data-parallel rank's requests and their caches (model axis "
                     "replicated)" if b_spec else
                     f"{shape.global_batch} request(s) on every rank, its whole cache (the "
                     "registry's decode splits no cache length)")

    else:
        raise ValueError(f"unknown step kind {step_kind!r}")

    return DryrunCase(arch=arch, shape=shape_name, step_kind=step_kind, fn=fn, args=args,
                      specs=specs, shares=shares, mesh=mesh, note="; ".join(notes))


def _replicated(tree):
    """A spec tree that leaves every leaf whole (the optimizer state
    follows its parameters, which the port replicates)."""
    if isinstance(tree, dict):
        return {k: _replicated(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_replicated(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_replicated(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return (None,) * tree.dim()
    return ()


def input_specs(arch: str, shape_name: str, mesh, **kw) -> tuple:
    """Meta tensors of every model input of this (arch × shape)
    combination, their global shapes (``build_dryrun(...).args``)."""
    return build_dryrun(arch, shape_name, mesh, **kw).args
