"""Sharding rules over the mesh, and the packed FedSPD state placed on it:
the JAX package's ``launch/sharding.py`` as DTensor placements.

The rules are pure functions of a leaf's path, its shape and the mesh's
axis sizes (a ``DeviceMesh`` or a ``launch/mesh.MeshShape``). Each returns
a spec: a tuple with one entry a tensor dim, ``None`` (replicated), an
axis name, or a tuple of axis names, written as JAX's ``PartitionSpec``
normalizes it (a one-axis tuple is the axis name), so ``tuple(P(...))``
of the JAX rule equals the port's spec.

- **Parameters** split over ``"model"``: MoE expert tensors on the expert
  dim, everything else on the largest dim divisible by the model-axis
  size (ties to the later dim). Leaves under a stacked container
  (``_STACKED``) skip the leading layer axis; leaves below
  ``_MIN_SHARD_ELEMS`` stay replicated.
- **FedSPD state**: pytree centers ``(S, N, *param)`` put the client axis
  over the data axes and reuse the parameter rule inside; the packed
  ``(S, N, X)`` plane keeps X replicated (its leaf offsets are static);
  u, z and ef shard their client axis; scalars replicate.
- **Batches**: the leading dim over the data axes.
- **Decode caches**: the batch dim over the data axes when it divides,
  else the cache-length dim; heads over ``"model"`` when they divide,
  else the head dim, else the length (``decode_attention``'s (m, l, o)
  partials make a length split exact).

``to_shardings`` turns specs into DTensor placements, one a mesh dim.
``shard_plane_state`` places a packed ``FedSPDState`` on a ``DeviceMesh``
as DTensors (centers, u, z, ef sharded over the data axes, replicated
over ``"model"``; ``comm_bytes`` a plain tensor every rank holds
alike, as are ``round`` and the generator); the mesh round
(``launch/steps.make_fedspd_train_step(mesh=...)``) works on their local
shards, and ``gather_plane_state`` gives the global state back.
"""
from __future__ import annotations

import math

import torch

from repro_torch.launch.mesh import dp_axes, mesh_sizes, model_size

# leaves whose total size is below this stay replicated (norm scales, biases)
_MIN_SHARD_ELEMS = 1 << 16

# containers whose children carry a leading stacked (n_layers,) axis
_STACKED = ("layers", "enc_layers", "dec_layers", "mamba_layers")


def _path_str(path) -> str:
    """A leaf's path of dict keys (or indices) as JAX's ``/``-joined,
    lower-cased name."""
    return "/".join(str(p) for p in path).lower()


def _axes(names: tuple):
    """A tuple of mesh axes as a spec entry (one axis: its name)."""
    return names[0] if len(names) == 1 else tuple(names)


def _tree_map_with_path(f, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(f, tree[k], path + (k,)) for k in sorted(tree)}
    return f(path, tree)


def _generic_model_dim(shape, start: int, m: int):
    """Largest dim in shape[start:] divisible by the model-axis size (ties
    to the later dim); None if none divides."""
    best, best_size = None, 0
    for d in range(start, len(shape)):
        if shape[d] % m == 0 and shape[d] >= m and shape[d] >= best_size:
            best, best_size = d, shape[d]
    return best


def param_spec(path, leaf_shape, mesh) -> tuple:
    """The spec of one model-parameter leaf."""
    m = model_size(mesh)
    name = _path_str(path)
    skip = 1 if any(s in name for s in _STACKED) else 0
    spec = [None] * len(leaf_shape)
    if math.prod(leaf_shape) < _MIN_SHARD_ELEMS:
        return tuple(spec)
    # MoE expert tensors: expert-parallel over "model"
    if any(k in name for k in ("w_in", "w_out", "w_gate")) and len(leaf_shape) >= 3:
        if leaf_shape[skip] % m == 0:
            spec[skip] = "model"
            return tuple(spec)
    d = _generic_model_dim(leaf_shape, skip, m)
    if d is not None:
        spec[d] = "model"
    return tuple(spec)


def params_pspecs(params, mesh):
    return _tree_map_with_path(lambda path, leaf: param_spec(path, tuple(leaf.shape), mesh),
                               params)


def fedspd_state_pspecs(state, mesh):
    """Specs of a ``FedSPDState``: pytree centers with leaves ``(S, N,
    *param)``, or the packed ``(S, N, X)`` plane (``plane_state_pspecs``)."""
    if isinstance(state.centers, torch.Tensor):
        return plane_state_pspecs(state, mesh)
    dp = _axes(dp_axes(mesh))
    centers = _tree_map_with_path(
        lambda path, leaf: (None, dp) + param_spec(path, tuple(leaf.shape[2:]), mesh),
        state.centers)
    return type(state)(centers=centers, u=(dp, None), z=(dp, None), round=(), gen=(),
                       comm_bytes=())


def plane_state_pspecs(state, mesh):
    """Specs of a ``FedSPDState`` on the packed plane: the client axis over
    the data axes (one client a data row), X replicated; u, z and ef (when
    the state carries one) on their client axis."""
    dp = _axes(dp_axes(mesh))
    return type(state)(centers=(None, dp, None), u=(dp, None), z=(dp, None), round=(),
                       gen=(), comm_bytes=(),
                       ef=None if state.ef is None else (dp, None))


def batch_pspecs(batch, mesh):
    """Leading dim (global batch or client axis) over the data axes."""
    dp = _axes(dp_axes(mesh))
    return _tree_map_with_path(lambda _, leaf: (dp,) + (None,) * (leaf.dim() - 1), batch)


def _cache_leaf_spec(name: str, shape, mesh) -> tuple:
    """KV cache leaves ``(Lay, B, Lc, Hkv, hd)``; SSM state ``(Lay, B, H,
    P, N)``; conv state ``(Lay, B, w, D)``; ``pos`` ``()``."""
    dp = dp_axes(mesh)
    sizes = mesh_sizes(mesh)
    dp_n = math.prod(sizes[a] for a in dp)
    m = model_size(mesh)
    spec = [None] * len(shape)
    if len(shape) == 0 or math.prod(shape) < _MIN_SHARD_ELEMS:
        return tuple(spec)

    b_dim = 1 if len(shape) >= 2 else None      # the leading dim is the layer stack
    big_dim = 2 if len(shape) >= 3 else None    # cache length / heads / width
    if b_dim is not None and shape[b_dim] % dp_n == 0 and shape[b_dim] >= dp_n:
        spec[b_dim] = _axes(dp)
        seq_data = False
    elif big_dim is not None and shape[big_dim] % dp_n == 0:
        spec[big_dim] = _axes(dp)
        seq_data = True
    else:
        seq_data = False

    if len(shape) == 5:
        if shape[3] % m == 0:
            spec[3] = "model"
        elif shape[4] % m == 0:
            spec[4] = "model"
        elif not seq_data and shape[2] % m == 0:
            spec[2] = "model"
        elif seq_data and shape[2] % (dp_n * m) == 0:
            spec[2] = dp + ("model",)
    elif len(shape) == 4:
        if shape[3] % m == 0:
            spec[3] = "model"
    return tuple(spec)


def cache_pspecs(cache, mesh):
    return _tree_map_with_path(
        lambda path, leaf: _cache_leaf_spec(_path_str(path), tuple(leaf.shape), mesh), cache)


def placements(spec: tuple, mesh) -> list:
    """One spec as DTensor placements, one a mesh dim in mesh order:
    ``Shard(d)`` where tensor dim d names the mesh dim, else
    ``Replicate()``. A tensor dim over several mesh dims is split over
    them in the order they appear in the mesh (JAX's layout)."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for d, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                where[axis] = d
    return [Shard(where[a]) if a in where else Replicate() for a in mesh_sizes(mesh)]


def to_shardings(pspecs, mesh):
    """A tree of specs as a tree of placement lists."""
    if isinstance(pspecs, tuple) and not hasattr(pspecs, "_fields"):
        return placements(pspecs, mesh)
    if isinstance(pspecs, dict):
        return {k: to_shardings(v, mesh) for k, v in pspecs.items()}
    if hasattr(pspecs, "_fields"):
        return type(pspecs)(*(None if v is None else to_shardings(v, mesh)
                              for v in pspecs))
    raise TypeError(f"not a spec tree: {type(pspecs).__name__}")


def client_index(mesh) -> int:
    """This rank's client: its row index over the data axes (the data
    coordinates flattened, pod major)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not in the mesh")
    sizes = mesh_sizes(mesh)
    idx = 0
    for axis, c in zip(sizes, coord):
        if axis in dp_axes(mesh):
            idx = idx * sizes[axis] + int(c)
    return idx


def shard_plane_state(state, mesh):
    """Place a packed ``FedSPDState`` on ``mesh``: every rank holds the same
    global state (as JAX's host-side init before its ``device_put``) and
    keeps its own client's rows, fresh tensors wrapped as DTensors with no
    communication. The global state can then be freed."""
    from torch.distributed.tensor import DTensor

    if not isinstance(state.centers, torch.Tensor):
        raise ValueError("shard_plane_state places the packed (S, N, X) plane")
    n = state.u.shape[0]
    if n != math.prod(mesh_sizes(mesh)[a] for a in dp_axes(mesh)):
        raise ValueError(
            f"the plane has {n} clients; the mesh has "
            f"{math.prod(mesh_sizes(mesh)[a] for a in dp_axes(mesh))} data rows "
            "(one client a row)")
    i = client_index(mesh)
    specs = plane_state_pspecs(state, mesh)

    def put(t, spec, dim):
        return DTensor.from_local(t.narrow(dim, i, 1).clone(), mesh, placements(spec, mesh),
                                  run_check=False)

    return state._replace(
        centers=put(state.centers, specs.centers, 1), u=put(state.u, specs.u, 0),
        z=put(state.z, specs.z, 0), comm_bytes=state.comm_bytes.clone(),
        ef=None if state.ef is None else put(state.ef, specs.ef, 0))


_SHARDED = ("centers", "u", "z", "ef")


def local_state(state):
    """The rank's shards of a placed state (the round's view): each
    DTensor field's local tensor, which shares its storage."""
    from torch.distributed.tensor import DTensor

    return state._replace(**{f: getattr(state, f).to_local()
                             for f in _SHARDED
                             if isinstance(getattr(state, f), DTensor)})


def place_local_state(local, like):
    """``local``'s shards wrapped as DTensors with the placements of the
    placed state ``like``."""
    from torch.distributed.tensor import DTensor

    out = {}
    for f in _SHARDED:
        ref = getattr(like, f)
        if isinstance(ref, DTensor):
            out[f] = DTensor.from_local(getattr(local, f), ref.device_mesh, ref.placements,
                                        run_check=False)
    return local._replace(**out)


def gather_plane_state(state):
    """The global state of a placed one (each DTensor's ``full_tensor()``,
    a collective every rank of the mesh calls)."""
    from torch.distributed.tensor import DTensor

    return state._replace(**{f: getattr(state, f).full_tensor()
                             for f in _SHARDED
                             if isinstance(getattr(state, f), DTensor)})


def _dp_ranks(mesh):
    """The mesh's ranks as a ``(dp_size, model_size)`` table: row j is
    client j's ranks (data axes flattened, pod major), one a model
    coordinate."""
    names = list(mesh.mesh_dim_names)
    order = [names.index(a) for a in dp_axes(mesh)] + [names.index("model")]
    return mesh.mesh.permute(order).reshape(-1, model_size(mesh))


def dp_group(mesh):
    """The process group of the ranks that share this rank's model
    coordinate: the client axis, one client a rank. Two-axis meshes use
    the mesh's own ``"data"`` group; a three-axis mesh's ``(pod, data)``
    axes get one new group a model coordinate (every rank of the default
    group must ask, in the same order)."""
    if len(dp_axes(mesh)) == 1:
        return mesh.get_group("data")
    import torch.distributed as dist

    table = _dp_ranks(mesh)
    groups = [dist.new_group(table[:, j].tolist()) for j in range(table.shape[1])]
    return groups[int(mesh.get_coordinate()[list(mesh.mesh_dim_names).index("model")])]


class ClientGroup:
    """This rank's view of a client axis sharded one client a rank over the
    mesh's data axes: ``index`` its client, ``n_clients`` the axis'
    length, ``gather`` the clients' rows of a small tensor and
    ``all_reduce_`` a sum over them (over ``dp_group``: the model
    replicas of a client reduce apart, so they agree bit for bit)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.index = client_index(mesh)
        self.n_clients = math.prod(mesh_sizes(mesh)[a] for a in dp_axes(mesh))
        self.group = dp_group(mesh)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """``(1, ...)`` on every client -> ``(N, ...)`` in client order."""
        import torch.distributed as dist

        parts = [torch.empty_like(t) for _ in range(self.n_clients)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        dist.all_reduce(t, group=self.group)
        return t
