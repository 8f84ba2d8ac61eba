"""Packed parameter plane: a model's parameters as one flat X axis.

``PackSpec`` fixes, once per model, where each leaf lives on the X axis.
Leaves are ordered as ``jax.tree.flatten`` orders a nested dict — keys
sorted at every level — so a layer's ``b`` comes before its ``w`` and a
plane packed by the JAX package is a plane of the port, float for float.

    plane = pack(tree, spec)    # leaves (*B, *shape) -> (*B, X) fp32
    tree  = unpack(plane, spec) # (*B, X) -> leaves (*B, *shape), VIEWS

``unpack`` copies nothing: each leaf is a view of its slice of the plane,
so writing into a leaf writes the plane, and autograd through a leaf
reaches only that slice.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math

import torch

from repro_torch.utils.pytree import (
    tree_grad,
    tree_leaves,
    tree_map,
    tree_stack,
    tree_weighted_sum,
)


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Static layout of one model on the X axis."""

    paths: tuple    # per-leaf key paths, e.g. (("layer0", "b"), ...)
    shapes: tuple   # per-leaf model-dim shapes
    dtypes: tuple   # per-leaf original dtypes
    sizes: tuple    # per-leaf flat sizes
    offsets: tuple  # per-leaf start on the X axis
    size: int       # X

    @property
    def model_bytes(self) -> int:
        """Bytes of one model in its ORIGINAL dtypes: what crosses the
        wire, whatever the plane's compute dtype."""
        return int(sum(s * torch.empty((), dtype=d).element_size()
                       for s, d in zip(self.sizes, self.dtypes)))

    @property
    def digest(self) -> str:
        """Content hash of the layout, the JAX package's ``PackSpec.digest``
        string for the same model: a servable artifact records it so that
        a server refuses to unpack a plane through another architecture's
        layout. Each leaf hashes as ``"{shape}:{dtype}"`` with the shape
        printed as a Python tuple and the dtype by its numpy name."""
        parts = [
            ";".join(f"{tuple(s)}:{_numpy_name(d)}"
                     for s, d in zip(self.shapes, self.dtypes)),
            ",".join(map(str, self.sizes)),
            ",".join(map(str, self.offsets)),
            str(self.size),
        ]
        return hashlib.sha1("|".join(parts).encode()).hexdigest()[:16]


def _numpy_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype: ``torch.float32`` -> ``"float32"``."""
    return str(dtype).removeprefix("torch.")


def _flatten(tree: dict, prefix: tuple = ()) -> list:
    """(path, leaf) pairs with dict keys sorted at every level."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(_flatten(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def make_pack_spec(example: dict) -> PackSpec:
    """The layout of one (unbatched) model's parameter dict."""
    flat = _flatten(example)
    shapes = tuple(tuple(leaf.shape) for _, leaf in flat)
    sizes = tuple(math.prod(s) for s in shapes)
    offsets = tuple(sum(sizes[:i]) for i in range(len(sizes)))
    return PackSpec(
        paths=tuple(p for p, _ in flat), shapes=shapes,
        dtypes=tuple(leaf.dtype for _, leaf in flat), sizes=sizes,
        offsets=offsets, size=sum(sizes),
    )


def pack(tree: dict, spec: PackSpec) -> torch.Tensor:
    """Leaves ``(*B, *shape)`` -> one new ``(*B, X)`` fp32 tensor."""
    flat = _flatten(tree)
    if tuple(p for p, _ in flat) != spec.paths:
        raise ValueError(
            f"tree paths {[p for p, _ in flat]} != spec {list(spec.paths)}")
    parts = []
    for (_, leaf), shape, size in zip(flat, spec.shapes, spec.sizes):
        bnd = leaf.dim() - len(shape)
        if bnd < 0 or tuple(leaf.shape[bnd:]) != shape:
            raise ValueError(
                f"leaf shape {tuple(leaf.shape)} does not end with packed "
                f"shape {shape}")
        parts.append(leaf.reshape(leaf.shape[:bnd] + (size,)).float())
    return torch.cat(parts, dim=-1)


def unpack(plane: torch.Tensor, spec: PackSpec) -> dict:
    """``(*B, X)`` -> nested dict of leaves ``(*B, *shape)``, each a view
    of its slice of ``plane`` (a copy only for a leaf whose original dtype
    is not fp32)."""
    if plane.shape[-1] != spec.size:
        raise ValueError(f"plane width {plane.shape[-1]} != spec X {spec.size}")
    batch = tuple(plane.shape[:-1])
    tree: dict = {}
    for path, o, sz, shape, dt in zip(spec.paths, spec.offsets, spec.sizes,
                                      spec.shapes, spec.dtypes):
        leaf = plane[..., o:o + sz].view(batch + shape)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf if leaf.dtype == dt else leaf.to(dt)
    return tree


def maybe_unpack(plane, spec: PackSpec | None):
    """``unpack(plane, spec)``, or ``plane`` itself when ``spec`` is None:
    a state of the pytree engine already holds its parameter dict."""
    return plane if spec is None else unpack(plane, spec)


def stack_models(models: list, spec: PackSpec | None, lead: tuple):
    """Parameter dicts stacked as ``(*lead, X)``, packed through ``spec``,
    or (``spec=None``, the pytree engine) as a tree of ``(*lead, ...)``
    leaves."""
    if spec is None:
        return tree_map(lambda leaf: leaf.reshape(tuple(lead) + leaf.shape[1:]),
                        tree_stack(models))
    return torch.stack([pack(m, spec) for m in models]).view(tuple(lead) + (spec.size,))


def grad(loss_fn, params, batch: dict, spec: PackSpec | None):
    """d Σ loss / d params in the run's representation: ``flat_grad`` of
    a packed slab through ``spec``, ``tree_grad`` of a tree with
    ``spec=None``."""
    if spec is None:
        return tree_grad(loss_fn, params, batch)
    return flat_grad(loss_fn, params, batch, spec)


def mixture(centers, u: torch.Tensor):
    """Eq. (2) for every client, x_i = Σ_s u_{i,s} c_{i,s}: one
    contraction over an ``(S, N, X)`` plane, or Σ_s over every ``(S, N,
    ...)`` leaf of the pytree engine's tree."""
    if isinstance(centers, torch.Tensor):
        return torch.einsum("ns,snx->nx", u.to(centers.dtype), centers)
    return tree_weighted_sum(centers, u.T)


def flat_grad(loss_fn, vec: torch.Tensor, batch: dict,
              spec: PackSpec) -> torch.Tensor:
    """d Σ loss / d vec for a ``(*B, X)`` slab, as one new ``(*B, X)``
    tensor. ``loss_fn(params, batch)`` returns one loss per batch row
    (``(N,)`` for N clients); each row's loss depends on its own
    parameters only, so the gradient of the sum is every row's own
    gradient.

    Autograd runs to the unpacked leaves, not to the slab: the backward of
    a slice is a full-width zero pad, so differentiating through the
    views would build one ``(*B, X)`` buffer per leaf. Each leaf's
    gradient is written once into its slice of the output instead: no
    padding and no concatenation."""
    tree = unpack(vec.detach(), spec)
    params = tree_leaves(tree)
    for leaf in params:
        leaf.requires_grad_(True)
    grads = torch.autograd.grad(loss_fn(tree, batch).sum(), params)
    out = torch.empty_like(vec)
    for view, g in zip(tree_leaves(unpack(out, spec)), grads):
        view.copy_(g)
    return out
