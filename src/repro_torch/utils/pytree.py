"""Pytree helpers: the linear-algebra view of a model as a nested dict of
tensors (the paper's C_s in R^{N x X}, one leaf at a time).

A tree is a nested dict whose leaves are tensors; a bare tensor is a
one-leaf tree. Leaves are walked in the order of ``core/packing.py``'s
``_flatten`` — keys sorted at every level, as ``jax.tree.flatten`` orders
a dict — so a reduction over leaves adds them in the JAX package's order,
and a tree built here has its keys in that order. The pytree engine
(``RunConfig(param_plane=False)``) keeps its states in this form: FedSPD's
centers as ``(S, N, ...)`` leaves, a baseline's client models as ``(N,
...)`` leaves.
"""
from __future__ import annotations

from typing import Callable

import torch


def tree_leaves(tree) -> list:
    """The leaves in sorted-key order (a bare tensor is its own leaf)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(f: Callable, *trees):
    """``f`` on the leaves of ``trees`` (of one structure, the first's),
    leaf by leaf in sorted-key order; returns a tree of that structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(f, *(t[k] for t in trees)) for k in sorted(first)}
    return f(*trees)


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(tree, alpha):
    return tree_map(lambda x: x * alpha, tree)


def tree_axpy(alpha, x, y):
    """alpha * x + y."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_weighted_sum(trees, weights: torch.Tensor):
    """Σ_k weights[k] · leaf[k] over the leading axis of every leaf (leaves
    ``(K, ...)``, weights ``(K,)`` cast to the leaf's dtype): Eq. (2)'s
    x_i = Σ_s u_{i,s} c_{i,s} for one client. Weights ``(K, *B)`` weight
    leaves ``(K, *B, ...)`` batch by batch (every client at once: ``u.T``
    over ``(S, N, ...)`` centers, as the JAX package's ``vmap`` of it)."""
    def one(leaf):
        w = weights.to(leaf.dtype)
        return (w.reshape(w.shape + (1,) * (leaf.dim() - w.dim())) * leaf).sum(dim=0)

    return tree_map(one, trees)


def tree_vdot(a, b) -> torch.Tensor:
    """The fp32 dot product of two trees: per-leaf dots added in leaf
    order, as the JAX package reduces them."""
    total = None
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        d = torch.dot(x.float().reshape(-1), y.float().reshape(-1))
        total = d if total is None else total + d
    return total


def tree_sq_norm(tree) -> torch.Tensor:
    return tree_vdot(tree, tree)


def tree_norm(tree) -> torch.Tensor:
    return torch.sqrt(tree_sq_norm(tree))


def tree_cosine_similarity(a, b, eps: float = 1e-12) -> torch.Tensor:
    """Cosine similarity of two parameter trees (their flattened view), the
    paper's label-switching test (§6, "Client communications")."""
    return tree_vdot(a, b) / (tree_norm(a) * tree_norm(b) + eps)


def tree_size(tree) -> int:
    """The number of scalars, a host int."""
    return int(sum(leaf.numel() for leaf in tree_leaves(tree)))


def tree_bytes(tree) -> int:
    """The bytes of the leaves in their own dtypes, a host int."""
    return int(sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(tree)))


def tree_ravel(tree) -> torch.Tensor:
    """One fp32 vector of every leaf, flattened, in leaf order."""
    return torch.cat([leaf.float().reshape(-1) for leaf in tree_leaves(tree)])


def tree_cast(tree, dtype: torch.dtype):
    """Floating leaves cast to ``dtype``; the others as they are."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def tree_stack(trees: list):
    """A list of trees of one structure stacked on a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


def tree_index(tree, idx):
    """The leading axis of every leaf indexed by ``idx``."""
    return tree_map(lambda x: x[idx], tree)


# ``idx`` may be a device tensor (0-d: one row without the axis; 1-d: the
# rows): indexing reads nothing on the host, so one function serves both
tree_dynamic_index = tree_index


def tree_dynamic_update(tree, idx: torch.Tensor, value):
    """A new tree with ``value`` written at ``idx`` of every leaf's leading
    axis (cast to the leaf's dtype); ``tree`` is not changed."""
    def put(x, v):
        out = x.clone()
        out[idx] = v.to(x.dtype)
        return out

    return tree_map(put, tree, value)


def tree_gather_rows(tree, s: torch.Tensor):
    """Client i's row ``s[i]`` of every ``(S, N, ...)`` leaf: a tree of
    ``(N, ...)`` leaves, advanced-index copies (the packed ``(S, N, X)``
    plane is one leaf)."""
    rows = torch.arange(s.shape[0], device=s.device)
    return tree_map(lambda leaf: leaf[s, rows], tree)


def tree_scatter_rows_(tree, s: torch.Tensor, value) -> None:
    """Write ``value``'s ``(N, ...)`` rows into client i's row ``s[i]`` of
    every ``(S, N, ...)`` leaf of ``tree``, in place, cast to the leaf's
    dtype."""
    rows = torch.arange(s.shape[0], device=s.device)
    for leaf, v in zip(tree_leaves(tree), tree_leaves(value)):
        leaf[s, rows] = v.to(leaf.dtype)


def tree_grad(loss_fn: Callable, tree, batch: dict):
    """d Σ loss / d leaves: ``loss_fn(tree, batch)`` returns one loss per
    batch row (``(N,)`` for N clients' leaves ``(N, ...)``); each row's
    loss depends on its own parameters only, so the gradient of the sum
    is every row's own gradient (the JAX package's per-client
    ``vmap(grad)``). Returns a new tree of the leaves' shapes."""
    params = tree_map(lambda leaf: leaf.detach().requires_grad_(True), tree)
    leaves = tree_leaves(params)
    grads = iter(torch.autograd.grad(loss_fn(params, batch).sum(), leaves))
    return tree_map(lambda _: next(grads), params)


def global_shape_summary(tree) -> dict:
    """The host's structural summary of a tree."""
    return {"num_params": tree_size(tree), "num_bytes": tree_bytes(tree),
            "num_leaves": len(tree_leaves(tree))}


def state_tensors(state) -> list:
    """Every tensor of a run's state, in field and leaf order: a bare
    tensor, the fields of a NamedTuple, the leaves of a tree (the pytree
    engine's states); other values (a round count, a generator, None)
    are skipped."""
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, dict):
        return [t for leaf in tree_leaves(state) for t in state_tensors(leaf)]
    if isinstance(state, tuple):
        return [t for v in state for t in state_tensors(v)]
    return []
