"""Paper-scale client classifiers: the MLP and the linear head.

Every forward is batched over any leading axes shared by the parameters
and the inputs: one client's ``(d_in, d_out)`` weights with ``(B, d)``
inputs, N clients' ``(N, d_in, d_out)`` with ``(N, B, d)`` (one
``torch.matmul`` per layer, a batched product), or S×N centers'
``(S, N, d_in, d_out)`` with ``(N, M, d)`` (broadcast over S).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import dense_init, softmax_xent


def init_mlp_classifier(gen: torch.Generator, dim: int, n_classes: int,
                        hidden: tuple = (128, 64)) -> dict:
    sizes = (dim,) + tuple(hidden) + (n_classes,)
    return {
        f"layer{i}": {
            "w": dense_init(gen, sizes[i], sizes[i + 1]),
            "b": torch.zeros((sizes[i + 1],), device=gen.device),
        }
        for i in range(len(sizes) - 1)
    }


def _affine(h: torch.Tensor, p: dict) -> torch.Tensor:
    # b (*batch, d_out) -> (*batch, 1, d_out): one row per example
    return torch.matmul(h, p["w"]) + p["b"].unsqueeze(-2)


def apply_mlp_classifier(params: dict, x: torch.Tensor) -> torch.Tensor:
    n = len(params)
    h = x
    for i in range(n):
        h = _affine(h, params[f"layer{i}"])
        if i < n - 1:
            h = torch.relu(h)
    return h


def init_linear_classifier(gen: torch.Generator, dim: int,
                           n_classes: int) -> dict:
    w = torch.randn((dim, n_classes), generator=gen, device=gen.device)
    return {"w": w / math.sqrt(dim),
            "b": torch.zeros((n_classes,), device=gen.device)}


def apply_linear_classifier(params: dict, x: torch.Tensor) -> torch.Tensor:
    return _affine(x, params)


_MODELS = {
    "mlp": (init_mlp_classifier, apply_mlp_classifier),
    "linear": (init_linear_classifier, apply_linear_classifier),
}


def make_classifier(kind: str, gen: torch.Generator, dim: int,
                    n_classes: int):
    """Returns (params, apply, loss, per_example_loss, accuracy). ``loss``
    and ``accuracy`` average over the example axis only, so a batched call
    returns one value per client: ``(N,)`` for ``(N, B, d)`` inputs."""
    if kind not in _MODELS:
        raise ValueError(
            f"model {kind!r} is not ported yet; the port has {sorted(_MODELS)}"
        )
    init, apply = _MODELS[kind]
    params = init(gen, dim, n_classes)

    def per_example_loss(p, batch):
        return softmax_xent(apply(p, batch["x"]), batch["y"])

    def loss(p, batch):
        return per_example_loss(p, batch).mean(dim=-1)

    def accuracy(p, batch):
        pred = apply(p, batch["x"]).argmax(dim=-1)
        return (pred == batch["y"]).float().mean(dim=-1)

    return params, apply, loss, per_example_loss, accuracy
