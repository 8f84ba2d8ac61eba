"""Paper-scale client classifiers: the MLP, the conv1d net (the paper's
2-conv CNN analogue, Appendix B.1.1) and the linear head.

Every forward is batched over any leading axes shared by the parameters
and the inputs: one client's ``(d_in, d_out)`` weights with ``(B, d)``
inputs, N clients' ``(N, d_in, d_out)`` with ``(N, B, d)`` (one
``torch.matmul`` per layer, a batched product), or S×N centers'
``(S, N, d_in, d_out)`` with ``(N, M, d)`` (broadcast over S).

The conv net's convolutions run the same way: the input's 5-wide windows
are unfolded into ``(*B, M·d, 5·C_in)`` rows and multiplied by the kernel
reshaped to ``(*W, 5·C_in, C_out)``, one broadcast ``torch.matmul``. A
grouped ``conv1d`` would need one group per (cluster, client) pair, so
the input broadcast over S materialized and every batching reshaped
apart; the unfold keeps one code path for all of them, the MLP's.
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


def init_conv1d_classifier(gen: torch.Generator, dim: int, n_classes: int,
                           channels: int = 16) -> dict:
    """Two conv stages (5-wide kernels ``(5, C_in, C_out)``, no bias), each
    followed by ReLU and a 2-wide max pool, then ``fc1`` ``(dim//4 ·
    channels, 50)`` and ``fc2`` ``(50, n_classes)``."""
    def normal(shape):
        return torch.randn(shape, generator=gen, device=gen.device) * 0.2

    return {
        "conv1": normal((5, 1, channels)),
        "conv2": normal((5, channels, channels)),
        "fc1": {"w": dense_init(gen, (dim // 4) * channels, 50),
                "b": torch.zeros((50,), device=gen.device)},
        "fc2": {"w": dense_init(gen, 50, n_classes),
                "b": torch.zeros((n_classes,), device=gen.device)},
    }


def _conv_same(h: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """A stride-1 SAME convolution over the signal axis: h ``(*B, M, d,
    C_in)``, k ``(*W, K, C_in, C_out)`` -> ``(*B∨W, M, d, C_out)``."""
    width, c_in, c_out = k.shape[-3:]
    lead = (width - 1) // 2
    h = torch.nn.functional.pad(h, (0, 0, lead, width - 1 - lead))
    # (*B, M, d, C_in, K) windows -> rows (*B, M·d, C_in·K)
    win = h.unfold(-2, width, 1)
    m, d = win.shape[-4], win.shape[-3]
    rows = win.reshape(win.shape[:-4] + (m * d, c_in * width))
    kmat = k.transpose(-3, -2).reshape(k.shape[:-3] + (c_in * width, c_out))
    out = torch.matmul(rows, kmat)
    return out.reshape(out.shape[:-2] + (m, d, c_out))


def _pool2(h: torch.Tensor) -> torch.Tensor:
    """A 2-wide, stride-2 VALID max pool over the signal axis of ``(*B, M,
    d, C)``."""
    d = h.shape[-2] // 2 * 2
    h = h[..., :d, :]
    return h.reshape(h.shape[:-2] + (d // 2, 2, h.shape[-1])).amax(dim=-2)


def apply_conv1d_classifier(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = x.unsqueeze(-1)   # (*B, M, d, 1): the features as a 1-D signal
    for name in ("conv1", "conv2"):
        h = _pool2(torch.relu(_conv_same(h, params[name])))
    h = h.flatten(-2)      # (*B, M, d//4 · C), position-major as JAX's
    h = torch.relu(_affine(h, params["fc1"]))
    return _affine(h, params["fc2"])


def init_linear_classifier(gen: torch.Generator, dim: int,
                           n_classes: int) -> dict:
    w = torch.randn((dim, n_classes), generator=gen, device=gen.device)
    return {"w": w / math.sqrt(dim),
            "b": torch.zeros((n_classes,), device=gen.device)}


def apply_linear_classifier(params: dict, x: torch.Tensor) -> torch.Tensor:
    return _affine(x, params)


_MODELS = {
    "mlp": (init_mlp_classifier, apply_mlp_classifier),
    "conv": (init_conv1d_classifier, apply_conv1d_classifier),
    "linear": (init_linear_classifier, apply_linear_classifier),
}


def make_classifier(kind: str, gen: torch.Generator, dim: int,
                    n_classes: int):
    """Returns (params, apply, loss, per_example_loss, accuracy). ``loss``
    and ``accuracy`` average over the example axis only, so a batched call
    returns one value per client: ``(N,)`` for ``(N, B, d)`` inputs."""
    if kind not in _MODELS:
        raise ValueError(f"unknown model {kind!r}; the port has {sorted(_MODELS)}")
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
