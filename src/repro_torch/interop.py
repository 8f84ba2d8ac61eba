"""Weights and state carried across from the JAX package.

Both functions take numpy arrays (``np.asarray`` of JAX arrays), so the
port never imports JAX. Like every entry point of the port they put the
result on the card unless the caller asks for ``device="cpu"``, and raise
without a card. Layouts are the same in both packages (dense
layers compute ``x @ w + b`` with ``w`` as ``(d_in, d_out)``; planes share
one leaf order), so nothing is transposed or reordered.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fedspd import FedSPDState
from repro_torch.device import make_generator, resolve_device


def params_from_numpy(tree, device: str | torch.device = "cuda") -> dict:
    """A nested dict of numpy arrays -> the same dict of tensors on
    ``device`` (dtype kept)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree), device=device)


def state_from_numpy(state, *, device: str | torch.device = "cuda",
                     gen: torch.Generator | None = None,
                     seed: int = 0) -> FedSPDState:
    """A port ``FedSPDState`` from a JAX ``FedSPDState`` whose fields are
    numpy arrays and whose ``centers`` is the packed ``(S, N, X)`` plane.
    The plane, ``u``, ``z``, ``round`` and ``comm_bytes`` carry over; the
    key is replaced by ``gen`` (default: a generator seeded with
    ``seed``)."""
    centers = np.array(state.centers)
    if centers.ndim != 3:
        raise ValueError(
            f"centers must be the packed (S, N, X) plane, got shape "
            f"{centers.shape}")
    device = resolve_device(device)
    return FedSPDState(
        centers=torch.as_tensor(centers, dtype=torch.float32, device=device),
        u=torch.as_tensor(np.array(state.u), dtype=torch.float32, device=device),
        z=torch.as_tensor(np.array(state.z), dtype=torch.int64, device=device),
        round=int(np.asarray(state.round)),
        gen=gen if gen is not None else make_generator(device, seed),
        comm_bytes=torch.as_tensor(np.array(state.comm_bytes),
                                   dtype=torch.float32, device=device),
    )
