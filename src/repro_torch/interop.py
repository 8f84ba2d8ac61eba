"""Weights and state carried across from the JAX package.

Every function takes numpy arrays (``np.asarray`` of JAX arrays), so the
port never imports JAX. Like every entry point of the port they put the
result on the card unless the caller asks for ``device="cpu"``, and raise
without a card. Layouts are the same in both packages (dense
layers compute ``x @ w + b`` with ``w`` as ``(d_in, d_out)``; planes share
one leaf order), so nothing is transposed or reordered.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.baselines.fedem import FedEMState
from repro_torch.baselines.fedsoft import FedSoftState
from repro_torch.baselines.ifca import IFCAState
from repro_torch.baselines.pfedme import PFedMeState
from repro_torch.comm.codecs import WithEF
from repro_torch.core.fedspd import FedSPDState
from repro_torch.device import make_generator, resolve_device


def params_from_numpy(tree, device: str | torch.device = "cuda") -> dict:
    """A nested dict of numpy arrays -> the same dict of tensors on
    ``device`` (dtype kept). It carries a JAX ``bundle.init`` tree of the
    LM zoo as it is: stacked ``(L, ...)`` layer leaves, and olmo's empty
    norm dicts as empty dicts (they pack to no leaves)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree), device=device)


def state_from_numpy(state, *, device: str | torch.device = "cuda",
                     gen: torch.Generator | None = None,
                     seed: int = 0) -> FedSPDState:
    """A port ``FedSPDState`` from a JAX ``FedSPDState`` whose fields are
    numpy arrays: ``centers`` the packed ``(S, N, X)`` plane, or the
    pytree engine's nested dict of ``(S, N, ...)`` leaves (fp32 tensors
    of the same keys). The centers, ``u``, ``z``, ``round``,
    ``comm_bytes`` and, where the state has them, the error-feedback
    residual ``ef`` and the sparse masks ``mask`` carry over; the key is
    replaced by ``gen`` (default: a generator seeded with ``seed``)."""
    device = resolve_device(device)
    if isinstance(state.centers, dict):
        centers = _tree(state.centers, device)
    else:
        centers = np.array(state.centers)
        if centers.ndim != 3:
            raise ValueError(
                f"centers must be the packed (S, N, X) plane, got shape "
                f"{centers.shape}")
        centers = torch.as_tensor(centers, dtype=torch.float32, device=device)
    return FedSPDState(
        centers=centers,
        u=torch.as_tensor(np.array(state.u), dtype=torch.float32, device=device),
        z=torch.as_tensor(np.array(state.z), dtype=torch.int64, device=device),
        round=int(np.asarray(state.round)),
        gen=gen if gen is not None else make_generator(device, seed),
        comm_bytes=torch.as_tensor(np.array(state.comm_bytes),
                                   dtype=torch.float32, device=device),
        ef=_optional_plane(getattr(state, "ef", None), device),
        mask=_optional_plane(getattr(state, "mask", None), device),
    )


def _optional_plane(a, device: torch.device) -> torch.Tensor | None:
    if a is None:
        return None
    return torch.as_tensor(np.array(a), dtype=torch.float32, device=device)


# the JAX package's baseline states, by class name, and their port twins
_BASELINE_STATES = {cls.__name__: cls for cls in
                    (FedEMState, IFCAState, FedSoftState, PFedMeState)}


def _as_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)
    dtype = torch.int64 if np.issubdtype(a.dtype, np.integer) else torch.float32
    return torch.as_tensor(a, dtype=dtype, device=device)


def _tree(a, device: torch.device):
    """A nested dict of arrays as the same dict of tensors (integer leaves
    int64, the rest fp32); an array as one tensor."""
    if isinstance(a, dict):
        return {k: _tree(v, device) for k, v in a.items()}
    return _as_tensor(a, device)


def _bare_plane(a, device: torch.device):
    if isinstance(a, dict):
        return _tree(a, device)   # a pytree-engine state: the (N, ...) leaves
    plane = _as_tensor(a, device)
    if plane.dim() != 2:
        raise ValueError(
            f"a bare state must be the packed (N, X) plane, got shape "
            f"{tuple(plane.shape)}")
    return plane


def _check_residual(ef: torch.Tensor | None, plane: torch.Tensor) -> None:
    """The residual covers what crosses the wire: a plane of the
    exchanged models' shape."""
    if ef is not None and ef.shape != plane.shape:
        raise ValueError(
            f"the error-feedback residual ef {tuple(ef.shape)} does not match "
            f"the exchanged plane {tuple(plane.shape)}")


def baseline_state_from_numpy(state, *, device: str | torch.device = "cuda"):
    """A port baseline state from a JAX one whose fields are numpy arrays,
    on the packed plane or the pytree engine: a bare ``(N, X)`` plane
    (FedAvg, Local) becomes one fp32 tensor, a bare tree of ``(N, ...)``
    leaves the same dict of tensors, FedAvg's ``WithEF(x, ef)`` the port's
    ``WithEF``; a ``FedEMState``, ``IFCAState``, ``FedSoftState`` or
    ``PFedMeState`` becomes the port's state of that name (integer fields
    int64, the rest fp32; a field holding a tree, the same dict of
    tensors). An error-feedback residual ``ef`` (a wire codec's, on the
    plane only) carries over when it has the exchanged plane's shape:
    FedEM's ``(S, N, X)`` centers, FedSoft's y, pFedMe's w, IFCA's chosen
    ``(N, X)`` slab."""
    device = resolve_device(device)
    if not isinstance(state, tuple):
        return _bare_plane(state, device)
    if type(state).__name__ == "WithEF":
        out = WithEF(_bare_plane(state.x, device), _as_tensor(state.ef, device))
        _check_residual(out.ef, out.x)
        return out
    cls = _BASELINE_STATES.get(type(state).__name__)
    if cls is None:
        raise ValueError(
            f"no port baseline state for {type(state).__name__}; the port "
            f"has {sorted(_BASELINE_STATES)} and WithEF")
    out = cls(**{f: None if getattr(state, f, None) is None
                 else _tree(getattr(state, f), device) for f in cls._fields})
    if isinstance(getattr(out, "centers", None), dict) or isinstance(
            getattr(out, "w", None), dict):
        if out.ef is not None:
            raise ValueError("a pytree-engine state carries no error-feedback residual ef")
        return out
    if hasattr(out, "centers") and out.centers.dim() != 3:
        raise ValueError(
            f"centers must be the packed (S, N, X) plane, got shape "
            f"{tuple(out.centers.shape)}")
    sent = {"FedEMState": "centers", "FedSoftState": "y",
            "PFedMeState": "w"}.get(cls.__name__)
    _check_residual(out.ef, getattr(out, sent) if sent else out.centers[0])
    return out
