"""Export: a finished FedSPD run -> a servable cluster-plane artifact.

The run owns N·S cluster-center copies (consensus makes the N copies of
each cluster agree); the server needs the S consensus models as one
``(S, X)`` plane and the trained ``(N, S)`` mixture table.
``cluster_plane`` lifts the first from a final state (the packed plane,
or the pytree engine's leaves packed through a spec),
``export_servable`` ships it in a serve/artifact.py format, and
``export_run`` does both from a RunResult of a run driven with
``RunConfig(options={"keep_state": True})``, which leaves the final state
and its PackSpec (None on the pytree engine) in ``extras``.
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint.ckpt import CkptManifest
from repro_torch.core.packing import PackSpec, make_pack_spec, pack
from repro_torch.serve.artifact import save_servable
from repro_torch.utils.pytree import tree_map


def cluster_plane(state, spec: PackSpec | None = None) -> torch.Tensor:
    """``(S, X)`` consensus cluster plane of a final FedSPD state: the mean
    over the client axis of each cluster's N center copies. Takes a packed
    ``(S, N, X)`` ``centers`` plane, or the pytree engine's ``(S, N,
    ...)`` leaves, packed through ``spec`` first. The copies are summed in
    client order and the sum multiplied by the fp32 reciprocal of N, as
    the JAX package's compiled mean does, so both packages write the same
    artifact bytes from the same state."""
    centers = state.centers
    if not isinstance(centers, torch.Tensor):
        if spec is None:
            raise ValueError("a state of the pytree engine needs spec= to pack its centers")
        centers = pack(centers, spec)
    if centers.dim() != 3:
        raise ValueError(
            f"cluster_plane takes (S, N, X) centers, got shape {tuple(centers.shape)}")
    total = centers[:, 0].float().clone()
    for i in range(1, centers.shape[1]):
        total += centers[:, i]
    return total * torch.tensor(1.0 / centers.shape[1], dtype=torch.float32,
                                device=centers.device)


def export_servable(state, spec: PackSpec, path: str, *, arch: str,
                    codec: str = "fp32", qblock: int = 64) -> CkptManifest:
    """Ship a final FedSPD state as a servable artifact: the consensus
    plane in ``codec`` form and the trained ``(N, S)`` mixture table."""
    return save_servable(path, cluster_plane(state, spec), spec, arch=arch,
                         u=state.u, codec=codec, qblock=qblock)


def export_run(result, path: str, *, arch: str = "mlp", codec: str = "fp32",
               qblock: int = 64) -> CkptManifest:
    """Export straight from a RunResult of a run driven with
    ``RunConfig(options={"keep_state": True})``. A pytree-engine run has
    no PackSpec: the layout is derived from the centers' leaves (the
    first cluster's first client copy)."""
    if "state" not in result.extras:
        raise ValueError(
            "RunResult has no final state; run with "
            'RunConfig(options={"keep_state": True}) to export')
    state, spec = result.extras["state"], result.extras.get("pack_spec")
    if spec is None:
        spec = make_pack_spec(tree_map(lambda leaf: leaf[0, 0], state.centers))
    return export_servable(state, spec, path, arch=arch, codec=codec, qblock=qblock)
