"""Export: a finished FedSPD run -> a servable cluster-plane artifact.

The run owns N·S cluster-center copies (consensus makes the N copies of
each cluster agree); the server needs the S consensus models as one
``(S, X)`` plane and the trained ``(N, S)`` mixture table.
``cluster_plane`` lifts the first from a final state's packed plane,
``export_servable`` ships it in a serve/artifact.py format, and
``export_run`` does both from a RunResult of a run driven with
``RunConfig(options={"keep_state": True})``, which leaves the final state
and its PackSpec in ``extras``.
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint.ckpt import CkptManifest
from repro_torch.core.packing import PackSpec
from repro_torch.serve.artifact import save_servable


def cluster_plane(state) -> torch.Tensor:
    """``(S, X)`` consensus cluster plane of a final FedSPD state: the mean
    over the client axis of each cluster's N center copies. The port's
    state always holds the packed ``(S, N, X)`` plane. The copies are
    summed in client order and the sum multiplied by the fp32 reciprocal
    of N, as the JAX package's compiled mean does, so both packages write
    the same artifact bytes from the same state."""
    centers = state.centers
    if not (isinstance(centers, torch.Tensor) and centers.dim() == 3):
        raise ValueError(
            "cluster_plane takes the packed (S, N, X) centers plane; the "
            "pytree engine (param_plane=False) is not ported")
    total = centers[:, 0].float().clone()
    for i in range(1, centers.shape[1]):
        total += centers[:, i]
    return total * torch.tensor(1.0 / centers.shape[1], dtype=torch.float32,
                                device=centers.device)


def export_servable(state, spec: PackSpec, path: str, *, arch: str,
                    codec: str = "fp32", qblock: int = 64) -> CkptManifest:
    """Ship a final FedSPD state as a servable artifact: the consensus
    plane in ``codec`` form and the trained ``(N, S)`` mixture table."""
    return save_servable(path, cluster_plane(state), spec, arch=arch,
                         u=state.u, codec=codec, qblock=qblock)


def export_run(result, path: str, *, arch: str = "mlp", codec: str = "fp32",
               qblock: int = 64) -> CkptManifest:
    """Export straight from a RunResult of a run driven with
    ``RunConfig(options={"keep_state": True})``."""
    if "state" not in result.extras:
        raise ValueError(
            "RunResult has no final state; run with "
            'RunConfig(options={"keep_state": True}) to export')
    return export_servable(result.extras["state"], result.extras["pack_spec"],
                           path, arch=arch, codec=codec, qblock=qblock)
