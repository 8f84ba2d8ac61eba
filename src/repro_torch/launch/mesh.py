"""The device mesh on ``torch.distributed``: the JAX package's
``launch/mesh.py`` over a ``DeviceMesh`` of ranks, one GPU a rank.

Axes:
  single-pod : (16, 16)       -> ("data", "model")          256 ranks
  multi-pod  : (2, 16, 16)    -> ("pod", "data", "model")   512 ranks

FedSPD's mapping: one client per data-axis row (16 clients on one pod, 32
across two). The ranks of a row share the client: the port replicates its
model over ``"model"`` (each of the row's ranks computes the same client),
where the JAX package's GSPMD splits the client's forward over that axis.

Building a mesh needs an initialized default process group of at least
the mesh's size (``torchrun`` sets one up; ``dist.init_process_group``
with an explicit ``init_method``, ``world_size`` and ``rank`` elsewhere).
``MeshShape`` stands for a mesh by its axis sizes alone: the sharding
rules (``launch/sharding.py``) read nothing else, so they can be asked
about the production mesh without its 256 ranks.

``use_mesh(mesh)`` names the current mesh (JAX's ``with mesh:``);
``models/attention.decode_attention(axis_name=...)`` resolves its axis
through it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

# --- NVIDIA H100 80GB HBM3 (SXM5) constants, one GPU; nvidia-smi reads the
# card as "NVIDIA H100 80GB HBM3, 700.00 W". The datasheet's figures: ---
PEAK_FLOPS_BF16 = 989e12     # FLOP/s, dense bf16 tensor-core peak
PEAK_FLOPS_FP32 = 67e12      # FLOP/s, fp32 outside the tensor cores
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s a direction (NVLink 4: 900 GB/s both ways)
ICI_BW = NVLINK_BW           # the JAX package's name for the link rate
HBM_BYTES = 85_017_493_504   # torch.cuda.get_device_properties(0).total_memory (79.18 GiB)

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh by its axis sizes: ``shape`` maps each axis name to its size
    in mesh order (as a JAX mesh's ``shape``)."""

    shape: dict

    @staticmethod
    def of(sizes, axes) -> "MeshShape":
        return MeshShape(dict(zip(tuple(axes), (int(v) for v in sizes))))

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)


def mesh_sizes(mesh) -> dict:
    """Axis name -> size, in mesh order, of a ``DeviceMesh`` or a
    ``MeshShape``."""
    if isinstance(mesh, MeshShape):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production mesh over an initialized process group of exactly
    its size, one rank a GPU: ``(16, 16)`` ("data", "model"), or with
    ``multi_pod`` ``(2, 16, 16)`` ("pod", "data", "model")."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    n, world = math.prod(shape), _world()
    if world != n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, one a GPU, in an initialized process "
            f"group; this process has {world or 'none'} — launch each host with "
            f"`torchrun --nnodes {n // 8} --nproc-per-node 8 --rdzv-endpoint "
            f"<host>:<port> -m repro_torch.launch.train --mesh "
            f"{'2pod' if multi_pod else 'pod'} ...` ({n} ranks in all)")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device_type: str = "cuda"):
    """A small mesh over the first ``prod(shape)`` ranks of the process
    group; every rank of the group must call it (the mesh makes its
    per-axis groups collectively). A rank past the mesh gets a mesh whose
    ``get_coordinate()`` is None."""
    n, world = math.prod(shape), _world()
    if world < n:
        raise RuntimeError(f"need {n} ranks, have {world}")
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def dp_axes(mesh) -> tuple:
    """The axes a batch / client dimension shards over."""
    return ("pod", "data") if "pod" in mesh_sizes(mesh) else ("data",)


def dp_size(mesh) -> int:
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))


def model_size(mesh) -> int:
    return int(mesh_sizes(mesh)["model"])


def n_chips(mesh) -> int:
    return math.prod(mesh_sizes(mesh).values())


_CURRENT: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Name ``mesh`` as the current mesh inside the block (JAX's ``with
    mesh:``)."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh():
    """The innermost ``use_mesh`` mesh; raises outside one."""
    if not _CURRENT:
        raise RuntimeError("no current mesh: call this inside `with use_mesh(mesh):`")
    return _CURRENT[-1]
