"""Mesh construction on `torch.distributed` (the port of the JAX
package's `launch/mesh.py`).

A JAX mesh is a grid of devices; a torch `DeviceMesh` is a grid of
*ranks*, one device per rank (`cuda:<local id>` under NCCL, the CPU under
gloo).  Every function here that builds a `DeviceMesh` needs an
initialized default process group (`launch.distributed.initialize`, or
`torch.distributed.init_process_group` directly); importing the module
touches none.  A mesh's device type follows the group's backend: "cuda"
under NCCL, "cpu" otherwise (gloo, or the fake backend a dry run uses).

`make_production_mesh` is a FUNCTION.  Single pod: (data=16, model=16)
over 256 ranks.  Multi-pod: (pod=2, data=16, model=16) over 512 ranks;
the `pod` axis is a second data-parallel axis crossing the slower
inter-pod links (its gradient all-reduce can be int8-compressed,
`optim.grad_compress`).

`abstract_mesh` needs no process group at all: it is what the sharding
rules' legality checks (`sharding.rules.legalize`) read.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A device-less mesh: axis names and sizes only (`.shape` maps each
    axis name to its size, in mesh order, as a JAX mesh's does)."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def abstract_mesh(shape, axes) -> AbstractMesh:
    """Device-less mesh for sharding-spec legality checks."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    return AbstractMesh(axes, shape)


def backend_device_type() -> str:
    """The device type of the default group's collectives: "cuda" under
    NCCL, "cpu" under any other backend."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh_from_devices(ranks, shape, axes):
    """`DeviceMesh` over an explicit list of ranks (elastic re-mesh after
    node loss, or the single-pod 256-of-512 slice), laid out row-major
    into `shape` with `axes` as its dim names."""
    from torch.distributed.device_mesh import DeviceMesh
    grid = torch.tensor(list(ranks), dtype=torch.int64).reshape(tuple(shape))
    return DeviceMesh(backend_device_type(), grid,
                      mesh_dim_names=tuple(axes))


def single_pod_mesh_from(ranks):
    """16x16 (data, model) mesh from the first 256 of the given ranks."""
    return make_mesh_from_devices(list(ranks)[:256], (16, 16),
                                  ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh over every rank of the default group: (16, 16)
    ("data", "model"), or (2, 16, 16) with "pod" leading."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(backend_device_type(), shape,
                            mesh_dim_names=axes)


def mesh_ranks(mesh) -> list[int]:
    """The ranks of a `DeviceMesh`, row-major."""
    return [int(r) for r in mesh.mesh.flatten().tolist()]


def row_mesh(ranks=None, axis: str = "rows"):
    """1-D mesh over `ranks` (default: every rank of the default group)
    for row-sharded batch evaluation: the sweep engine splits its
    flattened (GEMM, config, mapping) row batches over this axis
    (`repro_torch.core.sweep`).  A mesh that holds another rank than this
    one takes the engine's multi-process path (each rank evaluates its
    row shard, the output columns are all-gathered)."""
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    return make_mesh_from_devices(ranks, (len(ranks),), (axis,))


def small_mesh(n_data: int = 1, n_model: int = 1):
    """Tiny (data, model) mesh over the first n_data * n_model ranks."""
    return make_mesh_from_devices(range(n_data * n_model),
                                  (n_data, n_model), ("data", "model"))
