"""Meshes of the port (port of repro.launch.mesh).

Two kinds:

* a *logical* mesh (``LogicalMesh``): axis names and sizes, nothing else.
  It is all that ``repro_torch.distributed.sharding.logical_to_spec`` and
  the dry-run read, so the production meshes exist without their 256 or
  512 ranks. Single pod: 16 x 16 = 256 ranks ("data", "model"); multi-pod:
  2 x 16 x 16 = 512 ("pod", "data", "model"), "pod" being pure data
  parallelism across pods (its slow links carry only the gradient
  reduction, optionally compressed: ``repro_torch.train.compression``).
* a *process* mesh: a ``torch.distributed.device_mesh.DeviceMesh`` over an
  initialised process group (NCCL on the card, gloo on the CPU), which
  places tensors (DTensor) and carries collectives.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["LogicalMesh", "make_production_mesh", "make_test_mesh",
           "mesh_axis_sizes"]


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """Axis names and sizes of a mesh, major to minor."""

    axis_names: tuple
    axis_sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} sizes")

    @property
    def shape(self) -> dict:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``LogicalMesh`` or a ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """The logical 16 x 16 ("data", "model") mesh, or 2 x 16 x 16
    ("pod", "data", "model") with ``multi_pod``."""
    if multi_pod:
        return LogicalMesh(("pod", "data", "model"), (2, 16, 16))
    return LogicalMesh(("data", "model"), (16, 16))


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default process
    group, which must be initialised with exactly ``prod(shape)`` ranks
    (``device_type`` "cpu" with gloo for the CPU tests). Raises
    ``RuntimeError`` when there is no group and ``ValueError`` when its
    size differs: nothing falls back to a single process."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_test_mesh needs an initialised torch.distributed process "
            "group (init_process_group with a store, rank and world size)")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks; the "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))
