"""Device meshes: the port's ``repro.launch.mesh``.

A mesh is a ``torch.distributed.DeviceMesh`` over the ranks of the
default process group, its dims named as the reference's mesh axes.  The
caller brings the process group up first (``init_process_group``: NCCL
for CUDA, gloo for the CPU; ``launch/train.py`` does it under
``torchrun``).  Importing this module touches no device and no process
group: ``make_production_mesh`` and ``make_mesh`` are functions.

Single pod: 16x16 = 256 ranks; multi-pod: 2 pods = 512 ranks with the
``pod`` axis outermost (only data-parallel gradient reduction crosses
it).
"""

from __future__ import annotations

import math


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device_type: str = "cuda"):
    """A mesh of ``shape`` over the default process group's ranks, its
    dims named ``axes`` (tests, examples, elastic re-meshes)."""
    from torch.distributed.device_mesh import init_device_mesh
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "rank")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def use_mesh(mesh):
    """Context manager activating ``mesh``: the ``DeviceMesh``'s own,
    whose block makes it the mesh DTensor's functions take when given
    none, as the reference's ``use_mesh`` activates a JAX mesh."""
    return mesh


def mesh_sizes(mesh) -> dict[str, int]:
    """Mesh axis name -> its size."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def pod_size(mesh) -> int:
    """Ranks per pod: the product of the sizes of every axis but
    ``pod``."""
    return math.prod(s for name, s in mesh_sizes(mesh).items()
                     if name != "pod")
