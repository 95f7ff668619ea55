"""Device meshes: the port's ``repro.launch.mesh``.

A mesh is a ``torch.distributed.DeviceMesh`` over the ranks of the
default process group, its dims named as the reference's mesh axes.  The
caller brings the process group up first (``init_process_group``: NCCL
for CUDA, gloo for the CPU; ``launch/train.py`` does it under
``torchrun``).  Importing this module touches no device and no process
group: ``make_production_mesh`` and ``make_mesh`` are functions.

Single pod: 16x16 = 256 ranks; multi-pod: 2 pods = 512 ranks with the
``pod`` axis outermost (only data-parallel gradient reduction crosses
it).  ``count_mesh`` builds such a mesh on one process for the dry-run,
over a fake process group.
"""

from __future__ import annotations

import contextlib
import itertools
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


PRODUCTION_MESHES = {"single": ((16, 16), ("data", "model")),
                     "multi": ((2, 16, 16), ("pod", "data", "model"))}


@contextlib.contextmanager
def count_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """``with count_mesh((16, 16), ("data", "model")) as mesh:`` a
    ``DeviceMesh`` of device type "cuda" over a fake process group of
    ``prod(shape)`` ranks, this process being rank 0, for counting what
    one rank of a real mesh runs (``hw.cost.CostCounter`` on meta
    tensors): DTensor makes the card's choices on a "cuda" mesh (an
    all-to-all where a CPU mesh falls back to all-gather and chunk), and
    the fake group moves nothing.  The mesh is built with ``DeviceMesh``
    directly: ``init_device_mesh`` would set a CUDA device.

    It brings the fake group up when none is, and takes it down after; a
    fake group of the mesh's size already up (a test's) is used as it
    is.  Inside any other process group it refuses: a real group would
    run the collectives."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = math.prod(shape)
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    elif dist.get_backend() != "fake":
        raise RuntimeError(
            f"count_mesh: a {dist.get_backend()} process group is up; the "
            "dry-run counts over a fake group of its own")
    elif dist.get_world_size() != n:
        raise RuntimeError(
            f"count_mesh: the fake group has {dist.get_world_size()} ranks, "
            f"the mesh {shape} needs {n}")
    try:
        yield DeviceMesh("cuda", torch.arange(n).reshape(shape),
                         mesh_dim_names=tuple(axes))
    finally:
        if own:
            dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape, axes = PRODUCTION_MESHES["multi" if multi_pod else "single"]
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


def dividing_axes(rows: int, mesh, axes: tuple[str, ...]
                  ) -> tuple[str, ...]:
    """The batch axes that split ``rows`` rows evenly: ``axes`` where their
    ranks divide ``rows``, else the subset (in mesh order) of the most
    ranks that does, the rows replicated over the rest.  DTensor cannot
    reshape a dim split unevenly (a llama3-405b microbatch of 16 rows over
    the 32 ranks of ("pod", "data") goes over "data"); GSPMD pads the rows
    instead.  A rank holds as many rows either way."""
    sizes = mesh_sizes(mesh)
    best, most = (), 0
    for k in range(len(axes), 0, -1):
        for sub in itertools.combinations(axes, k):
            n = math.prod(sizes[a] for a in sub)
            if rows % n == 0 and n > most:
                best, most = sub, n
    return best
