"""ShardingPlan -> DTensor placements; the autotuner's output surface.

Port of ``repro.sharding.specs``.  The reference maps a plan's
``PartitionSpec`` to a JAX ``NamedSharding``; here the same spec (the
plain tuple ``ShardingPlan.spec_for`` returns) becomes one DTensor
placement a mesh dim: ``Shard(d)`` on each mesh axis that tensor dim
``d`` is split over, ``Replicate()`` on the others.  A dim split over
several mesh axes gets ``Shard(d)`` on each of them, the major axis
first, as JAX orders the tuple; a tuple that names its axes against the
mesh's own order has no plain DTensor placement and raises.

``plan_from_degrees`` turns the autotuner's per-op-class shard degrees
into a ``ShardingPlan`` on a mesh whose ``model`` axis has been factored
into sub-axes (degree 8 on a 16-wide model axis is a split into
('mdl', 'sub') with only 'mdl' assigned).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.launch.mesh import mesh_sizes
from repro_torch.models.common import (ModelConfig, Params, ShardingPlan,
                                       Specs, is_dtensor, map_specs, tree_get,
                                       tree_map)

# op classes the tuner knows, and the logical axes each one controls
OP_CLASS_AXES: dict[str, tuple[str, ...]] = {
    "attention": ("heads", "kv"),
    "mlp": ("ff",),
    "moe": ("expert",),
    "embed": ("vocab",),
    "recurrence": ("state",),
}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and one placement a mesh dim: where ``distribute_tensor``
    puts a tensor (the counterpart of ``jax.sharding.NamedSharding``)."""

    mesh: object                 # torch.distributed.DeviceMesh
    placements: tuple


def placements_for(spec: tuple, mesh) -> tuple:
    """A ``spec_for`` tuple (None, a mesh axis name or a tuple of names a
    tensor dim) -> one ``Shard``/``Replicate`` a mesh dim of ``mesh``."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"spec {spec} names mesh axes {missing} that "
                             f"mesh {names} lacks")
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise NotImplementedError(
                f"spec {spec}: dim {dim} splits over {axes}, against the "
                f"mesh's order {names}")
        for i in order:
            out[i] = Shard(dim)
    return tuple(out)


def named_sharding_tree(plan: ShardingPlan, mesh, logical_tree: Specs):
    """Map a logical-axes spec tree to ``NamedSharding``s on ``mesh``."""
    return map_specs(
        lambda logical: NamedSharding(
            mesh, placements_for(plan.spec_for(logical), mesh)),
        logical_tree)


def batch_sharding(plan: ShardingPlan, mesh, *,
                   seq_dim: int | None = None) -> NamedSharding:
    """(B, S, ...) activation sharding: batch over plan.batch_axes, and
    optionally sequence over plan.seq_axes (sequence parallelism)."""
    parts: list = [tuple(plan.batch_axes) or None]
    if seq_dim is not None:
        parts.append(tuple(plan.seq_axes) or None)
    return NamedSharding(mesh, placements_for(tuple(parts), mesh))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, placements_for((), mesh))


def distribute_tree(tree: Params, shardings) -> Params:
    """Place every tensor of ``tree`` (params or a whole train state) on
    its ``NamedSharding`` of ``shardings`` (same structure) as a DTensor.
    Every rank must hold the same full tree (the same seed, or the same
    checkpoint): each keeps its own slice, nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    def place(path: str, t: torch.Tensor):
        sh = tree_get(shardings, path)
        return distribute_tensor(t.detach(), sh.mesh, sh.placements,
                                 src_data_rank=None)
    return tree_map(place, tree)


def place_cache(cache: dict, shardings: dict) -> dict:
    """A decode cache on its ``cache_shardings`` (same structure): a plain
    tensor is distributed (every rank holds the same full cache and
    keeps its slice, nothing is sent), a DTensor (a sharded prefill's
    cache) is redistributed, and the int "len" stays an int."""
    from torch.distributed.tensor import distribute_tensor

    def place(node, sh):
        if isinstance(node, dict):
            return {k: place(v, sh[k]) for k, v in node.items()}
        if not isinstance(node, torch.Tensor):
            return node
        if is_dtensor(node):
            return node.redistribute(sh.mesh, sh.placements)
        return distribute_tensor(node, sh.mesh, sh.placements,
                                 src_data_rank=None)
    return place(cache, shardings)


def degree_to_axes(degree: int, model_axes: tuple[tuple[str, int], ...]
                   ) -> tuple[str, ...]:
    """Greedily pick mesh sub-axes whose product equals ``degree``.

    model_axes: ((name, size), ...) in preference order (nearest first).
    degree must be a product of a prefix of the sizes."""
    axes: list[str] = []
    left = degree
    for name, size in model_axes:
        if left <= 1:
            break
        if left % size == 0:
            axes.append(name)
            left //= size
        elif size % left == 0 and left > 1:
            # would need a partial axis: not expressible -> caller must
            # factor the mesh so degrees are products of sub-axis sizes
            raise ValueError(
                f"degree {degree} not expressible with axes {model_axes}")
    if left != 1:
        raise ValueError(
            f"degree {degree} not expressible with axes {model_axes}")
    return tuple(axes)


def plan_from_degrees(degrees: dict[str, int],
                      model_axes: tuple[tuple[str, int], ...],
                      *, fsdp_axes: tuple[str, ...] = ("data",),
                      batch_axes: tuple[str, ...] = ("data",),
                      ) -> ShardingPlan:
    """Build a ShardingPlan from per-op-class shard degrees (the frozen
    Strategy-1/2 output of the autotuner)."""
    rules: dict[str, tuple[str, ...]] = {
        "embed": tuple(fsdp_axes),
        "layers": (), "conv": (),
    }
    for cls, logical_axes in OP_CLASS_AXES.items():
        deg = degrees.get(cls, 1)
        axes = degree_to_axes(deg, model_axes)
        for la in logical_axes:
            rules[la] = axes
    # kv heads cannot shard beyond their count: the caller clamps the
    # attention degree; here it is mirrored
    return ShardingPlan(rules=rules, batch_axes=batch_axes)


def clamp_degree_for_axis(degree: int, axis_len: int) -> int:
    """Largest power-of-two divisor of axis_len that is <= degree."""
    d = 1
    while d * 2 <= min(degree, axis_len) and axis_len % (d * 2) == 0:
        d *= 2
    return d


def validate_plan(cfg: ModelConfig, plan: ShardingPlan, mesh) -> list[str]:
    """Static divisibility checks: every sharded dim must divide evenly.
    Returns a list of problems (empty = ok).  ``mesh``: a
    ``DeviceMesh``."""
    problems = []
    sizes = mesh_sizes(mesh)

    def axes_size(axes: tuple[str, ...]) -> int:
        n = 1
        for a in axes:
            n *= sizes.get(a, 1)
        return n

    # param dims are stored flattened (heads*hd), so divisibility is on the
    # flattened sizes
    checks = {
        "heads": cfg.n_heads * cfg.hd, "kv": cfg.n_kv_heads * cfg.hd,
        "ff": cfg.d_ff, "vocab": cfg.vocab, "embed": cfg.d_model,
        "expert": cfg.moe_experts or 1,
    }
    for axis_name, dim in checks.items():
        deg = axes_size(plan.rules.get(axis_name, ()))
        if deg > 1 and dim % deg:
            problems.append(f"{axis_name}={dim} not divisible by {deg}")
    return problems
