"""Collective accounting: the bytes each collective of a step puts on the
links, and whether its group stays inside one node.

The port's counterpart of ``repro.hw.hlo``.  The reference parses the
optimized HLO of the per-device program; the port reads each collective
where it is dispatched (``hw.cost.CostCounter`` calls
``dispatched_collective`` for every op): DTensor's redistributions and
the layers' explicit reductions all go through the functional
collectives, whose ops carry their tensors and their process group's
name.  Dispatched op -> the reference's kind:

    _c10d_functional.all_gather_into_tensor    all-gather
    _c10d_functional.reduce_scatter_tensor     reduce-scatter
    _c10d_functional.all_reduce                all-reduce
    _c10d_functional.all_to_all_single         all-to-all
    _dtensor.shard_dim_alltoall                all-to-all

and the same for the autograd forms (``_c10d_functional_autograd``).
Any other op of these namespaces or of ``c10d``, but ``wait_tensor`` and
``_wrap_tensor_autograd``, raises: no collective is dropped.  Bytes
come from each collective's RESULT, as the reference reads them, and the
same ring model prices them per device:

    all-gather       result = full gathered tensor, link (g-1)/g * full
    reduce-scatter   result = one shard (full = result * g), (g-1)/g * full
    all-reduce       result = full tensor, 2 (g-1)/g * full
    all-to-all       result = full, (g-1)/g * full
    collective-permute  result = payload, payload

The group size is the number of the group's ranks.  A group "crosses"
when its members span more than one block of ``pod_size`` consecutive
ranks.  On the reference's TPU mesh the block is a pod (ICI inside, DCI
across).  On H100s the dry-run passes the NVLink node,
``H100Spec.gpus_per_node`` = 8 GPUs: ``ici_link_bytes`` then holds the
groups inside one 8-GPU node (NVLink) and ``dci_link_bytes`` those that
span nodes (the network), the H100's counterpart of the pod boundary.
``op_histogram``'s counterpart is ``CostCounter.ops``, the count of
dispatched aten ops by name.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import torch

_KINDS = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_dtensor::shard_dim_alltoall": "all-to-all",
    "_c10d_functional_autograd::all_gather_into_tensor": "all-gather",
    "_c10d_functional_autograd::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional_autograd::all_to_all_single": "all-to-all",
}
# ops of the collective namespaces that move nothing themselves
_NOT_COLLECTIVES = {"_c10d_functional::wait_tensor",
                    "_c10d_functional::_wrap_tensor_autograd"}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "_dtensor",
               "c10d")


def _full_and_ring(kind: str, result_bytes: int, g: int
                   ) -> tuple[float, float]:
    """(full tensor bytes, per-device ring link bytes): own copy of the
    reference's ring model."""
    g = max(g, 1)
    if kind.startswith("all-gather"):
        full = float(result_bytes)
        return full, full * (g - 1) / g
    if kind.startswith("reduce-scatter"):
        full = float(result_bytes) * g
        return full, full * (g - 1) / g
    if kind.startswith("all-reduce"):
        full = float(result_bytes)
        return full, 2.0 * full * (g - 1) / g
    if kind.startswith("all-to-all"):
        full = float(result_bytes)
        return full, full * (g - 1) / g
    if kind.startswith("collective-permute"):
        full = float(result_bytes)
        return full, full
    return float(result_bytes), float(result_bytes)


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    full_bytes: float          # logical tensor size moved
    group_size: int
    crosses_pod: bool
    link_bytes: float          # ring-model per-device bytes on the wire

    @property
    def base_kind(self) -> str:
        return self.kind.replace("-start", "")


@dataclasses.dataclass
class CollectiveStats:
    ops: list[CollectiveOp]

    @property
    def raw_operand_bytes(self) -> float:
        return sum(op.full_bytes for op in self.ops)

    @property
    def ici_link_bytes(self) -> float:
        return sum(op.link_bytes for op in self.ops if not op.crosses_pod)

    @property
    def dci_link_bytes(self) -> float:
        return sum(op.link_bytes for op in self.ops if op.crosses_pod)

    def by_kind(self) -> dict[str, tuple[int, float]]:
        """kind -> (count, link_bytes)."""
        out: dict[str, tuple[int, float]] = defaultdict(lambda: (0, 0.0))
        for op in self.ops:
            c, b = out[op.base_kind]
            out[op.base_kind] = (c + 1, b + op.link_bytes)
        return dict(out)

    def summary(self) -> str:
        parts = [f"{k}:n={c},linkB={b:.3e}" for k, (c, b) in
                 sorted(self.by_kind().items())]
        return (f"ici={self.ici_link_bytes:.3e}B dci={self.dci_link_bytes:.3e}B "
                + " ".join(parts))


def crosses(ranks, pod_size: int | None) -> bool:
    """Whether ``ranks`` span more than one block of ``pod_size``
    consecutive ranks."""
    return bool(pod_size) and len({r // pod_size for r in ranks}) > 1


def collective_op(kind: str, result_bytes: int, ranks, pod_size: int | None
                  ) -> CollectiveOp:
    """One collective of ``kind`` whose result holds ``result_bytes``, over
    the group of global ``ranks``."""
    ranks = list(ranks)
    full, ring = _full_and_ring(kind, result_bytes, len(ranks))
    return CollectiveOp(kind=kind, full_bytes=full, group_size=len(ranks),
                        crosses_pod=crosses(ranks, pod_size), link_bytes=ring)


def group_ranks(group_name: str) -> list[int]:
    """The global ranks of the process group registered as
    ``group_name``."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    return dist.get_process_group_ranks(_resolve_process_group(group_name))


def is_collective_namespace(func) -> bool:
    return func.namespace in _NAMESPACES


def dispatched_collective(func, args: tuple, kwargs: dict, out,
                          pod_size: int | None
                          ) -> tuple[CollectiveOp, list[int]] | None:
    """The collective of one dispatched op and its group's global ranks
    (None for an op that moves nothing between ranks); an unmapped op of
    the collective namespaces raises."""
    if not is_collective_namespace(func):
        return None
    name = func._schema.name
    if name in _NOT_COLLECTIVES:
        return None
    kind = _KINDS.get(name)
    if kind is None:
        raise NotImplementedError(
            f"hw.comm: collective {func} is not mapped to a kind; it "
            "would go uncounted")
    bound = dict(zip((a.name for a in func._schema.arguments), args))
    bound.update(kwargs)
    if not isinstance(out, torch.Tensor):
        raise NotImplementedError(f"hw.comm: {func} returned {type(out)}")
    ranks = group_ranks(bound["group_name"])
    return collective_op(kind, out.numel() * out.element_size(), ranks,
                         pod_size), ranks
