"""Dataflow op-graph IR: the unit the paper's runtime schedules.

The port's own copy of the static part of ``repro.core.graph`` (``Op``,
``OpGraph``, ``GraphBuilder``), which ``serving.wave_op_graph`` builds.
Each op carries the analytic workload attributes the cost oracles need
(flops, bytes moved, working set, parallel fraction) and its *op class*,
the key under which concurrency decisions are cached (the paper's
Strategy 2 keys decisions by operation type, not instance).  The dynamic
regions (and ``OpGraph``'s ready-frontier methods that serve them) and
the paper's graph builders come with the scheduling stack.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import defaultdict, deque
from typing import Callable, Iterable


@dataclasses.dataclass
class Op:
    """One schedulable operation instance."""

    uid: int
    name: str                      # unique instance name, e.g. "conv2d_bwd_filter/12"
    op_class: str                  # class key, e.g. "Conv2DBackpropFilter"
    input_shape: tuple[int, ...]   # the paper's "input data size"
    flops: float = 0.0
    bytes_moved: float = 0.0       # main-memory traffic at parallelism 1
    working_set: float = 0.0       # bytes live during execution
    parallel_fraction: float = 0.95  # Amdahl fraction (simmachine only)
    deps: tuple[int, ...] = ()     # uids of producers
    payload: Callable | None = None  # optional real callable to run
    tunable: bool = True           # False: Eigen-style op, keep session default

    @property
    def size_key(self) -> tuple[str, tuple[int, ...]]:
        """(op_class, input_shape): the paper's per-(op, input-size) key."""
        return (self.op_class, self.input_shape)

    @property
    def weight(self) -> float:
        """Scalar proxy for 'how big' this instance is (Strategy 2 uses the
        largest instance of a class to fix the class's concurrency)."""
        return self.flops + self.bytes_moved


@dataclasses.dataclass
class OpGraph:
    name: str
    ops: dict[int, Op]

    def __post_init__(self) -> None:
        self._consumers: dict[int, list[int]] = defaultdict(list)
        for op in self.ops.values():
            for d in op.deps:
                if d not in self.ops:
                    raise ValueError(f"{op.name} depends on unknown uid {d}")
                self._consumers[d].append(op.uid)

    # ---- structure ------------------------------------------------------
    def consumers(self, uid: int) -> list[int]:
        return self._consumers.get(uid, [])

    def sources(self) -> list[int]:
        return [u for u, op in self.ops.items() if not op.deps]

    def topo_order(self) -> list[int]:
        indeg = {u: len(op.deps) for u, op in self.ops.items()}
        q = deque(sorted(u for u, d in indeg.items() if d == 0))
        order: list[int] = []
        while q:
            u = q.popleft()
            order.append(u)
            for c in self._consumers.get(u, []):
                indeg[c] -= 1
                if indeg[c] == 0:
                    q.append(c)
        if len(order) != len(self.ops):
            raise ValueError(f"cycle detected in graph {self.name}")
        return order

    def validate(self) -> None:
        self.topo_order()

    # ---- stats ----------------------------------------------------------
    @property
    def n_ops(self) -> int:
        return len(self.ops)

    def classes(self) -> dict[str, list[Op]]:
        by_class: dict[str, list[Op]] = defaultdict(list)
        for op in self.ops.values():
            by_class[op.op_class].append(op)
        return dict(by_class)

    def total_flops(self) -> float:
        return sum(op.flops for op in self.ops.values())

    def fingerprint(self) -> str:
        h = hashlib.sha1()
        for u in sorted(self.ops):
            op = self.ops[u]
            h.update(f"{u}:{op.op_class}:{op.input_shape}:{op.deps}".encode())
        return h.hexdigest()[:12]


class GraphBuilder:
    """Incremental DAG construction helper."""

    def __init__(self, name: str):
        self.name = name
        self._ops: dict[int, Op] = {}
        self._next = 0

    def add(self, op_class: str, input_shape: tuple[int, ...], *,
            flops: float = 0.0, bytes_moved: float = 0.0,
            working_set: float = 0.0, parallel_fraction: float = 0.95,
            deps: Iterable[int] = (), name: str | None = None,
            payload: Callable | None = None, tunable: bool = True) -> int:
        uid = self._next
        self._next += 1
        self._ops[uid] = Op(
            uid=uid,
            name=name or f"{op_class.lower()}/{uid}",
            op_class=op_class,
            input_shape=tuple(input_shape),
            flops=flops, bytes_moved=bytes_moved,
            working_set=working_set or bytes_moved,
            parallel_fraction=parallel_fraction,
            deps=tuple(deps), payload=payload, tunable=tunable)
        return uid

    def build(self) -> OpGraph:
        g = OpGraph(self.name, dict(self._ops))
        g.validate()
        return g
