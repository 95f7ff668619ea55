"""The paper's technique on a mesh: shard-degree autotuning.

Port of ``repro.core.autotune`` (the reference's modules with their
imports rewritten).  On a mesh the paper's "intra-op parallelism" becomes
the **shard degree** of an op class on the ``model`` mesh axis, and the
measurement function becomes the roofline time of the op at that degree.
The algorithm is unchanged: the same ``HillClimbProfiler`` climbs the
degree ladder (1,2,4,...,M; the power-of-two ladder is the analogue of
the paper's even-threads-only rule), stops at the first time increase,
interpolates untested degrees, and the same Strategy-1/2 freeze fixes
one degree per op class.  Its output becomes real through
``sharding.plan_from_degrees``, which turns the degrees into a
``ShardingPlan``.

The Strategy-3 analogue (`corun_groups`) space-shares the model axis
between independent op classes whose tuned degrees underuse it, balancing
sub-mesh sizes so co-runners finish together (the paper's throughput
guard).  The Strategy-4 analogue is the ring collective matmul
(``sharding.ring_ag_matmul``): collectives of small ops overlapped under
big ops' compute, the "second pipe".
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

from repro_torch.core.graph import Op
from repro_torch.core.perfmodel import (CurveModel, HillClimbProfiler,
                                         power_of_two_cases)
from repro_torch.hw.spec import dominant_term


@dataclasses.dataclass(frozen=True)
class RooflineMeasurement:
    """The three terms, seconds, for one candidate configuration."""

    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def time(self) -> float:
        """Overlapped roofline bound — what the hill climb minimizes."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def serial_time(self) -> float:
        return self.compute_s + self.memory_s + self.collective_s

    @property
    def bottleneck(self) -> str:
        return dominant_term(self.compute_s, self.memory_s, self.collective_s)


# (op_class, degree, variant) -> RooflineMeasurement.  ``variant`` selects
# the collective-axis flavor (False = contiguous minor axis / ICI-near,
# True = split across the pod axis) — the affinity analogue.
MeasureShardFn = Callable[[str, int, bool], RooflineMeasurement]


@dataclasses.dataclass(frozen=True)
class ShardDecision:
    op_class: str
    degree: int
    variant: bool
    predicted: RooflineMeasurement


@dataclasses.dataclass
class ShardPlanResult:
    decisions: dict[str, ShardDecision]
    curves: dict[str, CurveModel]
    probes: int

    def degree(self, op_class: str, default: int = 1) -> int:
        d = self.decisions.get(op_class)
        return d.degree if d else default


class ShardDegreeAutotuner:
    """Hill-climb per-op-class shard degrees with roofline measurements."""

    def __init__(self, measure: MeasureShardFn, *, max_degree: int,
                 variants: tuple[bool, ...] = (False,), interval: int = 1):
        self.measure = measure
        self.max_degree = max_degree
        self.variants = variants
        self.interval = interval
        self._cache: dict[tuple[str, int, bool], RooflineMeasurement] = {}

    def _measured(self, op_class: str, degree: int, variant: bool
                  ) -> RooflineMeasurement:
        key = (op_class, degree, variant)
        if key not in self._cache:
            self._cache[key] = self.measure(op_class, degree, variant)
        return self._cache[key]

    def tune(self, op_classes: list[str]) -> ShardPlanResult:
        cases = {v: power_of_two_cases(self.max_degree)[False]
                 for v in self.variants}
        decisions: dict[str, ShardDecision] = {}
        curves: dict[str, CurveModel] = {}
        probes = 0
        for cls in op_classes:
            def measure_fn(op: Op, degree: int, variant: bool,
                           _cls=cls) -> float:
                return self._measured(_cls, degree, variant).time

            profiler = HillClimbProfiler(measure=measure_fn,
                                         case_lists=cases,
                                         interval=self.interval)
            dummy = Op(uid=0, name=cls, op_class=cls, input_shape=())
            curve = profiler.profile(dummy)
            probes += curve.probes
            deg, variant, _ = curve.measured_best()
            decisions[cls] = ShardDecision(
                op_class=cls, degree=deg, variant=variant,
                predicted=self._measured(cls, deg, variant))
            curves[cls] = curve
        return ShardPlanResult(decisions=decisions, curves=curves,
                               probes=probes)


# ---------------------------------------------------------------------------
# Strategy-3 analogue: space-share the model axis between independent ops.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CorunGroup:
    members: tuple[str, ...]        # op classes co-running
    degrees: tuple[int, ...]        # sub-mesh sizes, sum <= axis
    makespan: float


def corun_groups(plan: ShardPlanResult, independent_sets: list[list[str]],
                 axis_size: int) -> list[CorunGroup]:
    """For each set of mutually independent op classes, decide how to
    partition the model axis among them (paper Strategy 3 / Table III's
    'co-run with threads control').

    Greedy: scale each member's degree ladder so the group fits the axis,
    choosing the split minimizing max member time (the throughput guard:
    co-runners should finish together)."""
    groups: list[CorunGroup] = []
    for members in independent_sets:
        members = [m for m in members if m in plan.curves]
        if not members:
            continue
        if len(members) == 1:
            d = plan.decisions[members[0]]
            groups.append(CorunGroup((members[0],), (d.degree,),
                                     d.predicted.time))
            continue
        best: CorunGroup | None = None
        # enumerate power-of-two splits of the axis among members
        ladders = [1 << i for i in range(int(math.log2(axis_size)) + 1)]

        def search(i: int, remaining: int, degs: list[int]) -> None:
            nonlocal best
            if i == len(members):
                t = max(plan.curves[m].predict(d, plan.decisions[m].variant)
                        for m, d in zip(members, degs))
                if best is None or t < best.makespan:
                    best = CorunGroup(tuple(members), tuple(degs), t)
                return
            for d in ladders:
                if d <= remaining - (len(members) - i - 1):
                    search(i + 1, remaining - d, degs + [d])

        search(0, axis_size, [])
        sequential = sum(plan.curves[m].predict(
            plan.decisions[m].degree, plan.decisions[m].variant)
            for m in members)
        if best is not None and best.makespan < sequential:
            groups.append(best)
        else:
            # co-running loses: keep them sequential at tuned degrees
            for m in members:
                d = plan.decisions[m]
                groups.append(CorunGroup((m,), (d.degree,), d.predicted.time))
    return groups
