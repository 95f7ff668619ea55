"""Concurrency control — the paper's Strategies 1 and 2 (§III-D).

* Strategy 1: every op instance runs with the thread count minimizing its
  modeled time (per (op_class, input_shape) curve).
* Strategy 2: hysteresis — all instances of an op class share ONE thread
  count, the optimum of the class's most expensive instance, because
  re-deciding concurrency per instance thrashes caches and re-spawns
  threads.  A scheduler proposal deviating from the class plan by more than
  ``max_deviation`` (paper's empirical value: 2 cases) is clamped back.
"""

from __future__ import annotations

import dataclasses
from typing import Hashable

from repro_torch.core.graph import Op, OpGraph
from repro_torch.core.perfmodel import CurveModel, ProfileStore


@dataclasses.dataclass(frozen=True)
class OpPlan:
    threads: int
    variant: bool            # affinity flavor (cache sharing / collective axis)
    predicted_time: float


@dataclasses.dataclass
class ConcurrencyPlan:
    """Frozen output of strategies 1-2 for one graph."""

    per_instance: dict[Hashable, OpPlan]       # size_key -> plan (Strategy 1)
    per_class: dict[str, OpPlan]                # op_class -> plan (Strategy 2)
    max_deviation: int = 2                      # in probe-CASE units
    case_step: int = 8                          # threads per probe case step

    def plan_for(self, op: Op, *, strategy2: bool = True) -> OpPlan:
        if strategy2 and op.op_class in self.per_class:
            return self.per_class[op.op_class]
        return self.per_instance[op.size_key]

    def clamp(self, op: Op, proposal: OpPlan) -> OpPlan:
        """Strategy 2 guard over Strategy 3 proposals: if the scheduler's
        candidate deviates from the class plan by more than max_deviation
        probe cases (paper's empirical "2"), fall back to the class plan
        (§III-D, S3/S2 interaction).  Deviation is measured in profiling-
        case units because candidates are drawn from the probe grid."""
        cls = self.per_class.get(op.op_class)
        if cls is None:
            return proposal
        if abs(proposal.threads - cls.threads) > self.max_deviation * self.case_step:
            return cls
        return proposal


class ConcurrencyController:
    """Builds the frozen plan from hill-climb profiles.

    Ops with ``tunable=False`` (Eigen-implemented in the paper's setting,
    §IV-A) are pinned to the session-default concurrency
    (``default_threads``, cache-sharing) in every plan and candidate list —
    the runtime never re-tunes them."""

    def __init__(self, store: ProfileStore, max_deviation: int = 2,
                 default_threads: int = 68, interval: int = 4):
        self.store = store
        self.max_deviation = max_deviation
        self.default_threads = default_threads
        self.interval = interval

    def _fixed_plan(self, curve: CurveModel) -> OpPlan:
        t = self.default_threads
        return OpPlan(t, True, curve.predict(t, True))

    def build_plan(self, graph: OpGraph) -> ConcurrencyPlan:
        tunable_cls = {cls: all(o.tunable for o in ops)
                       for cls, ops in graph.classes().items()}
        per_instance: dict[Hashable, OpPlan] = {}
        for key, curve in self.store.curves.items():
            if not tunable_cls.get(key[0], True):
                per_instance[key] = self._fixed_plan(curve)
                continue
            t, v, y = curve.best()
            per_instance[key] = OpPlan(t, v, y)

        per_class: dict[str, OpPlan] = {}
        for cls, ops in graph.classes().items():
            # the paper fixes the class's threads by its most expensive
            # (largest-input) instance
            heaviest = max(ops, key=lambda o: o.weight)
            curve = self.store.curves.get(heaviest.size_key)
            if curve is None:
                continue
            if not tunable_cls[cls]:
                per_class[cls] = self._fixed_plan(curve)
                continue
            t, v, _ = curve.best()
            # predicted time is instance-specific; store class default time
            per_class[cls] = OpPlan(t, v, curve.predict(t, v))
        return ConcurrencyPlan(per_instance=per_instance, per_class=per_class,
                               max_deviation=self.max_deviation,
                               case_step=self.interval * 2)

    def candidates_for(self, op: Op, k: int = 3) -> list[OpPlan]:
        """Strategy 3's top-k candidate configurations for one op."""
        curve: CurveModel = self.store.curve(op)
        if not op.tunable:
            return [self._fixed_plan(curve)]
        return [OpPlan(t, v, y) for t, v, y in curve.candidates(k)]
