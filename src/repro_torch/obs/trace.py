"""Decision tracing: structured events behind the ``TraceSink`` seam.

The scheduling stack decides constantly — admit this tenant or defer it,
launch this op through S3 or the fallback, book these cores, revoke that
victim, blend this observation — and until this module the only record
of any decision was its *effect* on the timeline.  ``TraceSink`` is the
seam every layer emits into: the strategy core, the placement bookings,
the preemption path, the admission tier, and the plan-store observation
stream all produce ``TraceEvent`` records tagged with one of five
**families**:

* ``admission``  — admit / defer / reserve, with the demand and slack
  inputs the queue decided on;
* ``strategy``   — every launch path (S3 admission, S2 clamp, run-biggest
  fallback, S4 hyper lane, deadline claim), every considered-but-rejected
  candidate with its cause, and the fair-share charge/refund stream;
* ``placement``  — every quadrant booking (chosen quadrants, spill,
  avoid-set overrides) under ``topology="quadrant"``;
* ``preemption`` — waive / squeeze / revoke with the victim-selection
  inputs, so "why was job X preempted at t=..." is answerable from the
  trace alone;
* ``planstore``  — every launch/finish/revoke observation (predicted vs
  observed, the correction factor in force) plus per-job profiling cost.

The default sink is ``NullSink`` — ``enabled`` is False and every emit
site in the schedulers is guarded by it, so the default configuration
builds no event objects at all and is bit-for-bit the untraced scheduler
(tracing is read-only by construction; the differential/golden suites and
the traced parity leg in ``repro_torch.multitenant.parity`` lock it down).
``RecordingSink`` collects events in memory for the metrics registry
(``repro_torch.obs.metrics``) and the Perfetto exporter (``repro_torch.obs.perfetto``).

This module deliberately imports nothing from ``repro_torch.core`` — the core
imports *us* (the sink rides on ``StrategyConfig``), and the obs layer
stays reusable by every later subsystem (pool daemon, learned model,
multi-machine placement) without cycles.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Hashable, Mapping

# the decision-event families (see module docstring)
FAM_ADMISSION = "admission"
FAM_STRATEGY = "strategy"
FAM_PLACEMENT = "placement"
FAM_PREEMPTION = "preemption"
FAM_PLANSTORE = "planstore"
FAM_REGION = "region"       # dynamic control flow: expand/resolve instants
# service-daemon lifecycle (repro.service): start / recover / recover_job
# / submit / cancel / checkpoint / drain / stop — the daemon emits its
# lifecycle into the same seam the schedulers use, per the ROADMAP's
# no-private-logging rule
FAM_SERVICE = "service"
# multi-machine placement (repro.cluster): route / rebalance / split
# decisions above the per-machine pools, keyed by cluster job id with the
# chosen machine index, the demand estimate that drove the choice, and
# the per-machine loads at the decision instant
FAM_CLUSTER = "cluster"

# FAM_CLUSTER is appended LAST deliberately: the Perfetto exporter derives
# decision-lane tids from this tuple's order, so end-appending keeps every
# pre-cluster trace's lane numbering stable
FAMILIES = (FAM_ADMISSION, FAM_STRATEGY, FAM_PLACEMENT, FAM_PREEMPTION,
            FAM_PLANSTORE, FAM_REGION, FAM_SERVICE, FAM_CLUSTER)


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One scheduling decision (or observation) at one instant.

    ``key`` is the node key the decision concerns (``int`` uid for the
    single-graph scheduler, ``(jid, uid)`` for the pool, a bare ``jid``
    for admission events, ``None`` for machine-wide events); ``data``
    carries the decision's inputs and outputs — enough to re-derive the
    accounting the schedulers did (see ``metrics_from_events``)."""

    ts: float
    family: str
    kind: str
    key: Hashable | None = None
    data: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        """JSON-serializable form (tuples become lists; callers that need
        the original key shape re-freeze on load)."""
        return {"ts": self.ts, "family": self.family, "kind": self.kind,
                "key": self.key, "data": dict(self.data)}


class TraceSink(abc.ABC):
    """Where decision events go.  ``enabled`` gates every emit site: the
    schedulers check it BEFORE building the event object, so a disabled
    sink costs one attribute read per decision and nothing else."""

    enabled: bool = True

    @abc.abstractmethod
    def emit(self, event: TraceEvent) -> None: ...


class NullSink(TraceSink):
    """The default: tracing off, guaranteed inert.

    All ``NullSink`` instances compare equal (and hash alike) so frozen
    ``StrategyConfig`` values built independently still compare equal —
    config equality must not depend on which default sink object a
    dataclass factory happened to construct."""

    enabled = False

    def emit(self, event: TraceEvent) -> None:  # pragma: no cover - inert
        pass

    def __eq__(self, other: object) -> bool:
        return type(other) is NullSink

    def __hash__(self) -> int:
        return hash(NullSink)


#: shared inert instance for default arguments (NullSink is stateless)
NULL_SINK = NullSink()


class RecordingSink(TraceSink):
    """Collect every event in memory — the sink behind ``--trace-out``,
    the metrics registry, and the Perfetto exporter."""

    def __init__(self) -> None:
        self.events: list[TraceEvent] = []

    def emit(self, event: TraceEvent) -> None:
        self.events.append(event)

    def __len__(self) -> int:
        return len(self.events)

    def by_family(self, family: str) -> list[TraceEvent]:
        return [e for e in self.events if e.family == family]

    def families(self) -> set[str]:
        return {e.family for e in self.events}
