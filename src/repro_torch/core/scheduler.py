"""Operation scheduling — the paper's Strategies 3 and 4 (§III-D).

``CorunScheduler`` is an event-driven list scheduler over an ``OpGraph``:

* **Strategy 3** — whenever cores idle, examine ready ops; for each, take
  its top-3 modeled candidates (threads, affinity, predicted time); a
  candidate is *admissible* if it (a) fits the idle cores, (b) does not
  outlast the longest-remaining ongoing op (throughput guard), (c) is not
  interference-blacklisted against the running classes.  Among admissible
  candidates of an op, pick the FEWEST threads (the paper deliberately
  leaves cores free to admit more co-runners).  If nothing is admissible
  and the machine is idle, run the most time-consuming ready op at its
  frozen plan.
* **Strategy 4** — when the running set occupies every physical core, admit
  the smallest ready ops (shortest serial time) onto the hyper-thread lane.
* Strategy 2 interaction — every launch decision is clamped by
  ``ConcurrencyPlan.clamp`` (deviation > 2 cases falls back to class plan).

The strategy RULES live in ``repro_torch.core.strategy.StrategyCore`` — shared
verbatim with the multi-tenant ``repro.multitenant.pool.PoolScheduler`` —
and ``CorunScheduler`` is the single-graph adapter over them: it supplies
the candidate source (one global ready group), the plan/controller lookup,
and the event-sim commit.  ``ScheduledOp``/``ScheduleResult`` and the
admission helpers are defined in ``repro_torch.core.strategy`` and re-exported
here for compatibility.

Baselines for the paper's Table I / Fig 3 comparisons:

* ``uniform_schedule`` — TensorFlow-style: fixed (inter-op, intra-op)
  parallelism, FIFO ready queue, oversubscription penalty when
  inter*intra exceeds physical cores.
"""

from __future__ import annotations

import heapq
import itertools
from collections import deque
from typing import Mapping, Sequence

from repro_torch.core.concurrency import ConcurrencyPlan, ConcurrencyController, OpPlan
from repro_torch.core.graph import Op, OpGraph
from repro_torch.core.interference import InterferenceRecorder
from repro_torch.core.perfmodel import cross_graph_key
from repro_torch.core.planstore import (OBS_FINISH, FrozenPlanStore, OpObservation,
                                  PlanStore, make_plan_store)
from repro_torch.core.simmachine import Placement, SimMachine
from repro_torch.core.strategy import (ScheduledOp, ScheduleResult, StrategyAdapter,
                                 StrategyConfig, StrategyCore, free_cores,
                                 pick_admissible, remaining_horizon)
from repro_torch.obs.trace import (FAM_PLANSTORE, FAM_REGION, NULL_SINK, TraceEvent,
                             TraceSink)

__all__ = [
    "CorunScheduler", "ScheduledOp", "ScheduleResult", "free_cores",
    "pick_admissible", "remaining_horizon", "uniform_schedule",
    "manual_best_schedule",
]


class _EventSim:
    """Shared discrete-event machinery over one graph.

    The multi-tenant pool (``repro.multitenant.pool``) runs the same
    launch/complete event loop over many graphs at once (its ``_PoolSim``
    keys nodes by ``(jid, uid)``) and keeps the ``ScheduledOp`` record and
    event-timeline conventions defined here, so pool records and
    single-graph records stay interchangeable."""

    def __init__(self, graph: OpGraph):
        self.graph = graph
        # restore dynamic graphs to their initial shape; entry-free
        # regions expand immediately (no-op [] on static graphs)
        self.region_events = list(graph.reset())
        self.pending = {u: len(op.deps) for u, op in graph.ops.items()}
        self.ready: deque[int] = deque(sorted(graph.sources()))
        self.heap: list[tuple[float, int, int]] = []   # (finish, seq, uid)
        self.running: dict[int, ScheduledOp] = {}
        self.completed: set[int] = set()
        self.clock = 0.0
        self.records: list[ScheduledOp] = []
        self.events: list[tuple[float, int]] = []
        self._seq = itertools.count()

    def launch(self, uid: int, sched: ScheduledOp) -> None:
        self.running[uid] = sched
        heapq.heappush(self.heap, (sched.finish, next(self._seq), uid))
        self.events.append((self.clock, len(self.running)))

    def complete_next(self) -> ScheduledOp:
        finish, _, uid = heapq.heappop(self.heap)
        self.clock = finish
        sched = self.running.pop(uid)
        self.records.append(sched)
        self.completed.add(uid)
        for c in self.graph.consumers(uid):
            self.pending[c] -= 1
            if self.pending[c] == 0:
                self.ready.append(c)
        # dynamic graphs may materialize ops at this instant (next loop
        # iteration, taken branch, region exit); absorb them into the
        # frontier — their gate deps are already complete, so consumer
        # decrements will never arrive for those edges
        for ev in self.graph.advance(uid, self.completed):
            self.region_events.append(ev)
            self._absorb(ev.new_uids)
        self.events.append((self.clock, len(self.running)))
        return sched

    def _absorb(self, new_uids) -> None:
        for u in new_uids:
            op = self.graph.ops[u]
            n = sum(1 for d in op.deps if d not in self.completed)
            self.pending[u] = n
            if n == 0:
                self.ready.append(u)

    @property
    def done(self) -> bool:
        return not self.ready and not self.running


class _GraphAdapter(StrategyAdapter):
    """Single-graph view for ``StrategyCore``: node keys are op uids, the
    candidate source is ONE global ready group, and every plan lookup
    resolves through the graph's ``PlanStore`` (frozen profiling curves
    under ``feedback="off"``, observation-corrected ones under
    ``feedback="ewma"`` — see ``repro_torch.core.planstore``)."""

    def __init__(self, sim: _EventSim, controller: ConcurrencyController,
                 plan: ConcurrencyPlan, *, strategy2: bool,
                 spec=None, store: PlanStore | None = None,
                 sink: TraceSink = NULL_SINK):
        self.sim = sim
        self.controller = controller
        self.plan = plan
        self.strategy2 = strategy2
        self.store = store if store is not None \
            else FrozenPlanStore(controller)
        self.sink = sink
        self._spec = spec
        self._last_quadrant: int | None = None

    @property
    def clock(self) -> float:
        return self.sim.clock

    @property
    def running(self) -> Mapping[int, ScheduledOp]:
        return self.sim.running

    def ready_groups(self) -> list[Sequence[int]]:
        return [list(self.sim.ready)]

    def op(self, key: int) -> Op:
        return self.sim.graph.ops[key]

    def instance_plan(self, key: int) -> OpPlan:
        op = self.op(key)
        # predicted time must be instance-specific: the store re-prices
        # the frozen plan's width (corrected under feedback="ewma")
        return self.store.replan(op, self.plan.plan_for(
            op, strategy2=self.strategy2))

    def candidates_for(self, key: int, k: int) -> list[OpPlan]:
        return self.store.candidates(self.op(key), k)

    def clamp(self, key: int, proposal: OpPlan) -> OpPlan:
        return self.plan.clamp(self.op(key), proposal)

    def predict(self, key: int, threads: int, variant: bool) -> float:
        return self.store.predict(self.op(key), threads, variant)

    def observe(self, key: int, sched: ScheduledOp, kind: str,
                elapsed: float) -> None:
        self.store.observe(OpObservation(
            op=sched.op, threads=sched.threads, variant=sched.variant,
            hyper=sched.hyper, predicted=sched.predicted,
            observed=elapsed, kind=kind))
        if self.sink.enabled:
            corrections = getattr(self.store, "corrections", None)
            self.sink.emit(TraceEvent(
                ts=self.sim.clock, family=FAM_PLANSTORE, kind=kind, key=key,
                data={"op_class": sched.op.op_class,
                      "size_key": sched.op.size_key,
                      "threads": sched.threads, "variant": sched.variant,
                      "hyper": sched.hyper, "predicted": sched.predicted,
                      "observed": elapsed,
                      "correction": (corrections.factor(
                          cross_graph_key(sched.op), sched.threads,
                          sched.variant)
                          if corrections is not None else 1.0)}))

    def commit(self, key: int, sched: ScheduledOp) -> None:
        self.sim.ready.remove(key)
        self.sim.launch(key, sched)

    def charge(self, key: int, sched: ScheduledOp) -> None:
        # no service accounting for a single graph, but the same quadrant
        # affinity the pool keeps per tenant (primary quadrant of the last
        # placed launch) — one graph is one tenant, and the single-job
        # pool must stay bit-identical to this scheduler under EVERY
        # topology, so both adapters must answer placement_hint alike
        if sched.cores and self._spec is not None:
            self._last_quadrant = self._spec.quadrant_of_core(
                sched.cores[0])

    def placement_hint(self, key: int) -> int | None:
        return self._last_quadrant


class CorunScheduler:
    """Thin single-graph adapter over ``StrategyCore``."""

    def __init__(self, machine: SimMachine, controller: ConcurrencyController,
                 plan: ConcurrencyPlan, *,
                 recorder: InterferenceRecorder | None = None,
                 total_cores: int | None = None,
                 enable_s3: bool = True, enable_s4: bool = True,
                 strategy2: bool = True, max_ht_corunners: int = 2,
                 candidates: int = 3, min_fallback_cores: int = 4,
                 fallback_slack: float = 1.25, topology: str = "flat",
                 feedback: str = "off", sink: TraceSink = NULL_SINK,
                 planstore: PlanStore | None = None):
        self.machine = machine
        self.controller = controller
        self.plan = plan
        self.strategy2 = strategy2
        # the closed-loop plan store every prediction/observation flows
        # through; callers (ConcurrencyRuntime) usually inject one so the
        # store outlives a single scheduler, but a direct construction
        # gets its own from the feedback knob
        self.planstore = planstore if planstore is not None \
            else make_plan_store(feedback, controller)
        self.core = StrategyCore(
            machine,
            StrategyConfig(enable_s3=enable_s3, enable_s4=enable_s4,
                           candidates=candidates,
                           max_ht_corunners=max_ht_corunners,
                           min_fallback_cores=min_fallback_cores,
                           fallback_slack=fallback_slack,
                           topology=topology, feedback=feedback,
                           sink=sink),
            recorder=recorder, total_cores=total_cores)

    @property
    def recorder(self) -> InterferenceRecorder:
        return self.core.recorder

    @property
    def cores(self) -> int:
        return self.core.cores

    def adapter(self, sim: _EventSim) -> _GraphAdapter:
        return _GraphAdapter(sim, self.controller, self.plan,
                             strategy2=self.strategy2,
                             spec=self.machine.spec,
                             store=self.planstore,
                             sink=self.core.sink)

    # ------------------------------------------------------------------
    def _drain_region_events(self, sim: _EventSim,
                             adapter: _GraphAdapter) -> None:
        """Report region shape changes: resolutions feed the store's
        trip-count learning; every event traces under FAM_REGION."""
        while sim.region_events:
            ev = sim.region_events.pop(0)
            if ev.kind == "resolve" and ev.outcome is not None:
                adapter.store.observe_region(ev.region, ev.outcome)
            if self.core.sink.enabled:
                self.core.sink.emit(TraceEvent(
                    ts=sim.clock, family=FAM_REGION, kind=ev.kind,
                    key=ev.region.rid,
                    data={"region": ev.region.kind,
                          "region_key": str(ev.region.key),
                          "new_ops": len(ev.new_uids),
                          **({"outcome": ev.outcome}
                             if ev.outcome is not None else {}),
                          **({"trips": ev.region.trips_started}
                             if ev.region.kind == "while" else {})}))

    def run(self, graph: OpGraph) -> ScheduleResult:
        sim = _EventSim(graph)
        adapter = self.adapter(sim)
        # freeze the interference blacklist for this step; observations
        # recorded now take effect on the NEXT run (paper §III-D: avoid
        # recorded pairs "in the future training steps")
        self.core.begin_run()
        self._drain_region_events(sim, adapter)
        while not sim.done:
            self.core.drain(adapter)
            if sim.running:
                sched = sim.complete_next()
                # close the loop: the completion's service time flows
                # back into the plan store (no-op under feedback="off")
                adapter.observe(sched.op.uid, sched, OBS_FINISH,
                                sched.duration)
                self._drain_region_events(sim, adapter)
        return ScheduleResult(makespan=sim.clock, records=sim.records,
                              events=sim.events)


# ---------------------------------------------------------------------------
# TensorFlow-style baseline: fixed inter/intra parallelism, FIFO.
# ---------------------------------------------------------------------------

def _oversubscription_penalty(total_threads: int, cores: int) -> float:
    r = total_threads / cores
    if r <= 1.0:
        return 1.0
    return 0.45 + 0.55 * r      # calibrated to the paper's Table I ratios


def uniform_schedule(graph: OpGraph, machine: SimMachine, *,
                     intra: int, inter: int,
                     cache_sharing: bool = True) -> ScheduleResult:
    """Fixed (inter, intra) FIFO execution — the paper's baseline runtime.

    ``inter`` concurrent lanes, every op with ``intra`` threads.  If
    inter*intra oversubscribes the physical cores, every running op pays
    the oversubscription penalty (thread time-slicing + management)."""
    sim = _EventSim(graph)
    penalty = _oversubscription_penalty(
        inter * intra, machine.spec.cores)
    while not sim.done:
        while sim.ready and len(sim.running) < inter:
            uid = sim.ready.popleft()              # FIFO, as TF's executor
            op = graph.ops[uid]
            n_running = len(sim.running) + 1
            pl = Placement(min(intra, machine.spec.cores),
                           cache_sharing=cache_sharing)
            dur = machine.op_time(op, pl, bw_share=1.0 / n_running) * penalty
            sched = ScheduledOp(op=op, threads=intra, variant=cache_sharing,
                                hyper=False, start=sim.clock,
                                finish=sim.clock + dur, predicted=dur)
            sim.launch(uid, sched)
        if sim.running:
            sim.complete_next()
    return ScheduleResult(makespan=sim.clock, records=sim.records,
                          events=sim.events)


def manual_best_schedule(graph: OpGraph, machine: SimMachine,
                         inters: tuple[int, ...] = (1, 2, 4),
                         intras: tuple[int, ...] = (17, 34, 68)
                         ) -> tuple[ScheduleResult, tuple[int, int]]:
    """The paper's 'manual optimization': exhaustive uniform grid search."""
    best: tuple[ScheduleResult, tuple[int, int]] | None = None
    for inter in inters:
        for intra in intras:
            res = uniform_schedule(graph, machine, intra=intra, inter=inter)
            if best is None or res.makespan < best[0].makespan:
                best = (res, (inter, intra))
    assert best is not None
    return best
