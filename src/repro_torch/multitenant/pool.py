"""Runtime pool: co-schedule many op graphs on one simulated machine.

This generalizes the paper's runtime from *one step graph* to *many
tenants*.  The Strategy-2/3/4 decision RULES are not re-implemented here:
they live once in ``repro_torch.core.strategy.StrategyCore`` (shared with the
single-graph ``CorunScheduler``), and ``PoolScheduler`` is the multi-job
adapter over them — its ``_PoolAdapter`` injects the job-aware pieces:
the candidate source draws ready ops from every admitted job's frontier
(tenants ordered by weighted fair share), the Strategy-2 clamp applies
each op's **own job's** frozen plan, Strategy 4's hyper-thread lane picks
the globally smallest ready op, and the interference blacklist spans
co-runners from different jobs (a class pair that thrashes MCDRAM thrashes
it regardless of which tenant launched each side).  A single-job pool
therefore reproduces ``CorunScheduler`` timelines exactly — enforced by
``repro_torch.multitenant.parity`` and ``tests/test_strategy_differential.py``.

Cross-job decisions need a currency; following value-function schedulers
(Steiner et al.) we use the ``perfmodel`` predictions behind each job's
plan: a job's *demand* is its predicted core-seconds, its *service* the
core-seconds actually granted, and the pool always prefers the job with
the smallest priority-weighted service (weighted fair share).  Service is
charged at launch so the share is responsive within one scheduling
instant; hyper-thread launches are charged at the machine's hyper-thread
efficiency (they borrow spare lanes, not whole cores).

Every prediction flows through each job's closed-loop ``PlanStore``
(``repro_torch.core.planstore``): with ``feedback="off"`` (default) that is
the frozen profiling-time plan, bit-for-bit the pre-feedback pool; with
``feedback="ewma"`` the pool's launch/finish/revoke observations blend
back into one pool-wide ``CorrectionTable`` and ``Job.demand``/``Job.cp``
are re-derived as ops complete (and re-priced for waiting jobs before
every admission decision), so the admission cap and deadline slack track
observed reality when profiles mispredict.

Deadlines ride on top of fair share: a job may carry an absolute
``deadline``, priced into per-node slack via its frozen-plan critical
path (``Job.cp``).  The pool adds slack-expiry wakeups to the event loop
and, when ``PoolConfig.preemption`` is enabled, the shared core's
``try_preempt`` path may revoke the longest-remaining running op for an
overdue tenant (``_PoolSim.revoke``: the victim node returns to its ready
frontier, its partial run is recorded in ``preempted``, and its service
is re-billed at the machine's restart-waste factor).  With preemption off
AND no deadlines — the defaults — every timeline is bit-for-bit the PR-2
pool's; deadlines alone already reorder scheduling (EDF admission, the
slack-scaled fair-share key), preemption additionally revokes.

``RuntimePool`` is the driver: submit jobs (graph + priority + arrival
time + optional deadline), run, get a ``PoolResult`` with per-job
latency, fairness, preemption, and plan-cache amortization stats.
``RuntimePool.run_serial`` replays the same job mix one graph at a time —
the baseline the multitenant benchmarks compare against.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Iterator, Mapping, Sequence

from repro_torch.core.concurrency import OpPlan
from repro_torch.core.graph import Op, OpGraph, RegionEvent
from repro_torch.core.interference import InterferenceRecorder
from repro_torch.core.perfmodel import cross_graph_key
from repro_torch.core.planstore import (OBS_FINISH, OBS_REVOKE, CorrectionTable,
                                  OpObservation, TripCountEstimator,
                                  make_plan_store)
from repro_torch.obs.metrics import pool_metrics
from repro_torch.obs.trace import (FAM_ADMISSION, FAM_PLANSTORE, FAM_PREEMPTION,
                             FAM_REGION, FAM_STRATEGY, NULL_SINK, TraceEvent,
                             TraceSink)
from repro_torch.core.runtime import ConcurrencyRuntime, RuntimeConfig
from repro_torch.core.simmachine import SimMachine
from repro_torch.core.strategy import (CONFIG_SCHEMA_VERSION, PreemptionPolicy,
                                 ScheduledOp, ScheduleResult,
                                 StrategyAdapter, StrategyConfig,
                                 StrategyCore, _check_config_dict,
                                 fold_deprecated_strategy_kwargs)
from repro_torch.multitenant.job import Job, JobQueue, fairness_index, jain
from repro_torch.multitenant.plancache import PlanCache

NodeKey = tuple[int, int]           # (jid, uid)


@dataclasses.dataclass(init=False)
class PoolConfig:
    """Pool-level knobs (admission + reservation), composed with the
    per-job ``RuntimeConfig`` so every profiling/strategy knob lives in
    exactly one place and the pool's delegated runtimes see the same
    settings.

    Strategy-owned knobs (preemption, topology, feedback, fallback
    floors, sink) are NOT re-declared here: set them on
    ``runtime.strategy``, or pass ``strategy=StrategyConfig(...)`` to
    give the POOL a deliberately different policy than its per-job
    runtimes (``strategy=None`` inherits ``runtime``'s).  The old flat
    kwargs (``PoolConfig(preemption=..., feedback="ewma")``) keep
    working with a DeprecationWarning — non-None ones fold onto the
    pool's strategy view, preserving the old override-only-when-set
    semantics."""

    max_active: int = 3             # admission: concurrent tenants
    max_outstanding_demand: float | None = None   # admission: core-seconds
    # hold the last active slot for a strictly-higher-priority deadlined
    # arrival due within this many seconds (0 = no reservation)
    reservation_window: float = 0.0
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)
    # pool-level strategy override; None = inherit runtime.strategy
    strategy: StrategyConfig | None = None

    def __init__(self, max_active: int = 3,
                 max_outstanding_demand: float | None = None,
                 reservation_window: float = 0.0,
                 runtime: RuntimeConfig | None = None,
                 strategy: StrategyConfig | None = None, **deprecated):
        self.max_active = max_active
        self.max_outstanding_demand = max_outstanding_demand
        self.reservation_window = reservation_window
        self.runtime = runtime if runtime is not None else RuntimeConfig()
        unknown = sorted(set(deprecated)
                         - {f.name for f in
                            dataclasses.fields(StrategyConfig)})
        if unknown:
            raise TypeError(
                f"PoolConfig() got unexpected keyword arguments {unknown}")
        # the old flat kwargs defaulted to None = "inherit from runtime":
        # only explicitly-set ones override, so drop Nones before folding
        overrides = {k: v for k, v in deprecated.items() if v is not None}
        if overrides:
            base = (strategy if strategy is not None
                    else self.runtime.strategy_config())
            strategy = fold_deprecated_strategy_kwargs(
                type(self).__name__, base, overrides)
        self.strategy = strategy

    def strategy_config(self) -> StrategyConfig:
        """Same StrategyConfig RuntimeConfig.strategy_config returns —
        one shared core, one knob set, no drift: a single-job pool stays
        bit-identical to CorunScheduler for ANY RuntimeConfig.  A
        pool-level ``strategy`` applies only when explicitly set."""
        if self.strategy is not None:
            return self.strategy
        return self.runtime.strategy_config()

    def to_dict(self) -> dict:
        """Versioned JSON form — what the service daemon persists in its
        job store and what the CLI accepts, one serialization for all
        three layers."""
        return {"schema": CONFIG_SCHEMA_VERSION,
                "max_active": self.max_active,
                "max_outstanding_demand": self.max_outstanding_demand,
                "reservation_window": self.reservation_window,
                "runtime": self.runtime.to_dict(),
                "strategy": (None if self.strategy is None
                             else self.strategy.to_dict())}

    @classmethod
    def from_dict(cls, d) -> "PoolConfig":
        d = dict(d)
        rt, strat = d.pop("runtime", None), d.pop("strategy", None)
        kw = _check_config_dict(
            cls.__name__, d,
            {"max_active", "max_outstanding_demand", "reservation_window"})
        if rt is not None:
            kw["runtime"] = RuntimeConfig.from_dict(rt)
        if strat is not None:
            kw["strategy"] = StrategyConfig.from_dict(strat)
        return cls(**kw)


class PoolObserver:
    """Execution-backend hook points on the pool's discrete-event loop.

    The service daemon attaches one to mirror sim decisions onto REAL
    payload execution: a launch submits the op's payload to the shared
    worker set, a revoke cancels the payload future before it starts,
    and a completion collects it.  Every method is a no-op by default
    and the pool never behaves differently for having an observer — the
    sim timeline stays bit-for-bit the unobserved one (the observer
    sees decisions; it does not make them)."""

    def on_launch(self, key: NodeKey, sched: ScheduledOp) -> None:
        pass

    def on_revoke(self, key: NodeKey, sched: ScheduledOp) -> None:
        pass

    def on_complete(self, key: NodeKey, sched: ScheduledOp) -> None:
        pass


class _PoolSim:
    """Discrete-event state over many graphs — the multi-tenant EventSim.

    Same launch/complete/event conventions as ``core.scheduler.EventSim``
    but nodes are ``(jid, uid)`` and each job keeps its own pending/ready
    frontier so per-job dependency tracking never crosses tenants."""

    def __init__(self) -> None:
        self.clock = 0.0
        self.observer: PoolObserver | None = None
        self.graphs: dict[int, OpGraph] = {}
        self.jobs: dict[int, Job] = {}              # jid -> admitted job
        self.pending: dict[int, dict[int, int]] = {}
        self.ready: dict[int, list[int]] = {}       # jid -> ready uids
        self.heap: list[tuple[float, int, NodeKey]] = []
        self.running: dict[NodeKey, ScheduledOp] = {}
        self.records: dict[int, list[ScheduledOp]] = {}
        # jid -> completed uids (maintained incrementally: the feedback
        # path re-derives remaining demand/critical-paths on every
        # completion and must not rebuild this set from records each time)
        self.completed: dict[int, set[int]] = {}
        # jid -> partial runs cut short by preemption (finish = revoke
        # time); kept OUT of ``records`` so "every op exactly once"
        # invariants keep holding on the completed timeline
        self.preempted: dict[int, list[ScheduledOp]] = {}
        self.events: list[tuple[float, int]] = []
        # (jid, RegionEvent) shape changes not yet reported to the pool
        # driver (which traces them, feeds trip-count learning, and
        # re-prices the job); empty for every static graph
        self.region_events: list[tuple[int, RegionEvent]] = []
        self._seq = itertools.count()
        self._live_seq: dict[NodeKey, int] = {}     # key -> heap entry seq
        self._cancelled: set[int] = set()           # revoked heap seqs

    def admit(self, job: Job) -> None:
        g = job.graph
        self.graphs[job.jid] = g
        self.jobs[job.jid] = job
        # restore dynamic graphs to their initial shape (entry-free
        # regions expand now, BEFORE the frontier is derived); a no-op []
        # on static graphs
        for ev in g.reset():
            self.region_events.append((job.jid, ev))
        self.pending[job.jid] = {u: len(op.deps) for u, op in g.ops.items()}
        self.ready[job.jid] = sorted(g.sources())
        self.records[job.jid] = []
        self.completed[job.jid] = set()
        self.preempted[job.jid] = []

    def op(self, key: NodeKey) -> Op:
        return self.graphs[key[0]].ops[key[1]]

    def ready_keys(self) -> list[NodeKey]:
        return [(jid, uid) for jid, uids in self.ready.items()
                for uid in uids]

    def launch(self, key: NodeKey, sched: ScheduledOp) -> None:
        self.ready[key[0]].remove(key[1])
        self.running[key] = sched
        seq = next(self._seq)
        self._live_seq[key] = seq
        heapq.heappush(self.heap, (sched.finish, seq, key))
        self.events.append((self.clock, len(self.running)))
        if self.observer is not None:
            self.observer.on_launch(key, sched)

    def revoke(self, key: NodeKey) -> ScheduledOp:
        """Preempt a running launch: the node goes back to its job's ready
        frontier (exactly once — it is no longer running, so no other path
        can return it again) and the heap entry is lazily cancelled.
        Under quadrant topology the victim's core set is released at this
        instant by construction: placement derives occupancy from the
        running set, which no longer contains the victim (its partial
        record in ``preempted`` keeps the cores for occupancy audits)."""
        sched = self.running.pop(key)
        self._cancelled.add(self._live_seq.pop(key))
        self.ready[key[0]].append(key[1])
        self.preempted[key[0]].append(
            dataclasses.replace(sched, finish=self.clock))
        self.jobs[key[0]].preemptions += 1
        self.events.append((self.clock, len(self.running)))
        if self.observer is not None:
            self.observer.on_revoke(key, sched)
        return sched

    def next_finish(self) -> float | None:
        """Earliest live completion time (revoked heap entries skipped)."""
        while self.heap and self.heap[0][1] in self._cancelled:
            self._cancelled.discard(self.heap[0][1])
            heapq.heappop(self.heap)
        return self.heap[0][0] if self.heap else None

    def complete_next(self) -> tuple[int, ScheduledOp]:
        # prune revoked entries unconditionally — the heap head must be a
        # LIVE launch before popping (an assert would be stripped by -O)
        if self.next_finish() is None:
            raise RuntimeError("complete_next on an empty/revoked heap")
        finish, _, key = heapq.heappop(self.heap)
        self.clock = finish
        jid, uid = key
        self._live_seq.pop(key, None)
        sched = self.running.pop(key)
        self.records[jid].append(sched)
        self.completed[jid].add(uid)
        for c in self.graphs[jid].consumers(uid):
            self.pending[jid][c] -= 1
            if self.pending[jid][c] == 0:
                self.ready[jid].append(c)
        # dynamic graphs may materialize ops at this instant (next loop
        # iteration, taken branch, region exit); absorb them into the
        # job's frontier — their gate deps are already complete, so no
        # consumer decrement will ever arrive for those edges
        for ev in self.graphs[jid].advance(uid, self.completed[jid]):
            self.region_events.append((jid, ev))
            for u in ev.new_uids:
                op = self.graphs[jid].ops[u]
                n = sum(1 for d in op.deps
                        if d not in self.completed[jid])
                self.pending[jid][u] = n
                if n == 0:
                    self.ready[jid].append(u)
        self.events.append((self.clock, len(self.running)))
        if self.observer is not None:
            self.observer.on_complete(key, sched)
        return jid, sched

    def drop_job(self, jid: int) -> list[ScheduledOp]:
        """Remove one tenant from the event loop (job cancellation).

        Running launches are lazily cancelled exactly like ``revoke`` —
        the observer's ``on_revoke`` fires so a payload backend cancels
        the futures — but they do NOT count as preemptions or return to
        a ready frontier: the tenant is leaving, not restarting.  The
        job's completed records/partials stay behind for accounting (the
        work really ran); only its scheduling state goes.  Launch-time
        service charges stay on the cancelled tenant's ledger — the pool
        priced those cores out to it, and a cancel does not retroactively
        make them free."""
        dropped = []
        for key in [k for k in self.running if k[0] == jid]:
            sched = self.running.pop(key)
            self._cancelled.add(self._live_seq.pop(key))
            dropped.append(sched)
            if self.observer is not None:
                self.observer.on_revoke(key, sched)
        for d in (self.graphs, self.jobs, self.pending, self.ready):
            d.pop(jid, None)
        self.events.append((self.clock, len(self.running)))
        return dropped

    def job_done(self, jid: int) -> bool:
        return (not self.ready[jid]
                and not any(k[0] == jid for k in self.running))

    @property
    def any_ready(self) -> bool:
        return any(self.ready.values())


@dataclasses.dataclass
class PoolResult:
    makespan: float
    jobs: list[Job]
    records: dict[int, list[ScheduledOp]]      # jid -> per-op records
    events: list[tuple[float, int]]            # (time, #co-running)
    cache_stats: dict[str, float]
    # jid -> partial runs cut short by preemption (finish = revoke time)
    preempted: dict[int, list[ScheduledOp]] = dataclasses.field(
        default_factory=dict)
    # CorrectionTable.stats() of the pool's shared EWMA state (None when
    # the pool ran with feedback="off")
    feedback_stats: dict[str, float] | None = None
    # dynamic-control-flow shape changes during the run (0 on every
    # static mix): while-iterations materialized / regions resolved
    n_region_expands: int = 0
    n_region_resolves: int = 0
    # flat metric snapshot of the run (repro_torch.obs.metrics.pool_metrics):
    # the one accounting surface benches/CLI consume instead of each
    # re-deriving its own sums from records
    metrics: dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def total_ops(self) -> int:
        return sum(len(r) for r in self.records.values())

    @property
    def n_preemptions(self) -> int:
        return sum(len(r) for r in self.preempted.values())

    @property
    def n_evictions(self) -> int:
        """Admission-level evictions across all jobs (free moves — the
        evicted tenant had no launched ops, so no restart waste)."""
        return sum(j.evictions for j in self.jobs)

    @property
    def n_migrations(self) -> int:
        """Width migrations across all jobs (these launches also appear in
        ``preempted`` as partial records — the sim bills them the same
        way — but they were immediately relaunched at a new width)."""
        return sum(j.migrations for j in self.jobs)

    @property
    def aggregate_throughput(self) -> float:
        """Ops completed per second across all tenants."""
        return self.total_ops / max(self.makespan, 1e-12)

    @property
    def fairness(self) -> float:
        return fairness_index(self.jobs)

    def slowdowns(self, solo_makespans: dict[int, float], *,
                  include_queue_wait: bool = True) -> list[float]:
        """Per-finished-job slowdown vs running alone.

        ``include_queue_wait=True`` divides submit-to-finish latency by the
        solo makespan — the tenant's end-to-end view, which charges the
        scheduler for admission delay too.  ``False`` divides admit-to-
        finish, isolating what the SCHEDULER did to the job once it was
        actually inside the pool: a job that merely sat in the admission
        queue is not evidence of unfair scheduling."""
        out = []
        for j in self.jobs:
            if not j.done or j.jid not in solo_makespans:
                continue
            lat = j.latency if include_queue_wait else j.run_latency
            if lat is None:
                continue
            out.append(lat / max(solo_makespans[j.jid], 1e-12))
        return out

    def slowdown_fairness(self, solo_makespans: dict[int, float], *,
                          include_queue_wait: bool = True) -> float:
        """Jain index over per-job slowdown (pool latency / makespan the
        job would have alone).  Unlike cumulative-service ``fairness``,
        this measures what the scheduler DID: a tenant starved for most of
        the run carries a large slowdown and drags the index toward 1/n.
        Report the queue-inclusive and admit-to-finish variants side by
        side (``include_queue_wait``): a gap between them localizes the
        unfairness to the admission tier rather than the core scheduler."""
        return jain(self.slowdowns(solo_makespans,
                                   include_queue_wait=include_queue_wait))

    @property
    def mean_latency(self) -> float:
        """Mean submit-to-finish latency over FINISHED jobs, or NaN when
        no job finished — a run where nothing completed must not report
        the same 0.0 as a perfect one (NaN also poisons any aggregate
        a bench builds from it, so the failure can't hide)."""
        lats = [j.latency for j in self.jobs if j.latency is not None]
        if not lats:
            return float("nan")
        return sum(lats) / len(lats)

    def per_job_schedule(self, jid: int) -> ScheduleResult:
        """One job's records in the single-graph result type (global
        timestamps), so existing analysis/plot helpers apply unchanged.
        The events timeline is rebuilt from THIS job's records — the
        pool-wide timeline would misreport the job's own concurrency."""
        recs = self.records[jid]
        deltas = sorted([(r.start, 1) for r in recs]
                        + [(r.finish, -1) for r in recs])
        events: list[tuple[float, int]] = []
        n = 0
        for t, d in deltas:
            n += d
            events.append((t, n))
        return ScheduleResult(
            makespan=max((r.finish for r in recs), default=0.0),
            records=recs, events=events)


class _PoolAdapter(StrategyAdapter):
    """Multi-job view for ``StrategyCore``: node keys are ``(jid, uid)``,
    the candidate source yields one ready group per admitted job —
    most-owed tenant first (weighted fair share) — and every plan lookup
    resolves against the node's OWN job's frozen plan/controller (the
    job-aware Strategy-2 clamp).  ``charge`` implements launch-time
    fair-share accounting; hyper-thread launches are charged at the
    machine's hyper-thread efficiency (they borrow spare lanes, not whole
    cores)."""

    def __init__(self, sim: _PoolSim, machine: SimMachine, *,
                 strategy2: bool, sink: TraceSink = NULL_SINK):
        self.sim = sim
        self.machine = machine
        self.strategy2 = strategy2
        self.sink = sink

    @property
    def clock(self) -> float:
        return self.sim.clock

    @property
    def running(self) -> Mapping[NodeKey, ScheduledOp]:
        return self.sim.running

    def _job(self, key: NodeKey) -> Job:
        return self.sim.jobs[key[0]]

    def ready_groups(self) -> list[Sequence[NodeKey]]:
        # jobs owed service first; only jobs with ready ops (a job with a
        # non-empty frontier is necessarily still active).  The ordering
        # key uses the DYNAMIC (slack-scaled) priority, so a tenant whose
        # deadline is approaching drifts toward the front of the line;
        # for deadline-free jobs this is exactly the old static key.
        now = self.sim.clock
        jobs = sorted((j for j in self.sim.jobs.values()
                       if self.sim.ready[j.jid]),
                      key=lambda j: (j.virtual_time_at(now), j.jid))
        return [[(j.jid, u) for u in self.sim.ready[j.jid]] for j in jobs]

    def op(self, key: NodeKey) -> Op:
        return self.sim.op(key)

    def instance_plan(self, key: NodeKey) -> OpPlan:
        job = self._job(key)
        assert job.plan is not None and job.store is not None
        op = self.sim.op(key)
        # the store re-prices the frozen plan's width (corrected under
        # feedback="ewma", verbatim curve prediction under "off")
        return job.store.replan(op, job.plan.plan_for(
            op, strategy2=self.strategy2))

    def candidates_for(self, key: NodeKey, k: int) -> list[OpPlan]:
        job = self._job(key)
        assert job.store is not None
        return job.store.candidates(self.sim.op(key), k)

    def clamp(self, key: NodeKey, proposal: OpPlan) -> OpPlan:
        job = self._job(key)
        assert job.plan is not None
        return job.plan.clamp(self.sim.op(key), proposal)   # job-aware S2

    def predict(self, key: NodeKey, threads: int, variant: bool) -> float:
        job = self._job(key)
        assert job.store is not None
        return job.store.predict(self.sim.op(key), threads, variant)

    def commit(self, key: NodeKey, sched: ScheduledOp) -> None:
        self.sim.launch(key, sched)

    def charge(self, key: NodeKey, sched: ScheduledOp) -> None:
        # weighted fair share: charge core-seconds at launch time
        eff = (self.machine.spec.hyper_thread_efficiency
               if sched.hyper else 1.0)
        job = self._job(key)
        amount = sched.threads * sched.duration * eff
        job.service += amount
        if self.sink.enabled:
            self.sink.emit(TraceEvent(
                ts=self.sim.clock, family=FAM_STRATEGY, kind="charge",
                key=key, data={"jid": job.jid, "job": job.name,
                               "priority": job.priority, "amount": amount,
                               "service": job.service}))
        if sched.cores:
            # tenant-to-quadrant affinity: remember where the job landed
            # (the primary quadrant — placement fills it first) so its
            # next launches prefer the quadrant its working set warms
            job.last_quadrant = self.machine.spec.quadrant_of_core(
                sched.cores[0])

    def placement_hint(self, key: NodeKey) -> int | None:
        return self._job(key).last_quadrant

    # ---- closed-loop observation ----------------------------------------
    def observe(self, key: NodeKey, sched: ScheduledOp, kind: str,
                elapsed: float) -> None:
        """Forward the event to the job's plan store and — when the store
        is adaptive — re-derive the aggregates the pool caches on the Job:
        remaining demand (the admission/fair-share currency tightens or
        relaxes as observations land and ops complete) and per-node
        critical paths (so deadline slack prices REMAINING work at
        observed speeds, not the frozen profiling-time guess — the
        ROADMAP's stale-``Job.cp`` item)."""
        job = self._job(key)
        assert job.store is not None
        job.store.observe(OpObservation(
            op=sched.op, threads=sched.threads, variant=sched.variant,
            hyper=sched.hyper, predicted=sched.predicted,
            observed=elapsed, kind=kind))
        if self.sink.enabled:
            corrections = getattr(job.store, "corrections", None)
            self.sink.emit(TraceEvent(
                ts=self.sim.clock, family=FAM_PLANSTORE, kind=kind,
                key=key,
                data={"op_class": sched.op.op_class,
                      "size_key": sched.op.size_key,
                      "threads": sched.threads, "variant": sched.variant,
                      "hyper": sched.hyper, "predicted": sched.predicted,
                      "observed": elapsed,
                      "correction": (corrections.factor(
                          cross_graph_key(sched.op), sched.threads,
                          sched.variant)
                          if corrections is not None else 1.0)}))
        if job.store.adaptive and kind in (OBS_FINISH, OBS_REVOKE):
            assert job.plan is not None
            done = self.sim.completed[key[0]]
            job.demand = job.store.remaining_demand(job.graph, job.plan,
                                                    done)
            job.cp = job.store.remaining_critical_path(job.graph, job.plan,
                                                       done)

    # ---- deadlines / preemption ----------------------------------------
    def deadline_slack(self, key: NodeKey) -> float | None:
        job = self._job(key)
        if job.deadline is None:
            return None
        # time to the SLO minus the node's predicted downstream critical
        # path: <= 0 means this tenant misses its deadline even if granted
        # cores right now — the preemption trigger
        return job.deadline - self.sim.clock - job.cp.get(key[1], 0.0)

    def revoke(self, key: NodeKey) -> ScheduledOp:
        return self.sim.revoke(key)

    def refund(self, key: NodeKey, sched: ScheduledOp,
               elapsed: float) -> None:
        # reverse the launch-time charge; bill the discarded partial run at
        # the machine's restart-waste factor instead (the victim occupied
        # cores, but the scheduler chose to throw that work away)
        eff = (self.machine.spec.hyper_thread_efficiency
               if sched.hyper else 1.0)
        job = self._job(key)
        refund = sched.threads * sched.duration * eff
        waste = (sched.threads * elapsed * eff
                 * self.machine.spec.restart_waste)
        job.service -= refund
        job.service += waste
        if self.sink.enabled:
            self.sink.emit(TraceEvent(
                ts=self.sim.clock, family=FAM_STRATEGY, kind="refund",
                key=key, data={"jid": job.jid, "job": job.name,
                               "priority": job.priority, "refund": refund,
                               "waste": waste, "elapsed": elapsed}))

    def migrated(self, key: NodeKey, revoked: ScheduledOp) -> None:
        # the sim-level revoke already counted a preemption; migrations
        # get their own per-job counter so reporting can tell a priced
        # width re-seat from an SLO revoke
        self._job(key).migrations += 1


class PoolScheduler:
    """Thin multi-job adapter over ``StrategyCore`` (Strategies 3/4 across
    every admitted job's ready frontier, job-aware S2 clamp, cross-job
    interference blacklist, weighted fair share)."""

    def __init__(self, machine: SimMachine, config: PoolConfig, *,
                 recorder: InterferenceRecorder):
        self.machine = machine
        self.config = config
        self.recorder = recorder
        self.core = StrategyCore(machine, config.strategy_config(),
                                 recorder=recorder)
        self.cores = self.core.cores

    def adapter(self, sim: _PoolSim) -> _PoolAdapter:
        return _PoolAdapter(sim, self.machine,
                            strategy2=self.config.runtime.strategy2,
                            sink=self.core.sink)

    # Strategy entry points kept as the public seam (delegating to the
    # shared core); ``active`` is accepted for compatibility but the ready
    # frontier is derived from the sim's admitted jobs.
    def try_corun(self, sim: _PoolSim,
                  active: list[Job] | None = None) -> bool:
        return self.core.try_corun(self.adapter(sim))

    def run_biggest(self, sim: _PoolSim,
                    active: list[Job] | None = None) -> bool:
        return self.core.run_biggest(self.adapter(sim))

    def try_hyper(self, sim: _PoolSim,
                  active: list[Job] | None = None) -> bool:
        return self.core.try_hyper(self.adapter(sim))


@dataclasses.dataclass
class SerialResult:
    """The run-one-graph-at-a-time baseline over the same job mix."""

    makespan: float
    job_makespans: dict[int, float]
    job_latencies: dict[int, float]
    total_ops: int
    profiling_probes: int

    @property
    def aggregate_throughput(self) -> float:
        return self.total_ops / max(self.makespan, 1e-12)


class RuntimePool:
    """Admission + pool scheduling driver (the multi-tenant Fig-2 loop)."""

    def __init__(self, machine: SimMachine | None = None,
                 config: PoolConfig | None = None,
                 plan_cache: PlanCache | None = None,
                 profile_machine: SimMachine | None = None,
                 corrections: CorrectionTable | None = None,
                 trip_counts: TripCountEstimator | None = None,
                 jid_counter: Iterator[int] | None = None):
        self.machine = machine or SimMachine()
        self.config = config or PoolConfig()
        # profiling may run on a DIFFERENT timing context than execution
        # (stale curves, a drifted machine) — the misprediction scenario
        # the feedback="ewma" store exists to correct.  Default: profile
        # where you execute, the paper's setup.
        self.profile_machine = profile_machine or self.machine
        self.plan_cache = plan_cache if plan_cache is not None else PlanCache()
        self.recorder = InterferenceRecorder(
            threshold=self.config.runtime.interference_threshold)
        self.queue = JobQueue(
            max_active=self.config.max_active,
            max_outstanding_demand=self.config.max_outstanding_demand,
            reservation_window=self.config.reservation_window)
        self.scheduler = PoolScheduler(self.machine, self.config,
                                       recorder=self.recorder)
        # ONE correction table spans every tenant (keyed by the same
        # cross_graph_key the PlanCache shares curves under): an op class
        # one tenant's observations re-estimated is re-estimated for all
        strat = self.config.strategy_config()
        self.feedback = strat.feedback
        self.sink = strat.sink
        self._preemption = strat.preemption
        # seeded tables let a service daemon restart into the learned
        # state it persisted (see repro_torch.service) instead of cold tables
        self.corrections = (
            (corrections if corrections is not None else CorrectionTable())
            if self.feedback != "off" else None)
        # ONE trip-count estimator spans every tenant too (keyed by
        # region key): the second tenant running the same loop starts
        # with the learned trip count instead of its build-time prior
        self.trip_counts = (
            (trip_counts if trip_counts is not None
             else TripCountEstimator())
            if self.feedback != "off" else None)
        # (corrections.observed, trip_counts.observed) at last refresh
        self._refreshed_at = (0, 0)
        # region shape-change counters of the CURRENT run (reset by run())
        self._region_counts = {"expand": 0, "resolve": 0}
        self.jobs: list[Job] = []
        # a ClusterPool passes ONE shared counter to all member pools so
        # jids stay globally unique and a rebalanced job's new jid can
        # never collide with any machine's existing jobs
        self._jid = jid_counter if jid_counter is not None \
            else itertools.count()
        # execution-backend hooks mirrored onto the sim at begin();
        # None = pure simulation, zero overhead
        self.observer: PoolObserver | None = None
        # live lifecycle state (begin()/step()/result()); run() is the
        # one-shot convenience over these
        self._sim: _PoolSim | None = None
        self._active: list[Job] = []
        self._adapter: _PoolAdapter | None = None

    # ---- profiling (amortized through the shared PlanCache) ------------
    def _profile_job(self, job: Job, cache: PlanCache | None) -> None:
        # one profiling pipeline for both the pool and the per-step
        # runtime: delegate to ConcurrencyRuntime.profile (which also
        # binds the cache to this machine)
        rt = ConcurrencyRuntime(machine=self.profile_machine,
                                config=self.config.runtime,
                                plan_cache=cache)
        rt.profile(job.graph)
        assert rt.controller is not None and rt.plan is not None
        job.controller = rt.controller
        job.plan = rt.plan
        # the job's closed-loop plan store: frozen curves under
        # feedback="off", the pool-wide EWMA corrections under "ewma"
        job.store = make_plan_store(self.feedback, rt.controller,
                                    corrections=self.corrections,
                                    trip_counts=self.trip_counts)
        # predicted demand in core-seconds — the admission/fair-share
        # currency — and the per-node remaining-work estimate that prices
        # deadline slack, both DERIVED from the store (so a warm
        # correction table already informs admission of a new tenant)
        job.demand = job.store.remaining_demand(job.graph, job.plan)
        job.cp = job.store.remaining_critical_path(job.graph, job.plan)

    # ---- public API -----------------------------------------------------
    def submit(self, graph: OpGraph, *, priority: float = 1.0,
               name: str | None = None, submit_time: float = 0.0,
               deadline: float | None = None) -> Job:
        """``deadline`` is an ABSOLUTE time (same clock as submit_time);
        serving layers usually compute it as submit_time + latency target
        (see ``ServeEngine.submit_waves_to_pool``)."""
        job = Job(jid=next(self._jid), name=name or graph.name, graph=graph,
                  priority=priority, submit_time=submit_time,
                  deadline=deadline)
        traced = self.sink.enabled
        before = self.plan_cache.stats() if traced else None
        self._profile_job(job, self.plan_cache)
        if traced:
            after = self.plan_cache.stats()
            self.sink.emit(TraceEvent(
                ts=submit_time, family=FAM_PLANSTORE, kind="profile",
                key=job.jid,
                data={"job": job.name, "n_ops": len(graph.ops),
                      "demand": job.demand, "priority": priority,
                      "probes": after["probes_spent"]
                      - before["probes_spent"],
                      "cache_hits": after["hits"] - before["hits"]}))
        self.jobs.append(job)
        self.queue.submit(job)
        # mid-lifecycle submission (the service daemon's path): give the
        # arrival its admission decision at the CURRENT instant, exactly
        # as begin()'s initial pass would have — step()'s idle branch only
        # handles strictly-future arrivals
        if self._sim is not None:
            self._admit(self._sim, self._active)
        return job

    def _refresh_waiting_estimates(self) -> None:
        """Under ``feedback="ewma"``, re-derive every WAITING job's demand
        and critical paths from the shared correction table before an
        admission decision: a job profiled (and priced) before any
        observations landed would otherwise enter admission — and the
        deadline-slack check — with stale submit-time estimates, which is
        exactly the frozen-plan staleness the feedback loop exists to
        fix.  (Active jobs are refreshed by the observe path as their own
        ops complete.)  A no-op with feedback off or nothing observed
        yet, so the default pool is bit-for-bit unchanged; skipped when
        no NEW observation landed since the last refresh (a waiting job's
        estimates can only change through the correction table or —
        since regions resolve at runtime — the trip-count estimator, so
        region-resolution instants count as observations here too)."""
        if self.corrections is None:
            return
        stamp = (self.corrections.observed,
                 self.trip_counts.observed if self.trip_counts else 0)
        if stamp == (0, 0) or stamp == self._refreshed_at:
            return
        self._refreshed_at = stamp
        for job in self.queue.waiting_jobs():
            if job.store is not None and job.plan is not None:
                job.demand = job.store.remaining_demand(job.graph, job.plan)
                job.cp = job.store.remaining_critical_path(job.graph,
                                                           job.plan)

    # ---- admission-level eviction (preemption economics) ----------------
    def _root_slack(self, job: Job, now: float) -> float | None:
        """Whole-job deadline slack: time to the SLO minus the job's
        longest remaining critical path (None = best-effort)."""
        if job.deadline is None:
            return None
        return job.deadline - now - max(job.cp.values(), default=0.0)

    def _try_evict(self, sim: _PoolSim, active: list[Job]) -> bool:
        """The FREE preemption-economics move: return one admitted job
        with NO launched ops to the queue when that unblocks the admission
        of an overdue deadlined waiter.

        Zero restart waste by construction — the victim has no running
        launches, no completed records, and no revoked partials, so there
        is no work to discard and nothing to re-bill; it re-enters the
        queue under its original submit order (``JobQueue.readmit``).
        Tried by ``_admit`` BEFORE the running-work preemption path can
        act for the waiter: a free move always beats a priced one.  The
        victim must be strictly less late than the waiter (best-effort, or
        more slack), so eviction chains terminate and never ping-pong."""
        pol = self._preemption
        if not (pol.enabled and pol.evict_admitted) or not len(self.queue):
            return False
        now = sim.clock
        idle = [j for j in active
                if not sim.records[j.jid] and not sim.preempted[j.jid]
                and not any(k[0] == j.jid for k in sim.running)]
        # least-urgent victim first (lowest dynamic priority, then the
        # most recently admitted — it has the least claim on its slot)
        idle.sort(key=lambda j: (j.effective_priority(now),
                                 -(j.admit_time or 0.0), -j.jid))
        for victim in idle:
            rest = [j for j in active if j.jid != victim.jid]
            waiter = self.queue.peek_admissible(rest, now)
            if waiter is None:
                continue           # evicting this one unblocks nothing
            ws = self._root_slack(waiter, now)
            if ws is None or ws > 0.0:
                continue           # only an overdue SLO tenant justifies it
            vs = self._root_slack(victim, now)
            if vs is not None and vs <= ws:
                continue           # never bounce a tenant just as late
            if self.sink.enabled:
                self.sink.emit(TraceEvent(
                    ts=now, family=FAM_PREEMPTION, kind="evict",
                    key=victim.jid,
                    data={"job": victim.name, "waiter_jid": waiter.jid,
                          "waiter": waiter.name, "waiter_slack": ws,
                          "victim_slack": vs,
                          "queue_depth": len(self.queue)}))
            active.remove(victim)
            for d in (sim.graphs, sim.jobs, sim.pending, sim.ready,
                      sim.records, sim.completed, sim.preempted):
                d.pop(victim.jid, None)
            victim.admit_time = None
            victim.admitted_demand = None
            victim.evictions += 1
            self.queue.readmit(victim)
            return True
        return False

    # ---- dynamic control flow -------------------------------------------
    def _handle_region_events(self, sim: _PoolSim) -> None:
        """Drain the sim's pending region shape changes: trace each one
        (FAM_REGION), feed resolutions into the store's trip-count
        learning, and re-derive the affected job's ``demand``/``cp`` from
        its NEW shape — a loop exiting early frees reserved demand (the
        next ``_admit`` can wake blocked arrivals), a loop overrunning
        its estimate shrinks slack (the next slack-expiry wakeup can
        trigger the priced preemption/eviction moves).  Re-derivation
        runs for frozen stores too: the shape changed even if no
        prediction did.  A no-op on every static mix."""
        while sim.region_events:
            jid, ev = sim.region_events.pop(0)
            self._region_counts[ev.kind] += 1
            job = sim.jobs.get(jid)
            if job is None:
                continue
            if (ev.kind == "resolve" and ev.outcome is not None
                    and job.store is not None):
                job.store.observe_region(ev.region, ev.outcome)
            if self.sink.enabled:
                self.sink.emit(TraceEvent(
                    ts=sim.clock, family=FAM_REGION, kind=ev.kind,
                    key=(jid, ev.region.rid),
                    data={"job": job.name, "region": ev.region.kind,
                          "region_key": str(ev.region.key),
                          "new_ops": len(ev.new_uids),
                          **({"outcome": ev.outcome}
                             if ev.outcome is not None else {}),
                          **({"trips": ev.region.trips_started}
                             if ev.region.kind == "while" else {})}))
            if job.store is not None and job.plan is not None:
                done = sim.completed.get(jid, set())
                job.demand = job.store.remaining_demand(
                    job.graph, job.plan, done)
                job.cp = job.store.remaining_critical_path(
                    job.graph, job.plan, done)

    def _admit(self, sim: _PoolSim, active: list[Job]) -> None:
        self._refresh_waiting_estimates()
        traced = self.sink.enabled
        while True:
            job = self.queue.pop_admissible(active, now=sim.clock)
            if job is None:
                if self._try_evict(sim, active):
                    continue
                if traced:
                    # only arrived-but-blocked tenants are admission
                    # DECISIONS; an empty queue or not-yet-arrived jobs
                    # leave nothing to decide
                    cause = self.queue.block_cause(active, sim.clock)
                    if cause in ("max_active", "demand_cap", "reserved"):
                        self.sink.emit(TraceEvent(
                            ts=sim.clock, family=FAM_ADMISSION,
                            kind=("reserve" if cause == "reserved"
                                  else "defer"),
                            data={"cause": cause,
                                  "queue_depth": len(self.queue),
                                  "n_active": len(active),
                                  "outstanding": sum(j.demand
                                                     for j in active)}))
                return
            job.admit_time = sim.clock
            job.admitted_demand = job.demand
            if traced:
                self.sink.emit(TraceEvent(
                    ts=sim.clock, family=FAM_ADMISSION, kind="admit",
                    key=job.jid,
                    data={"job": job.name, "priority": job.priority,
                          "demand": job.demand, "deadline": job.deadline,
                          "queue_wait": sim.clock - job.submit_time,
                          "queue_depth": len(self.queue),
                          "n_active": len(active),
                          "outstanding": sum(j.demand for j in active)}))
            sim.admit(job)
            # entry-free regions expanded during admit: trace them and
            # re-price the job off its materialized shape
            self._handle_region_events(sim)
            if not sim.ready[job.jid]:      # zero-op graph: done on arrival
                job.finish_time = sim.clock
                continue
            active.append(job)

    def _next_slack_expiry(self, sim: _PoolSim) -> float | None:
        """Earliest strictly-future instant at which some admitted ready
        node's deadline slack reaches zero — an extra scheduling instant
        for the preemption path (slack goes negative BETWEEN completions;
        waiting for the next op boundary is exactly the head-of-line delay
        preemption exists to cut)."""
        expiry = None
        for jid, uids in sim.ready.items():
            job = sim.jobs[jid]
            if job.deadline is None:
                continue
            for uid in uids:
                t = job.deadline - job.cp.get(uid, 0.0)
                if t > sim.clock and (expiry is None or t < expiry):
                    expiry = t
        if self._preemption.enabled and self._preemption.evict_admitted:
            # with admission-level eviction armed, a QUEUED deadlined
            # tenant going overdue is a scheduling instant too — that is
            # the moment _try_evict may bounce an idle admitted job for
            # it.  A tenant already overdue at arrival expires the moment
            # it arrives (max with submit_time).
            for job in self.queue.waiting_jobs():
                if job.deadline is None:
                    continue
                t = max(job.submit_time,
                        job.deadline - max(job.cp.values(), default=0.0))
                if t > sim.clock and (expiry is None or t < expiry):
                    expiry = t
        return expiry

    def _next_decision_instant(self, sim: _PoolSim, active: list[Job],
                               horizon: float) -> float | None:
        """Earliest scheduling instant strictly before ``horizon`` (the
        next live completion): the next ADMISSIBLE arrival (an arrival
        the admission tier would bounce is not a decision) and — when
        preemption is armed — the next slack expiry, folded into ONE
        min so no wakeup source can mask an earlier one.  Returns None
        when the next completion is the next decision."""
        wake = None
        if len(self.queue):
            arr = self.queue.next_admissible_arrival(active, sim.clock)
            if arr is not None and arr < horizon:
                wake = arr
        if self._preemption.enabled:
            exp = self._next_slack_expiry(sim)
            if (exp is not None and exp < horizon
                    and (wake is None or exp < wake)):
                wake = exp
        return wake

    # ---- lifecycle: begin / step / result -------------------------------
    # run() used to be one monolithic while-loop; the service daemon needs
    # to pump the SAME loop one decision instant at a time (checkpointing
    # between instants, accepting submissions/cancels while work is in
    # flight), so the loop body lives in step() and run() is the one-shot
    # composition.  run() remains bit-for-bit the old loop: begin() is the
    # old prologue, step() the old body, result() the old epilogue.

    def begin(self, *, clock: float = 0.0) -> None:
        """Start a pool lifecycle: fresh event sim (optionally resuming at
        a checkpointed ``clock`` — the daemon's crash-recovery path),
        frozen interference blacklist, initial admission pass."""
        sim = _PoolSim()
        sim.clock = clock
        sim.observer = self.observer
        self._sim = sim
        self._active = []
        # ONE launch fixpoint loop for both schedulers: the shared core's
        # drain handles S3/fallback/S4 gating (S3 off means serial
        # launches only; the serial baseline honors the flag too, so
        # comparisons stay apples-to-apples)
        self._adapter = self.scheduler.adapter(sim)
        self._region_counts = {"expand": 0, "resolve": 0}
        # freeze the cross-job interference blacklist for this pool run
        # (pairs recorded during the run bite on the next one)
        self.scheduler.core.begin_run()
        self._admit(sim, self._active)

    def step(self) -> bool:
        """Advance the pool by ONE decision instant (the old run() loop
        body, verbatim).  Returns False — without advancing anything —
        once no admitted or queued work remains; new submissions make it
        return True again, which is how the daemon idles."""
        assert self._sim is not None, "step() before begin()"
        sim, active, adapter = self._sim, self._active, self._adapter
        if not active and not len(self.queue):
            return False
        if not active:
            # idle until the next tenant arrives
            nxt = self.queue.next_arrival(sim.clock)
            assert nxt is not None, "queued jobs but none admissible"
            sim.clock = nxt
            self._admit(sim, active)
            return True
        self.scheduler.core.drain(adapter)
        if sim.running:
            nxt_fin = sim.next_finish()
            assert nxt_fin is not None
            # a tenant arriving before the next op completes must not
            # wait out that op: advance to the arrival, admit, and go
            # back to launching on whatever cores are idle.  Only wake
            # for arrivals the admission tier would actually accept —
            # an arrival the demand cap bounces is not a scheduling
            # instant (it used to wake on max_active alone), but a
            # LATER admissible arrival behind it still gets its own
            # instant (next_admissible_arrival scans past the blocked
            # one).  Slack expiries (preemption armed) fold into the
            # same min — see _next_decision_instant.
            wake = self._next_decision_instant(sim, active, nxt_fin)
            if wake is not None:
                sim.clock = wake
                self._admit(sim, active)
                return True
            jid, sched = sim.complete_next()
            # close the loop: the completion's observed service flows
            # back through the job's plan store (no-op under
            # feedback="off"; under "ewma" it also re-derives the
            # job's remaining demand and critical paths, so the
            # admission check below sees the tightened values)
            adapter.observe((jid, sched.op.uid), sched, OBS_FINISH,
                            sched.duration)
            # region shape changes at this completion: trace, learn
            # trip counts, re-price the job's demand/slack (early
            # exit frees demand -> the _admit below can wake blocked
            # arrivals; overrun shrinks slack -> the next decision
            # instant can trigger preemption/eviction)
            self._handle_region_events(sim)
            job = next(j for j in active if j.jid == jid)
            job.ops_done += 1
            if sim.job_done(jid):
                job.finish_time = sim.clock
                active.remove(job)
            self._admit(sim, active)
        return True

    def result(self) -> PoolResult:
        """Snapshot the lifecycle's result — callable mid-run (the daemon
        reports drained metrics from the same call)."""
        sim = self._sim
        assert sim is not None, "result() before begin()"
        result = PoolResult(makespan=sim.clock, jobs=list(self.jobs),
                            records=sim.records, events=sim.events,
                            cache_stats=self.plan_cache.stats(),
                            preempted=sim.preempted,
                            feedback_stats=(self.corrections.stats()
                                            if self.corrections else None),
                            n_region_expands=self._region_counts["expand"],
                            n_region_resolves=self._region_counts["resolve"])
        # the standard metric snapshot rides on EVERY result (tracing not
        # required): benches and the CLI read one accounting surface
        result.metrics = pool_metrics(
            result, spec=self.machine.spec,
            cache_stats=result.cache_stats,
            corrections=self.corrections).snapshot()
        return result

    def run(self) -> PoolResult:
        self.begin()
        while self.step():
            pass
        result = self.result()
        # one-shot mode: leave the pool "not begun" again, so a later
        # submit() queues normally instead of admitting into a dead sim
        self._sim = None
        self._adapter = None
        self._active = []
        return result

    @property
    def clock(self) -> float:
        """Current sim time of the live lifecycle (0.0 before begin())."""
        return self._sim.clock if self._sim is not None else 0.0

    # ---- cluster rebalance hook -----------------------------------------
    def withdraw(self, jid: int) -> Job | None:
        """Take a job BACK from this pool so a cluster layer can reroute
        it to another machine — the admission-level-eviction move, made
        cross-machine.  Only free moves are allowed: the job must be
        waiting in the queue, or admitted with NO launched work (no
        records, no running ops, no revoked partials), so withdrawing it
        discards nothing and re-bills nothing.  A job with started work
        returns None — moving IT would cost restart waste, and pricing
        that is the (off-by-default) split/migration path's business, not
        this one's.  The withdrawn job leaves this pool's ledger entirely
        (``jobs``, queue, sim); the caller owns resubmission."""
        job = next((j for j in self.jobs if j.jid == jid), None)
        if job is None or job.cancelled or job.done:
            return None
        if self.queue.remove(jid):
            pass
        elif (self._sim is not None and jid in self._sim.jobs
              and not self._sim.records[jid]
              and not self._sim.preempted[jid]
              and not any(k[0] == jid for k in self._sim.running)):
            sim = self._sim
            self._active[:] = [j for j in self._active if j.jid != jid]
            for d in (sim.graphs, sim.jobs, sim.pending, sim.ready,
                      sim.records, sim.completed, sim.preempted):
                d.pop(jid, None)
            job.admit_time = None
            job.admitted_demand = None
            job.evictions += 1
            # the freed slot/demand gets its admission decision NOW,
            # exactly like cancel()'s admitted branch
            self._admit(sim, self._active)
        else:
            return None
        self.jobs.remove(job)
        return job

    # ---- cancellation ---------------------------------------------------
    def cancel(self, jid: int) -> bool:
        """Cancel a job wherever it lives: waiting in the admission queue,
        admitted but launch-free, or with running launches (those are
        revoked through the observer seam, so a payload backend cancels
        the futures).  Returns True when the job was live and is now
        cancelled; unknown, finished, or already-cancelled jobs return
        False.  Completed work stays in the records (it really ran) and
        launch-time service charges stay on the tenant's ledger."""
        job = next((j for j in self.jobs if j.jid == jid), None)
        if job is None or job.cancelled or job.done:
            return False
        where = None
        if self.queue.remove(jid):
            where = "queued"
        elif self._sim is not None and jid in self._sim.jobs:
            self._sim.drop_job(jid)
            self._active[:] = [j for j in self._active if j.jid != jid]
            where = "admitted"
            # the freed slot (and freed demand) gets its admission
            # decision NOW — step()'s idle branch only handles
            # strictly-future arrivals
            self._admit(self._sim, self._active)
        if where is None:
            return False
        job.cancelled = True
        if self.sink.enabled:
            now = self._sim.clock if self._sim is not None else 0.0
            self.sink.emit(TraceEvent(
                ts=now, family=FAM_ADMISSION, kind="cancel", key=jid,
                data={"job": job.name, "where": where,
                      "ops_done": job.ops_done}))
        return True

    # ---- baseline -------------------------------------------------------
    def run_serial(self, *, share_cache: bool = False) -> SerialResult:
        """The same job mix, one graph at a time (fresh jobs, fresh
        profiling): the single-tenant status quo the pool competes with.

        The baseline is deliberately priority-BLIND: it executes in plain
        arrival order (FIFO), because the status quo it models — a
        runtime that owns the whole machine per job — has no admission
        tier at all.  Priority-aware queueing is itself a pool feature,
        so latency comparisons against this baseline credit the pool for
        both co-scheduling and priority scheduling.

        ``share_cache=False`` means each job pays its own profiling probes
        — isolating both pool advantages (co-scheduling AND probe
        amortization) in the benchmark comparison."""
        cache = PlanCache() if share_cache else None
        clock = 0.0
        job_makespans: dict[int, float] = {}
        job_latencies: dict[int, float] = {}
        total_ops = 0
        probes = 0
        for job in sorted(self.jobs, key=lambda j: (j.submit_time, j.jid)):
            rt = ConcurrencyRuntime(machine=self.machine,
                                    config=self.config.runtime,
                                    plan_cache=cache)
            rt.profile(job.graph)
            assert rt.store is not None
            probes += rt.store.total_probes
            res = rt.execute_step(job.graph)
            clock = max(clock, job.submit_time) + res.makespan
            job_makespans[job.jid] = res.makespan
            job_latencies[job.jid] = clock - job.submit_time
            total_ops += len(res.records)
        return SerialResult(makespan=clock, job_makespans=job_makespans,
                            job_latencies=job_latencies, total_ops=total_ops,
                            profiling_probes=probes)
