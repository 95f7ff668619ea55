"""Multi-machine cluster pool: N per-machine ``RuntimePool``s behind one
demand-aware placement layer.

The cluster model is shared-nothing (``repro_torch.hw.spec.ClusterSpec``):
machines exchange jobs, never memory — so each machine keeps its own
discrete-event sim, its own ``StrategyCore``, its own admission tier,
and the cluster layer is pure routing plus two priced cross-machine
moves:

* **rebalance** — the admission-level eviction made cross-machine: a
  deadline-critical waiter on a busy machine is ``withdraw``n (free by
  construction — no started work) and resubmitted to an idle machine at
  the decision instant;
* **split** (off by default) — a multi-component graph spans two
  machines only when ``split_price`` says the predicted parallel finish
  strictly beats staying put plus the modeled transfer cost.

All member pools share ONE ``PlanCache`` — safe since lookups are
fingerprint-keyed — one jid counter (so jids are cluster-unique and a
rebalanced job can never collide), one correction table, and one trace
sink (``FAM_CLUSTER`` route/rebalance/split events ride beside the
per-machine families).

**Time model**: each pool's sim clock is local wall time on its machine;
all machines share t=0, so cluster makespan is the max of member
makespans, and cross-machine moves resubmit at the source machine's
decision instant (never into another machine's past).  The drive loop
steps the pool with the smallest clock first (ties to the lowest index),
which is deterministic and — for a 1-machine cluster — degenerates to
exactly ``RuntimePool.run``'s loop, giving the bit-for-bit parity leg
(``check_parity`` "cluster-1m") its footing.
"""

from __future__ import annotations

import dataclasses
import itertools

from repro_torch.core.graph import OpGraph
from repro_torch.core.perfmodel import cross_graph_key
from repro_torch.core.planstore import (CorrectionTable, DemandIndex,
                                  TripCountEstimator, make_plan_store,
                                  split_price)
from repro_torch.core.runtime import ConcurrencyRuntime
from repro_torch.core.simmachine import SimMachine
from repro_torch.hw.spec import ClusterSpec
from repro_torch.multitenant.job import Job, jain
from repro_torch.multitenant.plancache import PlanCache
from repro_torch.multitenant.pool import PoolConfig, PoolResult, RuntimePool
from repro_torch.obs.trace import FAM_CLUSTER, TraceEvent

from repro_torch.cluster.router import JobRouter, MachineFacts, RouterConfig


@dataclasses.dataclass
class ClusterJob:
    """One cluster-level submission and where it currently lives.

    ``cjid`` (the first jid minted for it) is the stable identity across
    rebalances and splits: parts and re-placements get fresh jids from
    the shared counter, but the submission itself is this record."""

    cjid: int
    name: str
    submit_time: float
    deadline: float | None
    machine: int                 # current (primary) machine index
    jobs: list[Job]              # live part(s): one, or two when split
    moves: int = 0               # rebalance count
    split: bool = False
    history: list[tuple[int, int]] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return all(j.done for j in self.jobs)

    @property
    def finish_time(self) -> float | None:
        if not self.done:
            return None
        return max(j.finish_time for j in self.jobs)

    @property
    def latency(self) -> float | None:
        f = self.finish_time
        return None if f is None else f - self.submit_time


@dataclasses.dataclass
class ClusterResult:
    """Per-machine ``PoolResult``s plus the cluster-level accounting."""

    machines: list[PoolResult]
    cluster_jobs: list[ClusterJob]
    assignment: dict[int, int]           # jid -> machine index
    n_rebalances: int = 0
    n_splits: int = 0
    demand_index_stats: dict | None = None
    metrics: dict | None = None

    @property
    def makespan(self) -> float:
        """Machines run in parallel wall time: the cluster is done when
        the LAST machine is."""
        return max((r.makespan for r in self.machines), default=0.0)

    @property
    def jobs(self):
        """Every per-machine Job, cluster-wide (the ``PoolResult.jobs``
        surface, so code written against one pool reads a cluster too)."""
        return [j for r in self.machines for j in r.jobs]

    @property
    def total_ops(self) -> int:
        return sum(r.total_ops for r in self.machines)

    @property
    def aggregate_throughput(self) -> float:
        return self.total_ops / self.makespan if self.makespan else 0.0

    def per_job_schedule(self, jid: int):
        """Delegate to the owning machine's result (same contract as
        ``PoolResult.per_job_schedule`` — the parity harness uses it)."""
        return self.machines[self.assignment[jid]].per_job_schedule(jid)

    def latencies(self) -> dict[int, float]:
        """cjid -> cluster-level latency (finish of the LAST part minus
        the ORIGINAL submit time — a rebalanced job's queue wait on its
        first machine is not forgiven)."""
        return {cj.cjid: cj.latency for cj in self.cluster_jobs
                if cj.latency is not None}

    def slowdowns(self, solo_makespans: dict[int, float]) -> dict[int, float]:
        """cjid -> latency / solo makespan (the fairness currency;
        ``solo_makespans`` keyed by cjid)."""
        lats = self.latencies()
        return {cjid: lats[cjid] / solo_makespans[cjid]
                for cjid in lats if solo_makespans.get(cjid)}

    def slowdown_fairness(self, solo_makespans: dict[int, float]) -> float:
        return jain(list(self.slowdowns(solo_makespans).values()))


class ClusterPool:
    """The placement layer: owns one ``RuntimePool`` per machine plus a
    ``JobRouter``; see the module docstring for the model."""

    def __init__(self, cluster: ClusterSpec | None = None, *,
                 config: PoolConfig | None = None,
                 plan_cache: PlanCache | None = None,
                 router: RouterConfig | JobRouter | None = None,
                 machines: list[SimMachine] | None = None,
                 corrections: CorrectionTable | None = None,
                 trip_counts: TripCountEstimator | None = None,
                 seed: int = 0):
        self.cluster = cluster if cluster is not None else ClusterSpec()
        self.config = config or PoolConfig()
        self.plan_cache = (plan_cache if plan_cache is not None
                           else PlanCache())
        if isinstance(router, JobRouter):
            self.router = router
        else:
            self.router = JobRouter(router)
        if machines is None:
            machines = [SimMachine(spec=spec, seed=seed)
                        for spec in self.cluster.machines]
        elif len(machines) != len(self.cluster.machines):
            raise ValueError("machines list must match the ClusterSpec")
        strat = self.config.strategy_config()
        self.sink = strat.sink
        self.feedback = strat.feedback
        # shared learned state, exactly as one RuntimePool shares it
        # across tenants: corrections/trip counts span machines too
        # (ratios are machine-relative to each machine's own curves)
        if self.feedback != "off":
            corrections = (corrections if corrections is not None
                           else CorrectionTable())
            trip_counts = (trip_counts if trip_counts is not None
                           else TripCountEstimator())
        self.corrections = corrections if self.feedback != "off" else None
        self.trip_counts = trip_counts if self.feedback != "off" else None
        self._jid = itertools.count()
        self.pools = [RuntimePool(machine=m, config=self.config,
                                  plan_cache=self.plan_cache,
                                  corrections=corrections,
                                  trip_counts=trip_counts,
                                  jid_counter=self._jid)
                      for m in machines]
        self.demand_index = DemandIndex()
        self.cluster_jobs: list[ClusterJob] = []
        self._by_jid: dict[int, ClusterJob] = {}
        self.assignment: dict[int, int] = {}
        # old jid -> replacement jid, maintained by rebalance so callers
        # holding a pre-move jid (the service daemon's job store) can
        # still find the job
        self.jid_alias: dict[int, int] = {}
        self.n_rebalances = 0
        self.n_splits = 0
        # mirrored onto every member pool at begin() (the daemon's
        # payload-execution seam)
        self.observer = None

    @property
    def jobs(self) -> list[Job]:
        """Every live per-machine Job, cluster-wide (jids are unique
        across machines — the shared counter — so lookups by jid are
        unambiguous)."""
        return [j for p in self.pools for j in p.jobs]

    def current_jid(self, jid: int) -> int:
        """Resolve a possibly-stale jid through the rebalance alias
        chain (a moved job gets a fresh jid on its new machine)."""
        while jid in self.jid_alias:
            jid = self.jid_alias[jid]
        return jid

    # ---- per-machine facts ----------------------------------------------
    def _fingerprint(self, m: int):
        """The SAME (machine fingerprint, probe interval) context the
        ``PlanCache`` namespaces curves under and ``DemandIndex`` keys
        demand under — one definition of "the same machine" everywhere."""
        return (self.pools[m].machine.fingerprint,
                self.config.runtime.interval)

    def _load(self, m: int) -> float:
        """Outstanding core-seconds on machine ``m``: remaining demand of
        active jobs (completed uids excluded) plus queued demand."""
        pool = self.pools[m]
        total = 0.0
        sim = pool._sim
        if sim is not None:
            for j in pool._active:
                if j.store is not None and j.plan is not None:
                    total += j.store.remaining_demand(
                        j.graph, j.plan, sim.completed.get(j.jid, set()))
                else:
                    total += j.demand or 0.0
        for j in pool.queue.waiting_jobs():
            total += j.demand or 0.0
        return total

    @staticmethod
    def _op_keys(graph) -> set:
        view = graph.profile_view() if hasattr(graph, "profile_view") \
            else graph
        return {cross_graph_key(op) for op in view.ops.values()}

    def _warm_frac(self, m: int, graph) -> float:
        keys = self._op_keys(graph)
        if not keys:
            return 0.0
        warm = self.plan_cache.warm_keys(self._fingerprint(m))
        return len(keys & warm) / len(keys)

    def _estimate_demand(self, graph, m: int) -> float:
        """Planstore-re-estimated demand (core-seconds) of ``graph`` on
        machine ``m`` — memoized per (fingerprint, workload shape).  The
        first estimate profiles through the SHARED fingerprint-keyed
        PlanCache, so the probes it pays are exactly the probes the
        winning machine's own submit-time profile then reuses: pricing a
        machine warms it, and never pollutes any other machine."""
        pool = self.pools[m]

        def compute() -> float:
            rt = ConcurrencyRuntime(machine=pool.profile_machine,
                                    config=self.config.runtime,
                                    plan_cache=self.plan_cache)
            rt.profile(graph)
            store = make_plan_store(self.feedback, rt.controller,
                                    corrections=self.corrections,
                                    trip_counts=self.trip_counts)
            return store.remaining_demand(graph, rt.plan)

        return self.demand_index.query(self._fingerprint(m), graph, compute)

    # ---- routing ---------------------------------------------------------
    def _route(self, graph) -> tuple[int, float | None]:
        """Choose a machine for ``graph``; returns (index, demand
        estimate on it — None under round_robin, which never prices)."""
        n = len(self.pools)
        loads = [self._load(m) for m in range(n)]
        cores = [p.machine.spec.cores for p in self.pools]
        if self.router.config.policy == "round_robin":
            facts = [MachineFacts(m, cores[m], loads[m], None, 0.0)
                     for m in range(n)]
            return self.router.route(facts), None
        warm = [self._warm_frac(m, graph) for m in range(n)]
        fps = [self._fingerprint(m) for m in range(n)]
        known = {m for m in range(n)
                 if self.demand_index.peek(fps[m], graph) is not None}
        if not known:
            # brand-new workload shape: price it ONCE, on the machine
            # with the least work ahead (machines sharing that
            # fingerprint become known for free)
            m0 = min(range(n), key=lambda m: (loads[m] / cores[m], m))
            self._estimate_demand(graph, m0)
            known = {m for m in range(n)
                     if self.demand_index.peek(fps[m], graph) is not None}
        facts = [MachineFacts(m, cores[m], loads[m],
                              self.demand_index.peek(fps[m], graph,
                                                     count=True), warm[m])
                 for m in sorted(known)]
        # lazy pricing: a machine with unknown demand (a different
        # fingerprint, never priced for this shape) is worth paying
        # probes for ONLY if its load alone — the optimistic bound —
        # already beats the best fully-priced projection ("route a job
        # where its curves are already paid for", unless a cold machine
        # is idle enough to win anyway)
        for m in range(n):
            if m in known:
                continue
            best = min(f.projected_finish for f in facts)
            if loads[m] / cores[m] < best:
                demand = self._estimate_demand(graph, m)
                facts.append(MachineFacts(m, cores[m], loads[m],
                                          demand, warm[m]))
        chosen = self.router.route(facts)
        est = next(f.demand for f in facts if f.index == chosen)
        return chosen, est

    # ---- submission ------------------------------------------------------
    def submit(self, graph: OpGraph, *, priority: float = 1.0,
               name: str | None = None, submit_time: float = 0.0,
               deadline: float | None = None,
               machine: int | None = None) -> Job:
        """Route ``graph`` to a machine and submit it there.  Returns the
        underlying per-machine ``Job`` (same surface as
        ``RuntimePool.submit``, so ``submit_spec`` and the daemon drive a
        cluster unchanged).  ``machine`` forces the placement — the
        daemon's recovery path, which must restore a checkpointed
        assignment rather than re-route."""
        if machine is not None:
            m, est = machine, None
        else:
            split = self._try_split(graph, priority=priority, name=name,
                                    submit_time=submit_time,
                                    deadline=deadline)
            if split is not None:
                return split
            m, est = self._route(graph)
        job = self.pools[m].submit(graph, priority=priority, name=name,
                                   submit_time=submit_time,
                                   deadline=deadline)
        cj = ClusterJob(cjid=job.jid, name=job.name,
                        submit_time=submit_time, deadline=deadline,
                        machine=m, jobs=[job])
        self.cluster_jobs.append(cj)
        self._by_jid[job.jid] = cj
        self.assignment[job.jid] = m
        if self.sink.enabled:
            self.sink.emit(TraceEvent(
                ts=submit_time, family=FAM_CLUSTER, kind="route",
                key=job.jid,
                data={"job": job.name, "machine": m,
                      "demand": est if est is not None else job.demand,
                      "policy": self.router.config.policy,
                      "forced": machine is not None,
                      "loads": [round(self._load(i), 9)
                                for i in range(len(self.pools))]}))
        return job

    # ---- cross-machine splits (priced, off by default) -------------------
    def _try_split(self, graph, *, priority, name, submit_time,
                   deadline) -> Job | None:
        """Span two machines with one wide tenant — only when the plan
        says the split pays (``split_price``, strict).  Only static
        multi-component graphs qualify: a component is closed under
        deps, so partitioning components never cuts an edge, and the
        per-part demand is approximated by each part's flops share of
        the whole-graph estimate (components execute independently, so
        the share is exact up to width effects)."""
        if not self.router.config.split or len(self.pools) < 2:
            return None
        if type(graph) is not OpGraph or not graph.ops:
            return None
        comps = self._components(graph)
        if len(comps) < 2:
            return None
        m_whole, demand = self._route(graph)
        loads = [self._load(m) for m in range(len(self.pools))]
        cores = [p.machine.spec.cores for p in self.pools]
        whole_time = (loads[m_whole] + demand) / cores[m_whole]
        # two-bin greedy partition by flops weight, heaviest first
        weight = {i: sum(graph.ops[u].flops + graph.ops[u].bytes_moved
                         for u in comp) for i, comp in enumerate(comps)}
        bins: list[list[int]] = [[], []]
        bin_w = [0.0, 0.0]
        for i in sorted(weight, key=lambda i: (-weight[i], i)):
            b = 0 if bin_w[0] <= bin_w[1] else 1
            bins[b].append(i)
            bin_w[b] += weight[i]
        if not bins[0] or not bins[1]:
            return None
        total_w = sum(bin_w) or 1.0
        # the two least-loaded machines host the parts
        m1, m2 = sorted(range(len(self.pools)),
                        key=lambda m: (loads[m] / cores[m], m))[:2]
        shares = [bin_w[0] / total_w, bin_w[1] / total_w]
        split_time = max((loads[mm] + demand * s) / cores[mm]
                         for mm, s in zip((m1, m2), shares))
        price = split_price(whole_time, split_time,
                            self.cluster.transfer_cost_s)
        if not price.worth_it:
            return None
        parts = []
        for part_idx, (mm, bin_comps) in enumerate(zip((m1, m2), bins)):
            ops = {u: graph.ops[u] for ci in bin_comps for u in comps[ci]}
            sub = OpGraph(name=f"{name or graph.name}/part{part_idx}",
                          ops=ops)
            parts.append(self.pools[mm].submit(
                sub, priority=priority, submit_time=submit_time,
                deadline=deadline))
        cj = ClusterJob(cjid=parts[0].jid, name=name or graph.name,
                        submit_time=submit_time, deadline=deadline,
                        machine=m1, jobs=parts, split=True)
        self.cluster_jobs.append(cj)
        self.n_splits += 1
        for job, mm in zip(parts, (m1, m2)):
            self._by_jid[job.jid] = cj
            self.assignment[job.jid] = mm
        if self.sink.enabled:
            self.sink.emit(TraceEvent(
                ts=submit_time, family=FAM_CLUSTER, kind="split",
                key=cj.cjid,
                data={"job": cj.name, "machines": [m1, m2],
                      "jids": [j.jid for j in parts],
                      "gain": price.gain, "cost": price.cost,
                      "whole_time": whole_time,
                      "split_time": split_time}))
        return parts[0]

    @staticmethod
    def _components(graph: OpGraph) -> list[list[int]]:
        """Weakly-connected components (sorted uids, sorted by first
        uid) — union by deps edges."""
        parent = {u: u for u in graph.ops}

        def find(u):
            while parent[u] != u:
                parent[u] = parent[parent[u]]
                u = parent[u]
            return u

        for op in graph.ops.values():
            for d in op.deps:
                parent[find(d)] = find(op.uid)
        groups: dict[int, list[int]] = {}
        for u in graph.ops:
            groups.setdefault(find(u), []).append(u)
        return sorted((sorted(g) for g in groups.values()),
                      key=lambda g: g[0])

    # ---- lifecycle -------------------------------------------------------
    def begin(self, *, clock: float = 0.0,
              clocks: list[float] | None = None) -> None:
        """Start every member pool's lifecycle (``clocks`` resumes each
        machine at its own checkpointed instant — the daemon's recovery
        path)."""
        if clocks is None:
            clocks = [clock] * len(self.pools)
        for pool, c in zip(self.pools, clocks):
            pool.observer = self.observer
            pool.begin(clock=c)

    def step(self) -> bool:
        """Advance the cluster by ONE per-machine decision instant: the
        pool with work and the smallest local clock steps (ties to the
        lowest index — deterministic), then the rebalance check runs.
        With one machine this IS ``RuntimePool.step`` (the rebalance
        check needs a second machine to do anything), which is what the
        cluster-1m parity leg pins."""
        busy = [m for m, p in enumerate(self.pools)
                if p._active or len(p.queue)]
        if not busy:
            return False
        m = min(busy, key=lambda m: (self.pools[m].clock, m))
        stepped = self.pools[m].step()
        if self.router.config.rebalance:
            self._maybe_rebalance()
        return stepped

    def result(self) -> ClusterResult:
        results = [p.result() for p in self.pools]
        res = ClusterResult(machines=results,
                            cluster_jobs=list(self.cluster_jobs),
                            assignment=dict(self.assignment),
                            n_rebalances=self.n_rebalances,
                            n_splits=self.n_splits,
                            demand_index_stats={
                                "hits": self.demand_index.hits,
                                "misses": self.demand_index.misses})
        metrics = {"cluster.makespan": res.makespan,
                   "cluster.total_ops": res.total_ops,
                   "cluster.aggregate_throughput": res.aggregate_throughput,
                   "cluster.rebalances": res.n_rebalances,
                   "cluster.splits": res.n_splits,
                   "cluster.demand_index_hits": self.demand_index.hits}
        for m, r in enumerate(results):
            metrics[f"cluster.machine.{m}.makespan"] = r.makespan
            metrics[f"cluster.machine.{m}.ops"] = r.total_ops
        res.metrics = metrics
        return res

    def run(self) -> ClusterResult:
        self.begin()
        while self.step():
            pass
        result = self.result()
        # one-shot mode, like RuntimePool.run: leave every member "not
        # begun" so later submits queue normally
        for pool in self.pools:
            pool._sim = None
            pool._adapter = None
            pool._active = []
        return result

    def cancel(self, jid: int) -> bool:
        """Cancel a cluster job by any of its part jids (a split tenant's
        parts stand and fall together — cancelling half a job would leave
        an orphaned remainder no client asked for)."""
        cj = self._by_jid.get(jid)
        if cj is None:
            return False
        # list() before any(): a bare generator would short-circuit on
        # the first successful cancel and leave later parts running
        return any([self.pools[self.assignment[j.jid]].cancel(j.jid)
                    for j in list(cj.jobs)])

    # ---- rebalance (admission-level eviction, cross-machine) -------------
    def _maybe_rebalance(self) -> None:
        """Move a deadline-critical WAITER from a busy machine to an idle
        one.  Free by construction: only queued (or launch-free) jobs are
        withdrawable, so nothing is discarded or re-billed — this is the
        pool's admission-level eviction with a machine hop at the end.
        The moved job resubmits at the source machine's decision instant
        (never into the target's past) and keeps its ORIGINAL identity in
        the cluster ledger, so latency accounting still starts at first
        submission."""
        if len(self.pools) < 2:
            return
        for src_idx, src in enumerate(self.pools):
            now = src.clock
            for job in list(src.queue.waiting_jobs()):
                if job.submit_time > now or job.deadline is None:
                    continue
                cj = self._by_jid.get(job.jid)
                if cj is None or cj.moves >= self.router.config.max_moves:
                    continue
                slack = src._root_slack(job, now)
                if slack is None or slack > 0.0:
                    continue
                idle = [t for t, p in enumerate(self.pools)
                        if t != src_idx and not p._active
                        and not len(p.queue)]
                if not idle:
                    continue
                target = min(idle, key=lambda t: (self.pools[t].clock, t))
                moved = src.withdraw(job.jid)
                if moved is None:
                    continue
                new_job = self.pools[target].submit(
                    moved.graph, priority=moved.priority, name=moved.name,
                    submit_time=max(moved.submit_time, now),
                    deadline=moved.deadline)
                cj.jobs[cj.jobs.index(job)] = new_job
                cj.machine = target
                cj.moves += 1
                cj.history.append((src_idx, job.jid))
                del self._by_jid[job.jid]
                self.assignment.pop(job.jid, None)
                self.jid_alias[job.jid] = new_job.jid
                self._by_jid[new_job.jid] = cj
                self.assignment[new_job.jid] = target
                self.n_rebalances += 1
                if self.sink.enabled:
                    self.sink.emit(TraceEvent(
                        ts=now, family=FAM_CLUSTER, kind="rebalance",
                        key=new_job.jid,
                        data={"job": moved.name, "from": src_idx,
                              "to": target, "old_jid": job.jid,
                              "slack": slack}))
                return      # one move per decision instant
