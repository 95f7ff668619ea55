"""Pool-as-a-service: a long-lived daemon owning one ``RuntimePool``
(or, given a ``ClusterSpec``, one ``ClusterPool`` spanning N machines).

``PoolDaemon`` turns the library pool into a service: it owns one
``RuntimePool`` plus one persistent ``RealGraphExecutor`` worker set,
accepts jobs while work is in flight (file-based inbox, see below, or
the in-process ``submit``/``cancel``/``status``/``drain`` methods the
CLI smoke and the tests drive directly), and checkpoints the whole
scheduling world into the versioned job store after every decision
instant — so a killed daemon restarts into the same world.

**Submission protocol.**  Clients drop one JSON file per command into
``<state_dir>/inbox/`` (processed in filename order); the daemon writes
the reply to ``<state_dir>/outbox/<same name>`` and deletes the inbox
file.  Commands: ``{"op": "submit", "spec": {...JobSpec wire dict...}}``,
``{"op": "cancel", "job": "job-N"}``, ``{"op": "status"}``,
``{"op": "drain"}``, ``{"op": "stop"}``.  Replies always carry ``ok``;
errors carry ``error`` instead of crashing the daemon.

**Execution.**  The pool's discrete-event sim stays the single source of
scheduling truth; a ``PoolObserver`` mirrors its decisions onto real
payload execution: launch -> ``RealGraphExecutor.submit_op`` (payload
futures wait for their dependency futures inside the worker), revoke ->
``Future.cancel`` (a revoked payload that has not started never runs),
complete -> optionally report the real wall time through the job's
``PlanStore.observe`` (``payload_feedback=True``).  Ops without payloads
(every simulated workload) cost nothing — only payload-carrying ops
reach the worker set.

**Crash recovery.**  See ``repro_torch.service.jobstore``: on boot the daemon
loads ``store.json`` + ``plancache.json``, seeds the pool's
``CorrectionTable``/``TripCountEstimator`` from the checkpoint (probe
and observation counts carry over — learning does not reset), resubmits
every unfinished job's spec in original submit order, bills interrupted
work as restart waste exactly once, and resumes the sim at the
checkpointed clock.

**Cluster mode.**  ``PoolDaemon(..., cluster=ClusterSpec(...))`` drives
a ``repro_torch.cluster.ClusterPool`` instead: jobs route across N machines,
the job store records each entry's machine assignment (recovery
resubmits to the SAME machine rather than re-routing — the placement is
state, not policy), checkpoints carry every member machine's local
clock, restart waste is billed at the assigned machine's own
``restart_waste`` rate, and the simulated machines' payloads are mapped
round-robin onto the CUDA devices (``RealGraphExecutor.device_for``; on
one card every machine maps to ``cuda:0``).

**Device.**  The port's copy of ``repro.service.daemon``: payloads run on
``device`` (``"cuda"`` by default, each executor worker on its own CUDA
stream), and building a daemon that executes payloads raises without
CUDA unless ``device="cpu"`` is given.  A daemon with
``execute_payloads=False`` touches no device.
"""

from __future__ import annotations

import json
import os
import pathlib
import time
import warnings
from concurrent.futures import Future
from typing import Mapping

from repro_torch import resolve_device
from repro_torch.cluster.pool import ClusterPool, ClusterResult
from repro_torch.cluster.router import RouterConfig
from repro_torch.core.planstore import CorrectionTable, TripCountEstimator
from repro_torch.core.runtime import RealGraphExecutor, report_payload_observation
from repro_torch.hw.spec import ClusterSpec
from repro_torch.multitenant.plancache import PlanCache, atomic_write_text
from repro_torch.multitenant.pool import (PoolConfig, PoolObserver, PoolResult,
                                    RuntimePool)
from repro_torch.obs.trace import FAM_SERVICE, TraceEvent
from repro_torch.service.jobstore import (JobEntry, StoreState, load_store,
                                    save_store)
from repro_torch.service.spec import ATTACHED_GRAPH, JobSpec, submit_spec


class _PayloadObserver(PoolObserver):
    """Mirror the sim's launch/revoke/complete decisions onto real
    payload futures (read-only on the sim: the timeline it observes is
    bit-for-bit the unobserved one)."""

    def __init__(self, pool, executor: RealGraphExecutor,
                 *, payload_feedback: bool = False):
        self.pool = pool                 # RuntimePool or ClusterPool
        self.executor = executor
        self.payload_feedback = payload_feedback
        #: jid -> {uid -> payload future} for in-flight/finished launches
        self.futures: dict[int, dict[int, Future]] = {}

    def _sim_of(self, jid: int):
        """The sim that owns ``jid`` (a cluster pool has one per
        machine; the jid's assignment names it)."""
        pools = getattr(self.pool, "pools", None)
        if pools is None:
            return self.pool._sim
        m = self.pool.assignment.get(jid)
        return pools[m]._sim if m is not None else None

    def on_launch(self, key, sched) -> None:
        jid, uid = key
        op = sched.op
        if op.payload is None:
            return
        futs = self.futures.setdefault(jid, {})
        # deps resolve to their payload future when one exists, else to
        # the materialized None a payload-less dep produces
        deps = {d: futs.get(d) for d in op.deps}
        # cluster mode: the payload lands on the CUDA device mapped to
        # the machine this job was routed to (None = the executor's own)
        machine = getattr(self.pool, "assignment", {}).get(jid)
        futs[uid] = self.executor.submit_op(
            op, deps, device=self.executor.device_for(machine))

    def on_revoke(self, key, sched) -> None:
        jid, uid = key
        fut = self.futures.get(jid, {}).pop(uid, None)
        if fut is not None:
            # not-yet-started payloads are cancelled outright; a payload
            # already on a worker runs to completion but its result is
            # dropped (the sim will relaunch the op later and submit a
            # fresh payload)
            fut.cancel()

    def on_complete(self, key, sched) -> None:
        if not self.payload_feedback:
            return
        jid, uid = key
        fut = self.futures.get(jid, {}).get(uid)
        sim = self._sim_of(jid)
        job = sim.jobs.get(jid) if sim is not None else None
        if fut is None or fut.cancelled() or job is None \
                or job.store is None:
            return
        # close the loop on REAL time: block for the payload (sim
        # completion may lead real completion) and report its wall
        # seconds at the op's frozen-plan width
        _, dt = fut.result()
        report_payload_observation(job.store, job.plan, sched.op, dt)


class PoolDaemon:
    """One long-lived pool + worker set behind a file inbox (see module
    docstring).  Drive it with ``serve()`` (the CLI loop) or call
    ``submit``/``cancel``/``status``/``pump``/``drain`` directly."""

    def __init__(self, state_dir: str | pathlib.Path, *,
                 config: PoolConfig | None = None, machine=None,
                 cluster: ClusterSpec | None = None,
                 router: RouterConfig | None = None,
                 checkpoint_every: int = 1, max_workers: int = 2,
                 execute_payloads: bool = True,
                 payload_feedback: bool = False,
                 device: str = "cuda"):
        if cluster is not None and machine is not None:
            raise ValueError("pass cluster (the daemon builds the "
                             "member machines) OR machine, not both")
        if execute_payloads:
            resolve_device(device)      # raises before any state is made
        self.cluster = cluster
        self.state_dir = pathlib.Path(state_dir)
        self.inbox = self.state_dir / "inbox"
        self.outbox = self.state_dir / "outbox"
        self.inbox.mkdir(parents=True, exist_ok=True)
        self.outbox.mkdir(parents=True, exist_ok=True)
        self.store_path = self.state_dir / "store.json"
        self.cache_path = self.state_dir / "plancache.json"

        state = load_store(self.store_path)
        recovered = state is not None
        if config is None:
            config = (PoolConfig.from_dict(state.config)
                      if recovered and state.config else PoolConfig())
        self.config = config
        strat = config.strategy_config()
        self.sink = strat.sink
        cache = (PlanCache.load(self.cache_path)
                 if self.cache_path.exists() else PlanCache())
        corrections = trip_counts = None
        if recovered and strat.feedback != "off":
            if state.corrections is not None:
                corrections = CorrectionTable.from_dict(state.corrections)
            if state.trip_counts is not None:
                trip_counts = TripCountEstimator.from_dict(
                    state.trip_counts)
        if cluster is not None:
            self.pool = ClusterPool(cluster, config=config,
                                    plan_cache=cache, router=router,
                                    corrections=corrections,
                                    trip_counts=trip_counts)
        else:
            self.pool = RuntimePool(machine=machine, config=config,
                                    plan_cache=cache,
                                    corrections=corrections,
                                    trip_counts=trip_counts)

        self.executor: RealGraphExecutor | None = None
        self.observer: _PayloadObserver | None = None
        if execute_payloads:
            self.executor = RealGraphExecutor(
                max_workers=max_workers, persistent=True,
                n_devices=len(cluster) if cluster is not None else None,
                device=device)
            self.observer = _PayloadObserver(
                self.pool, self.executor,
                payload_feedback=payload_feedback)
            self.pool.observer = self.observer

        self.entries: list[JobEntry] = []
        self._jid_by_order: dict[int, int] = {}
        #: restart-waste service billed onto the live job at recovery —
        #: the baseline progress_core_s measures NEW work against
        self._billed: dict[int, float] = {}
        self.restarts = (state.restarts + 1) if recovered else 0
        self.checkpoint_every = max(1, checkpoint_every)
        self.total_steps = 0
        self._stopping = False
        self.once = False

        clock = state.clock if recovered else 0.0
        if recovered:
            self._emit("recover", data={"restarts": self.restarts,
                                        "clock": clock,
                                        "entries": len(state.entries)})
            self._recover(state)
        else:
            self._emit("start", data={})
        if self._is_cluster:
            # each member machine resumes at ITS OWN checkpointed clock
            # (a pre-cluster or 1-entry store falls back to the max)
            clocks = state.clocks if recovered else None
            if clocks is not None and len(clocks) == len(self.pool.pools):
                self.pool.begin(clocks=clocks)
            else:
                self.pool.begin(clock=clock)
        else:
            self.pool.begin(clock=clock)
        self.checkpoint()

    @property
    def _is_cluster(self) -> bool:
        return self.cluster is not None

    @property
    def _member_pools(self) -> list[RuntimePool]:
        return self.pool.pools if self._is_cluster else [self.pool]

    def _clock(self) -> float:
        if self._is_cluster:
            return max((p.clock for p in self.pool.pools), default=0.0)
        return (self.pool._sim.clock
                if self.pool._sim is not None else 0.0)

    # ---- recovery -------------------------------------------------------
    def _waste_factor(self, entry: JobEntry) -> float:
        """Restart waste is billed at the rate of the machine the work
        was LOST on (heterogeneous clusters: a fat machine's lost
        core-seconds cost what that machine charges)."""
        if self._is_cluster:
            m = entry.machine if (entry.machine is not None
                                  and entry.machine
                                  < len(self.pool.pools)) else 0
            return self.pool.pools[m].machine.spec.restart_waste
        return self.pool.machine.spec.restart_waste

    def _recover(self, state: StoreState) -> None:
        for entry in sorted(state.entries, key=lambda e: e.order):
            self.entries.append(entry)
            if entry.state in ("done", "cancelled"):
                continue        # terminal history, never resubmitted
            if entry.spec.workload == ATTACHED_GRAPH:
                # in-process graphs cannot be rebuilt from the wire form
                warnings.warn(
                    f"job {entry.order} ({entry.spec.name}) carried an "
                    f"attached graph; not recoverable", stacklevel=2)
                entry.state = "cancelled"
                continue
            waste_factor = self._waste_factor(entry)
            # resubmission in original order = original queue order (the
            # queue's FIFO tie-break follows submission sequence), so an
            # admitted-but-unlaunched job is readmitted exactly as the
            # eviction path would readmit it: deferred, never demoted.
            # Cluster mode: the checkpointed machine assignment is
            # RESTORED, not re-routed — placement is state
            forced = (entry.machine if self._is_cluster
                      and entry.machine is not None
                      and entry.machine < len(self.pool.pools) else None)
            job = submit_spec(self.pool, entry.spec, machine=forced)
            if self._is_cluster:
                entry.machine = self.pool.assignment.get(job.jid)
            self._jid_by_order[entry.order] = job.jid
            # the crash lost this entry's in-flight work; bill it as
            # restart waste EXACTLY ONCE (progress resets to zero below,
            # so a second crash with no new progress re-bills nothing)
            waste = waste_factor * entry.progress_core_s
            if waste > 0.0:
                job.service += waste
                entry.carried_waste += waste
            self._billed[entry.order] = waste
            entry.progress_core_s = 0.0
            entry.restarts += 1
            entry.state = "queued"
            self._emit("recover_job", key=self.public_id(entry.order),
                       data={"jid": job.jid, "state": entry.state,
                             "billed_waste": waste,
                             "carried_waste": entry.carried_waste})

    # ---- bookkeeping ----------------------------------------------------
    @staticmethod
    def public_id(order: int) -> str:
        return f"job-{order}"

    def _entry_by_id(self, job_id: str) -> JobEntry | None:
        return next((e for e in self.entries
                     if self.public_id(e.order) == job_id), None)

    def _job_of(self, entry: JobEntry):
        jid = self._jid_by_order.get(entry.order)
        if jid is None:
            return None
        if self._is_cluster:
            # a rebalance re-minted the jid; follow the alias chain and
            # remember the current one
            jid = self.pool.current_jid(jid)
            self._jid_by_order[entry.order] = jid
        return next((j for j in self.pool.jobs if j.jid == jid), None)

    def _sync_entry(self, entry: JobEntry) -> None:
        job = self._job_of(entry)
        if job is None:
            return                      # recovered terminal history
        if job.cancelled:
            entry.state = "cancelled"
            entry.progress_core_s = 0.0
        elif job.done:
            entry.state = "done"
            entry.progress_core_s = 0.0
            entry.result = {"finish_time": job.finish_time,
                            "latency_s": job.latency,
                            "service_core_s": job.service,
                            "preemptions": job.preemptions}
        else:
            if self._is_cluster:
                m = self.pool.assignment.get(job.jid)
                entry.machine = m if m is not None else entry.machine
                sim = (self.pool.pools[m]._sim if m is not None else None)
            else:
                sim = self.pool._sim
            if sim is not None and job.jid in sim.jobs:
                started = (bool(sim.records.get(job.jid))
                           or any(k[0] == job.jid for k in sim.running)
                           or bool(sim.preempted.get(job.jid)))
                entry.state = "running" if started else "admitted"
            else:
                entry.state = "queued"
            entry.progress_core_s = max(
                job.service - self._billed.get(entry.order, 0.0), 0.0)

    def _emit(self, kind: str, key=None, data: Mapping | None = None):
        if not self.sink.enabled:
            return
        self.sink.emit(TraceEvent(ts=self._clock(), family=FAM_SERVICE,
                                  kind=kind, key=key,
                                  data=dict(data or {})))

    # ---- checkpointing --------------------------------------------------
    def checkpoint(self) -> None:
        """Persist the whole scheduling world (atomic writes: a crash
        mid-checkpoint keeps the previous good snapshot)."""
        for entry in self.entries:
            self._sync_entry(entry)
        pool = self.pool
        state = StoreState(
            clock=self._clock(),
            restarts=self.restarts,
            config=self.config.to_dict(),
            entries=self.entries,
            corrections=(pool.corrections.to_dict()
                         if pool.corrections is not None else None),
            trip_counts=(pool.trip_counts.to_dict()
                         if pool.trip_counts is not None else None),
            clocks=([p.clock for p in pool.pools]
                    if self._is_cluster else None))
        save_store(self.store_path, state)
        pool.plan_cache.dump(self.cache_path)
        self._emit("checkpoint", data={"entries": len(self.entries),
                                       "steps": self.total_steps})

    # ---- client operations ----------------------------------------------
    def submit(self, spec: JobSpec | Mapping, *, graph=None) -> str:
        """Accept one job (wire dict or ``JobSpec``); returns its stable
        client-facing id (``job-N``, unchanged across restarts)."""
        if isinstance(spec, Mapping):
            spec = JobSpec.from_dict(spec)
        order = (max((e.order for e in self.entries), default=-1)) + 1
        job = submit_spec(self.pool, spec, graph=graph)
        entry = JobEntry(spec=spec, order=order,
                         machine=(self.pool.assignment.get(job.jid)
                                  if self._is_cluster else None))
        self.entries.append(entry)
        self._jid_by_order[order] = job.jid
        self._emit("submit", key=self.public_id(order),
                   data={"jid": job.jid, "workload": spec.workload,
                         "name": job.name, "machine": entry.machine})
        self.checkpoint()
        return self.public_id(order)

    def cancel(self, job_id: str) -> bool:
        entry = self._entry_by_id(job_id)
        if entry is None:
            return False
        job = self._job_of(entry)      # alias-resolves rebalanced jids
        ok = self.pool.cancel(job.jid) if job is not None else False
        if ok:
            entry.state = "cancelled"
            self.checkpoint()
        self._emit("cancel", key=job_id, data={"ok": ok})
        return ok

    def status(self) -> dict:
        for entry in self.entries:
            self._sync_entry(entry)
        out = {
            "clock": self._clock(),
            "restarts": self.restarts,
            "steps": self.total_steps,
            "queued": sum(len(p.queue) for p in self._member_pools),
            "active": sum(len(p._active) for p in self._member_pools),
            "jobs": [{"id": self.public_id(e.order),
                      "name": e.spec.name or e.spec.workload,
                      "workload": e.spec.workload,
                      "state": e.state,
                      "machine": e.machine,
                      "carried_waste": e.carried_waste,
                      "restarts": e.restarts,
                      "result": e.result}
                     for e in sorted(self.entries,
                                     key=lambda e: e.order)]}
        if self._is_cluster:
            out["machines"] = len(self.pool.pools)
            out["clocks"] = [p.clock for p in self.pool.pools]
            out["rebalances"] = self.pool.n_rebalances
        return out

    # ---- the pump -------------------------------------------------------
    def _after_step(self) -> None:
        self.total_steps += 1
        if self.total_steps % self.checkpoint_every == 0:
            self.checkpoint()

    def pump(self, max_steps: int | None = None) -> int:
        """Advance the pool up to ``max_steps`` decision instants
        (unbounded when None); returns how many it advanced."""
        steps = 0
        while ((max_steps is None or steps < max_steps)
               and self.pool.step()):
            steps += 1
            self._after_step()
        return steps

    def drain(self) -> PoolResult | ClusterResult:
        """Run every accepted job to completion and return the pool
        result (same metrics surface as ``RuntimePool.run``; a
        ``ClusterResult`` in cluster mode)."""
        self.pump()
        self.checkpoint()
        result = self.pool.result()
        self._emit("drain", data={"makespan": result.makespan,
                                  "jobs": len(result.jobs)})
        return result

    def close(self) -> None:
        self.checkpoint()
        if self.executor is not None:
            self.executor.close()
        self._emit("stop", data={"steps": self.total_steps})

    # ---- file inbox -----------------------------------------------------
    def _execute(self, cmd: Mapping) -> dict:
        op = cmd.get("op")
        if op == "submit":
            return {"ok": True, "job": self.submit(cmd["spec"])}
        if op == "cancel":
            return {"ok": self.cancel(cmd["job"])}
        if op == "status":
            return {"ok": True, **self.status()}
        if op == "drain":
            result = self.drain()
            if self.once:
                self._stopping = True
            return {"ok": True, "makespan": result.makespan,
                    "metrics": result.metrics}
        if op == "stop":
            self._stopping = True
            return {"ok": True}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def poll_inbox(self) -> int:
        """Process every pending inbox command (filename order); one
        reply file per command.  A malformed command becomes an error
        reply, never a daemon crash."""
        n = 0
        for path in sorted(self.inbox.glob("*.json")):
            try:
                cmd = json.loads(path.read_text())
                reply = self._execute(cmd)
            except Exception as exc:  # noqa: BLE001 - reply, don't die
                reply = {"ok": False, "error": str(exc)}
            atomic_write_text(self.outbox / path.name, json.dumps(reply))
            path.unlink()
            n += 1
            if self._stopping:
                break
        return n

    def serve(self, *, poll_interval: float = 0.05, once: bool = False,
              crash_after_steps: int | None = None) -> None:
        """The daemon loop: poll the inbox, advance one decision instant,
        repeat.  ``once=True`` exits after the first ``drain`` command
        completes (submit-all-then-drain mode).  ``crash_after_steps``
        simulates a hard crash (``os._exit``) after that many pool steps
        — the recovery tests' kill switch; checkpoints written up to the
        crash instant survive, nothing later does."""
        self.once = once
        while not self._stopping:
            handled = self.poll_inbox()
            stepped = self.pump(max_steps=1)
            if (crash_after_steps is not None
                    and self.total_steps >= crash_after_steps):
                os._exit(1)
            if not handled and not stepped and not self._stopping:
                time.sleep(poll_interval)
        self.close()
