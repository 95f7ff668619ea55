"""Differential parity: a single-job pool must reproduce CorunScheduler.

Both schedulers are thin adapters over ``repro_torch.core.strategy.StrategyCore``
(since the extraction), so a pool containing exactly one job must produce
a BIT-IDENTICAL ``ScheduleResult`` timeline — same makespan, same per-op
launch times, thread counts, affinity variants, and hyper-thread flags —
as the single-graph scheduler run on the same machine.  This module is the
executable form of that claim, shared by three consumers:

* ``tests/test_strategy_differential.py`` — the differential suite over
  the model zoo plus committed golden timelines;
* ``benchmarks/run.py --check-parity`` — perf runs double as regression
  checks on the bench mix;
* ``python -m repro_torch.launch.pool --check-parity`` — CLI preflight.

The closed-loop plan store has its own parity obligation: a
``feedback="ewma"`` scheduler fed a ZERO-ERROR observation stream (every
observation exactly matches its prediction) must reproduce the
``feedback="off"`` timeline bitwise, because a ratio-1.0 observation may
not move any correction off 1.0 and a 1.0 correction may not change any
prediction.  ``check_parity`` runs that leg too (``zero_error=True``
flips the correction table into treat-every-observation-as-exact mode),
so accidental drift in the blend math fails the same smoke as a
strategy-rule drift.  Scope: the lock covers the PREDICTION path — the
configurations it runs are single-tenant and cap-free.  A multi-tenant
pool with a demand cap may legitimately diverge even on a zero-error
trace, because ``feedback="ewma"`` prices admission at REMAINING demand
(completed ops drop out), which is a deliberate semantic of the mode,
not blend drift.

Divergence reports name the first mismatching record field-by-field so a
strategy-rule drift between the adapters is diagnosable from CI output
alone.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

from repro_torch.core.graph import DynamicOpGraph, OpGraph, build_paper_graph
from repro_torch.core.runtime import ConcurrencyRuntime, RuntimeConfig
from repro_torch.core.simmachine import SimMachine
from repro_torch.core.strategy import PreemptionPolicy, ScheduleResult
from repro_torch.multitenant.pool import PoolConfig, RuntimePool
from repro_torch.obs.trace import RecordingSink

# the fields of one timeline row, in report order
_ROW_FIELDS = ("uid", "op_class", "threads", "variant", "hyper",
               "start", "finish", "predicted")


def corun_timeline(graph: OpGraph, machine: SimMachine | None = None,
                   config: RuntimeConfig | None = None, *,
                   zero_error: bool = False) -> ScheduleResult:
    """Profile + schedule one graph with the single-graph scheduler.

    ``zero_error=True`` (meaningful only with ``config.feedback="ewma"``)
    flips the runtime's correction table into the parity mode where every
    observation is treated as exactly matching its prediction — the
    resulting timeline must be bitwise the ``feedback="off"`` one."""
    rt = ConcurrencyRuntime(machine=machine or SimMachine(), config=config)
    rt.profile(graph)
    if zero_error:
        corrections = getattr(rt.planstore, "corrections", None)
        if corrections is not None:
            corrections.zero_error = True
    return rt.execute_step(graph)


def pool_timeline(graph: OpGraph, machine: SimMachine | None = None,
                  config: RuntimeConfig | None = None, *,
                  pool_config: PoolConfig | None = None,
                  zero_error: bool = False) -> ScheduleResult:
    """The same graph as the ONLY tenant of a RuntimePool.

    ``pool_config`` overrides the default single-tenant pool setup, so
    differential tests can vouch for POOL-level knobs too (e.g. a
    preemption-enabled pool with no deadlines must still reproduce the
    single-graph scheduler bit-for-bit).  It is exclusive with ``config``
    — silently preferring one would let a parity test vouch for a
    configuration it never ran.  ``zero_error`` mirrors
    ``corun_timeline``: with ``feedback="ewma"`` the pool's shared
    correction table treats every observation as exact."""
    if pool_config is not None and config is not None:
        raise ValueError("pass either config or pool_config, not both "
                         "(set pool_config.runtime instead)")
    if pool_config is None:
        pool_config = PoolConfig(max_active=1,
                                 runtime=config or RuntimeConfig())
    pool = RuntimePool(machine=machine or SimMachine(), config=pool_config)
    if zero_error and pool.corrections is not None:
        pool.corrections.zero_error = True
    job = pool.submit(graph)
    res = pool.run()
    return res.per_job_schedule(job.jid)


def cluster_timeline(graph: OpGraph, machine: SimMachine | None = None,
                     config: RuntimeConfig | None = None) -> ScheduleResult:
    """The same graph as the only tenant of a ONE-MACHINE ClusterPool.

    The cluster layer (router, demand index, rebalance check, shared jid
    space) must be bit-for-bit inert when there is nothing to route
    between: a 1-machine cluster IS the single-machine pool."""
    # function-local for the same layering reason as service_timeline:
    # the cluster package imports multitenant modules
    from repro_torch.cluster import ClusterPool
    from repro_torch.hw.spec import ClusterSpec

    machine = machine or SimMachine()
    pool = ClusterPool(ClusterSpec(machines=(machine.spec,)),
                       config=PoolConfig(max_active=1,
                                         runtime=config or RuntimeConfig()),
                       machines=[machine])
    job = pool.submit(graph)
    return pool.run().per_job_schedule(job.jid)


def service_timeline(model: str, machine: SimMachine | None = None,
                     config: RuntimeConfig | None = None, *,
                     scale: int = 1) -> ScheduleResult:
    """The same graph as the only tenant of a ``--once`` pool DAEMON
    (submit-all-then-drain through ``repro_torch.service.PoolDaemon``, state
    dir discarded).  The daemon wraps the pool in checkpointing, a job
    store, and the payload-observer seam — all of which must be
    bit-for-bit inert on the scheduling timeline.  The paper graphs carry
    no payloads, so the daemon's executor never runs one: it is built on
    the CPU and this leg touches no card."""
    import tempfile

    # function-local: parity is imported by the multitenant package
    # __init__, and the service package imports multitenant modules
    from repro_torch.service import JobSpec, PoolDaemon
    with tempfile.TemporaryDirectory() as td:
        daemon = PoolDaemon(
            td, config=PoolConfig(max_active=1,
                                  runtime=config or RuntimeConfig()),
            machine=machine or SimMachine(), device="cpu")
        daemon.submit(JobSpec(workload=model, scale=scale))
        res = daemon.drain()
        daemon.close()
        return res.per_job_schedule(daemon.pool.jobs[0].jid)


def timeline_rows(result: ScheduleResult) -> list[dict]:
    """JSON-serializable per-op launch records (golden-fixture format).

    Floats are kept at full precision — ``json`` round-trips Python floats
    exactly — so fixture comparisons are bit-exact, not approximate."""
    return [{"uid": r.op.uid, "op_class": r.op.op_class,
             "threads": r.threads, "variant": r.variant, "hyper": r.hyper,
             "start": r.start, "finish": r.finish, "predicted": r.predicted}
            for r in result.records]


def compare_timelines(a: list[dict], b: list[dict], *,
                      label_a: str = "corun",
                      label_b: str = "pool") -> list[str]:
    """Field-by-field divergences between two timelines (empty = parity)."""
    divergences: list[str] = []
    if len(a) != len(b):
        divergences.append(
            f"record count: {label_a}={len(a)} {label_b}={len(b)}")
    for i, (ra, rb) in enumerate(zip(a, b)):
        for f in _ROW_FIELDS:
            if ra.get(f) != rb.get(f):
                divergences.append(
                    f"record {i} field {f!r}: {label_a}={ra.get(f)!r} "
                    f"{label_b}={rb.get(f)!r}")
    return divergences


def check_parity(models: Iterable[str] = ("resnet50", "dcgan"), *,
                 seed: int = 0, scale: int = 1,
                 config: RuntimeConfig | None = None) -> dict:
    """Pool-vs-corun parity over paper-zoo models, plus the closed-loop
    zero-error leg and the trace-inertness leg.

    Per model, NINE pool/corun timelines must agree bitwise with the
    single-graph ``feedback="off"`` reference: the single-job pool (the
    strategy-core differential), a single-job pool with a live
    ``RecordingSink`` (the observability lock — tracing must be
    bit-for-bit inert, and a traced run that records ZERO events is
    itself flagged, so the leg can't pass vacuously with a disconnected
    sink), a preemption-ENABLED pool with the economics knobs at their
    off defaults and no deadlines (the preemption-economics surface must
    be inert unless armed AND triggered), both schedulers re-run with
    ``feedback="ewma"`` on a zero-error observation stream (the
    blend-math lock — an exact observation may not move any prediction),
    both schedulers run on the same ops wrapped in a ``DynamicOpGraph``
    with ZERO regions (the dynamic-control-flow lock — the region
    machinery must be bit-for-bit inert on static graphs), a
    submit-all-then-drain run through the pool DAEMON (the service lock
    — checkpointing, the job store, and the payload-observer seam must
    not perturb the timeline), and a ONE-MACHINE ClusterPool run (the
    cluster lock — routing, demand pricing, and the rebalance check must
    be inert with nothing to route between).

    Returns ``{"ok": bool, "models": {name: {"ok", "makespan",
    "divergences"}}}``.  Uses equal-seeded machines (the sim machine is a
    deterministic function of its seed, so equal seeds mean an identical
    timing function).  ``scale``/``config`` must match the run being
    vouched for — parity on a scale-1 graph says nothing about a
    divergence only reachable with a larger ready frontier."""
    report: dict = {"ok": True, "models": {}}
    base = config or RuntimeConfig()
    fb = dataclasses.replace(
        base, strategy=dataclasses.replace(base.strategy, feedback="ewma"))
    for model in dict.fromkeys(models):        # dedupe, keep order
        graph = build_paper_graph(model, scale=scale)
        # the same ops as a region-free dynamic graph: the trivial fixed
        # point of the frontier contract, must schedule bit-identically
        dyn = DynamicOpGraph(name=graph.name, ops=dict(graph.ops))
        single = corun_timeline(graph, SimMachine(seed=seed), config)
        ref = timeline_rows(single)
        sink = RecordingSink()
        legs = {
            "pool": pool_timeline(graph, SimMachine(seed=seed), config),
            "pool-traced": pool_timeline(
                graph, SimMachine(seed=seed),
                pool_config=PoolConfig(max_active=1, runtime=base,
                                       sink=sink)),
            # preemption armed, economics knobs at their OFF defaults, no
            # deadlines: the whole preemption-economics surface must be
            # inert — bit-for-bit the plain pool (the PR-6 behavior lock)
            "pool-preempt": pool_timeline(
                graph, SimMachine(seed=seed),
                pool_config=PoolConfig(
                    max_active=1, runtime=base,
                    preemption=PreemptionPolicy(enabled=True))),
            "corun-ewma0": corun_timeline(graph, SimMachine(seed=seed),
                                          fb, zero_error=True),
            "pool-ewma0": pool_timeline(graph, SimMachine(seed=seed), fb,
                                        zero_error=True),
            "corun-dyn0": corun_timeline(dyn, SimMachine(seed=seed),
                                         config),
            "pool-dyn0": pool_timeline(dyn, SimMachine(seed=seed), config),
            # submit-all-then-drain through the pool DAEMON: the service
            # layer (job store, per-instant checkpointing, observer seam)
            # must reproduce the library pool bit-for-bit
            "service-once": service_timeline(
                model, SimMachine(seed=seed), config, scale=scale),
            # a 1-machine cluster IS the pool: the placement layer must
            # add nothing to the timeline until there is a second machine
            "cluster-1m": cluster_timeline(graph, SimMachine(seed=seed),
                                           config),
        }
        divs: list[str] = []
        if not sink.events:
            divs.append("pool-traced: RecordingSink recorded 0 events — "
                        "the trace seam is disconnected")
        for label, res in legs.items():
            d = compare_timelines(ref, timeline_rows(res), label_b=label)
            if single.makespan != res.makespan:
                d.insert(0, f"makespan: corun={single.makespan!r} "
                            f"{label}={res.makespan!r}")
            divs.extend(d)
        report["models"][model] = {
            "ok": not divs,
            "makespan": single.makespan,
            "divergences": divs,
        }
        if divs:
            report["ok"] = False
    return report
