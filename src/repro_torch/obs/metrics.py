"""Metrics registry: counters, gauges, histograms over scheduler telemetry.

Before this module every benchmark re-derived its own sums from raw
``PoolResult`` records (probe counts here, quadrant-local fractions
there, |log error| quartiles somewhere else).  ``MetricsRegistry`` is the
one accounting surface:

* ``pool_metrics`` folds a finished ``PoolResult`` (plus the plan-cache
  stats and the EWMA correction table) into the standard metric names —
  this is what ``RuntimePool.run`` attaches as ``PoolResult.metrics``,
  with or without tracing;
* ``metrics_from_events`` re-derives the same accounting from the
  decision-event stream ALONE (``repro_torch.obs.trace``) — service and
  restart-waste from the charge/refund events, throughput and fairness
  from the observation stream, probe counts from the profile events.
  The test suite pins that both paths agree, so the event stream is a
  sufficient audit record of what the scheduler did;
* ``slowdown_metrics`` adds the per-job slowdown gauges once a serial
  baseline exists (benches own the baseline, so they call it).

Standard names (see README "Observability" for the glossary):
``pool.*`` run aggregates, ``admission.*``/``queue.*`` the admission
tier, ``sched.*`` launch paths and prediction error, ``preemption.*``
the deadline path, ``placement.*`` quadrant locality, ``cache.*`` the
plan cache, ``feedback.*`` the correction table.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

from repro_torch.obs.trace import (FAM_ADMISSION, FAM_CLUSTER, FAM_PLACEMENT,
                             FAM_PLANSTORE, FAM_PREEMPTION, FAM_REGION,
                             FAM_STRATEGY, TraceEvent)


def _jain(values: list[float]) -> float:
    """Jain's fairness index (1.0 = all equal, 1/n = one takes all);
    duplicated from ``repro_torch.multitenant.job`` deliberately — the obs
    layer must not import the layers that emit into it."""
    if not values:
        return 1.0
    s = sum(values)
    sq = sum(x * x for x in values)
    return (s * s) / (len(values) * sq) if sq else 1.0


@dataclasses.dataclass
class Counter:
    value: float = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


@dataclasses.dataclass
class Gauge:
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = v


@dataclasses.dataclass
class Histogram:
    """Exact histogram (values retained): scheduler runs are bounded, and
    exact percentiles beat bucketed ones for bench assertions."""

    values: list[float] = dataclasses.field(default_factory=list)

    def observe(self, v: float) -> None:
        self.values.append(v)

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def total(self) -> float:
        return sum(self.values)

    @property
    def mean(self) -> float:
        return self.total / len(self.values) if self.values else 0.0

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile, p in [0, 100]."""
        if not self.values:
            return 0.0
        ordered = sorted(self.values)
        rank = max(0, min(len(ordered) - 1,
                          math.ceil(p / 100.0 * len(ordered)) - 1))
        return ordered[rank]

    @property
    def max(self) -> float:
        return max(self.values) if self.values else 0.0


class MetricsRegistry:
    """Named counters/gauges/histograms with a flat ``snapshot()``."""

    def __init__(self) -> None:
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self.counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self.gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        return self.histograms.setdefault(name, Histogram())

    def value(self, name: str) -> float:
        """Scalar lookup across counters and gauges (KeyError if absent —
        a silent 0.0 would let a renamed metric pass a bench assert)."""
        if name in self.counters:
            return self.counters[name].value
        return self.gauges[name].value

    def snapshot(self) -> dict[str, float]:
        """One flat name -> float dict (histograms expand to
        ``.count``/``.mean``/``.p50``/``.p95``/``.max``)."""
        out: dict[str, float] = {}
        for name, c in self.counters.items():
            out[name] = c.value
        for name, g in self.gauges.items():
            out[name] = g.value
        for name, h in self.histograms.items():
            out[f"{name}.count"] = float(h.count)
            out[f"{name}.mean"] = h.mean
            out[f"{name}.p50"] = h.percentile(50)
            out[f"{name}.p95"] = h.percentile(95)
            out[f"{name}.max"] = h.max
        return out


# ---------------------------------------------------------------------------
# PoolResult -> registry (the path RuntimePool.run always takes)
# ---------------------------------------------------------------------------

def pool_metrics(result, *, spec=None, cache_stats=None,
                 corrections=None) -> MetricsRegistry:
    """Standard metrics of one finished pool run.

    ``result`` is duck-typed over ``PoolResult`` (the obs layer must not
    import the pool).  ``spec`` enables the quadrant-locality metrics and
    prices restart waste; ``cache_stats`` is ``PlanCache.stats()``;
    ``corrections`` the pool's shared ``CorrectionTable`` (or None)."""
    reg = MetricsRegistry()
    reg.gauge("pool.makespan_s").set(result.makespan)
    reg.counter("pool.total_ops").inc(result.total_ops)
    reg.gauge("pool.throughput_ops_s").set(result.aggregate_throughput)
    reg.counter("pool.preemptions").inc(result.n_preemptions)
    # preemption economics (0 on every pool that leaves the knobs off):
    # evictions are free admission-level bounces, migrations are priced
    # width re-seats (also present in the preempted partials they revoked)
    reg.counter("pool.evictions").inc(
        sum(getattr(j, "evictions", 0) for j in result.jobs))
    reg.counter("pool.migrations").inc(
        sum(getattr(j, "migrations", 0) for j in result.jobs))
    # dynamic control flow (0 on static mixes; counters only materialize
    # when a region actually stepped, so static snapshots are unchanged)
    n_exp = getattr(result, "n_region_expands", 0)
    if n_exp:
        reg.counter("region.expand").inc(n_exp)
    n_res = getattr(result, "n_region_resolves", 0)
    if n_res:
        reg.counter("region.resolve").inc(n_res)
    service = 0.0
    shares = []
    for j in result.jobs:
        service += j.service
        if j.admit_time is not None:
            shares.append(j.service / max(j.priority, 1e-9))
        if j.queue_wait is not None:
            reg.histogram("queue.wait_s").observe(j.queue_wait)
    reg.counter("pool.service_core_s").inc(service)
    reg.gauge("pool.fairness_jain").set(_jain(shares))
    waste = 0.0
    if spec is not None:
        for recs in result.preempted.values():
            for r in recs:
                # victims are never hyper launches (the deadline path
                # skips them), so the charge-back is at full efficiency
                waste += r.threads * r.duration * spec.restart_waste
    reg.counter("pool.restart_waste_core_s").inc(waste)
    if spec is not None and getattr(spec, "quadrants", 0):
        placed = local = 0
        # revoked partials booked cores too — count them, so this agrees
        # with the per-booking placement events
        all_recs = list(result.records.values()) + \
            list(result.preempted.values())
        for recs in all_recs:
            for r in recs:
                if not r.cores:
                    continue
                placed += 1
                quads = {spec.quadrant_of_core(c) for c in r.cores}
                if len(quads) == 1:
                    local += 1
                reg.histogram("placement.quadrants_per_launch").observe(
                    len(quads))
        if placed:
            reg.counter("placement.launches").inc(placed)
            reg.counter("placement.local").inc(local)
            reg.gauge("placement.local_fraction").set(local / placed)
    # prediction error of the completed timeline (solo-prediction vs
    # achieved duration; hyper launches measure the spare-thread lane,
    # not the curve's placement — same exclusion the EWMA blend makes)
    for recs in result.records.values():
        for r in recs:
            if r.hyper:
                continue
            err = abs(math.log(r.duration / max(r.predicted, 1e-12)))
            reg.histogram("sched.abs_log_err").observe(err)
            reg.histogram(f"sched.abs_log_err/{r.op.op_class}").observe(err)
    if cache_stats is not None:
        for k, v in cache_stats.items():
            reg.gauge(f"cache.{k}").set(float(v))
    if corrections is not None:
        for k, v in corrections.stats().items():
            reg.gauge(f"feedback.{k}").set(float(v))
        for c in corrections.point.values():
            reg.histogram("feedback.abs_log_correction").observe(
                abs(math.log(max(c, 1e-12))))
    return reg


def slowdown_metrics(reg: MetricsRegistry, result,
                     solo_makespans: dict[int, float]) -> MetricsRegistry:
    """Per-job slowdown gauges + slowdown-fairness, given the serial
    baseline the benches own (a pool run alone cannot know them)."""
    for j in result.jobs:
        if j.done and j.latency is not None and j.jid in solo_makespans:
            reg.gauge(f"job.{j.name}.slowdown").set(
                j.latency / max(solo_makespans[j.jid], 1e-12))
    reg.gauge("pool.slowdown_fairness_e2e_jain").set(
        result.slowdown_fairness(solo_makespans))
    reg.gauge("pool.slowdown_fairness_sched_jain").set(
        result.slowdown_fairness(solo_makespans, include_queue_wait=False))
    return reg


# ---------------------------------------------------------------------------
# decision events -> registry (the audit path: events alone)
# ---------------------------------------------------------------------------

def metrics_from_events(events: Iterable[TraceEvent]) -> MetricsRegistry:
    """Re-derive the run's accounting purely from the decision-event
    stream: if this disagrees with ``pool_metrics`` over the same run,
    either an emit site is missing or one is lying — both are bugs the
    test suite exists to catch."""
    reg = MetricsRegistry()
    service: dict[int, float] = {}
    priority: dict[int, float] = {}
    makespan = 0.0
    for e in events:
        makespan = max(makespan, e.ts)
        if e.family == FAM_ADMISSION:
            reg.counter(f"admission.{e.kind}").inc()
            if "queue_depth" in e.data:
                reg.histogram("queue.depth").observe(e.data["queue_depth"])
            if e.kind == "admit" and "queue_wait" in e.data:
                reg.histogram("queue.wait_s").observe(e.data["queue_wait"])
        elif e.family == FAM_STRATEGY:
            if e.kind == "charge":
                jid = e.data["jid"]
                service[jid] = service.get(jid, 0.0) + e.data["amount"]
                priority[jid] = e.data["priority"]
            elif e.kind == "refund":
                jid = e.data["jid"]
                service[jid] = (service.get(jid, 0.0) - e.data["refund"]
                                + e.data["waste"])
                reg.counter("pool.restart_waste_core_s").inc(
                    e.data["waste"])
            elif e.kind == "reject":
                reg.counter("sched.rejects").inc()
                reg.counter(f"sched.reject.{e.data['cause']}").inc()
            elif e.kind == "s2_clamp":
                reg.counter("sched.s2_clamps").inc()
            else:                      # a launch path (s3_admit, fallback,
                reg.counter("sched.launches").inc()      # s4_hyper, ...)
                reg.counter(f"sched.launch.{e.kind}").inc()
        elif e.family == FAM_PLACEMENT:
            if e.kind in ("book", "spill"):
                reg.counter("placement.launches").inc()
                if not e.data.get("spill"):
                    reg.counter("placement.local").inc()
                reg.histogram("placement.quadrants_per_launch").observe(
                    len(e.data["quadrants"]))
            elif e.kind == "avoid_override":
                reg.counter("placement.avoid_overrides").inc()
        elif e.family == FAM_PREEMPTION:
            reg.counter(f"preemption.{e.kind}").inc()
            # re-derive the economics counters PoolResult keeps:
            # "revoke" fires once per revoked victim and "migrate" revokes
            # its launch at the sim level WITHOUT a "revoke" event, so
            # both count as preempted partials; "multi_revoke" is the
            # per-set summary (already counted victim-by-victim)
            if e.kind in ("revoke", "migrate"):
                reg.counter("pool.preemptions").inc()
            if e.kind == "evict":
                reg.counter("pool.evictions").inc()
            if e.kind == "migrate":
                reg.counter("pool.migrations").inc()
        elif e.family == FAM_REGION:
            reg.counter(f"region.{e.kind}").inc()
        elif e.family == FAM_CLUSTER:
            reg.counter(f"cluster.{e.kind}").inc()
            if e.kind == "route":
                reg.counter(
                    f"cluster.machine.{e.data['machine']}.routed").inc()
                if "demand" in e.data:
                    reg.histogram("cluster.routed_demand").observe(
                        e.data["demand"])
            elif e.kind == "rebalance":
                reg.counter(
                    f"cluster.machine.{e.data['to']}.routed").inc()
        elif e.family == FAM_PLANSTORE:
            if e.kind == "profile":
                reg.counter("cache.probes_spent").inc(e.data["probes"])
                reg.counter("cache.hits").inc(e.data["cache_hits"])
            else:
                reg.counter(f"planstore.{e.kind}").inc()
                if e.kind == "finish":
                    reg.counter("pool.total_ops").inc()
                    if not e.data.get("hyper"):
                        err = abs(math.log(
                            e.data["observed"]
                            / max(e.data["predicted"], 1e-12)))
                        reg.histogram("sched.abs_log_err").observe(err)
                        reg.histogram(
                            "sched.abs_log_err/"
                            f"{e.data['op_class']}").observe(err)
    reg.gauge("pool.makespan_s").set(makespan)
    ops = reg.counter("pool.total_ops").value
    reg.gauge("pool.throughput_ops_s").set(ops / max(makespan, 1e-12))
    reg.counter("pool.service_core_s").inc(sum(service.values()))
    reg.gauge("pool.fairness_jain").set(
        _jain([s / max(priority[j], 1e-9) for j, s in service.items()]))
    placed = reg.counters.get("placement.launches")
    if placed is not None and placed.value:
        reg.gauge("placement.local_fraction").set(
            reg.counter("placement.local").value / placed.value)
    return reg
