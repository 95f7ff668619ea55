"""Closed-loop plan store: predictions out, observations back in.

The paper's runtime is a *closed loop*: the performance model predicts op
execution time per concurrency width, the scheduler acts on the
prediction, and observed behavior feeds back (§III-D records co-run
slowdowns into the interference blacklist).  Until this module the
blacklist was the ONLY feedback path we reproduced — every other
prediction (``Plan`` curves, ``Job.demand``, deadline critical paths)
was frozen at profiling/admission time and consumed through ad-hoc
``controller.store.curve(op).predict(...)`` reads scattered across the
schedulers.

``PlanStore`` closes the loop as ONE interface:

* **predict side** — everything a scheduler consumes: per-width op time
  (``predict``), Strategy-3 candidate configurations (``candidates``),
  the frozen-plan width re-priced (``replan``), and the aggregate
  predictions built on top of them — a job's outstanding demand in
  core-seconds (``remaining_demand``) and per-node downstream critical
  paths that turn deadlines into slack (``remaining_critical_path``);
* **observe side** — everything a scheduler produces: launch, finish,
  and preemption-revoke events arrive as ``OpObservation`` records via
  ``observe`` (the ``StrategyAdapter.observe`` seam reports them for
  both the single-graph scheduler and the multi-tenant pool, and
  ``RealGraphExecutor`` reports real payload times (CUDA events on the
  card) through the same call).

Two implementations:

* ``FrozenPlanStore`` — ``feedback="off"`` (the default): predictions
  come from the profiling-time curves verbatim and observations are
  discarded, reproducing the pre-feedback schedulers bit for bit
  (locked by the golden/differential suites);
* ``AdaptivePlanStore`` — ``feedback="ewma"``: observed service is
  EWMA-blended into per-(op-key, width) correction factors over the
  frozen curves, so when profiles mispredict (stale measurements, a
  perturbed machine) every downstream prediction — candidate ranking,
  admission horizons, ``Job.demand``, deadline slack — converges toward
  observed reality while the profiling structure (probe grid, S1/S2
  widths) stays intact.

The blend is the *incremental* EWMA form ``c += alpha * (ratio - c)``,
which is exactly stable at the fixed point: a stream of observations
matching predictions (ratio 1.0) leaves every correction at 1.0 and —
because a 1.0 factor short-circuits to the raw curve value — every
prediction bit-identical to ``feedback="off"``.  The parity suite runs a
zero-error trace through the adaptive store to pin that property.
"""

from __future__ import annotations

import abc
import dataclasses
import math
from typing import Hashable

from repro_torch.core.concurrency import (ConcurrencyController, ConcurrencyPlan,
                                    OpPlan)
from repro_torch.core.graph import Op, OpGraph
from repro_torch.core.perfmodel import CurveModel, cross_graph_key

# observation kinds, as reported through StrategyAdapter.observe
OBS_LAUNCH = "launch"      # op committed to cores (no duration yet)
OBS_FINISH = "finish"      # op completed; observed = full service time
OBS_REVOKE = "revoke"      # op preempted; observed = discarded partial run

FEEDBACK_MODES = ("off", "ewma")


def _freeze(x):
    """JSON arrays -> tuples, recursively.  Learned-state keys are tuples
    (``cross_graph_key`` values, region keys) and JSON round-trips them
    as lists; freezing restores dict-key hashability and equality."""
    if isinstance(x, list):
        return tuple(_freeze(v) for v in x)
    return x


@dataclasses.dataclass(frozen=True)
class OpObservation:
    """One scheduler-reported execution event for one op launch."""

    op: Op
    threads: int
    variant: bool            # affinity flavor of the launch
    hyper: bool              # hyper-thread-lane launch (S4)
    predicted: float         # what the plan said this launch would take
    observed: float          # elapsed seconds (partial for OBS_REVOKE)
    kind: str = OBS_FINISH


def critical_path_from(graph: OpGraph,
                       pred: dict[int, float]) -> dict[int, float]:
    """uid -> ``pred[uid]`` plus the longest consumer chain (reverse
    topological order via Kahn on consumer counts — graph uids are
    usually topo-ordered already, but don't rely on it)."""
    out_deg = {uid: len(graph.consumers(uid)) for uid in graph.ops}
    stack = [uid for uid, n in out_deg.items() if n == 0]
    cp: dict[int, float] = {}
    while stack:
        uid = stack.pop()
        cp[uid] = pred[uid] + max(
            (cp[c] for c in graph.consumers(uid)), default=0.0)
        for d in graph.ops[uid].deps:
            out_deg[d] -= 1
            if out_deg[d] == 0:
                stack.append(d)
    return cp


# ---------------------------------------------------------------------------
# move pricing — the preemption-economics currency
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MovePrice:
    """One candidate scheduler move, priced in a single currency (seconds
    or core-seconds — a price only ever compares against another price in
    the same unit).  ``gain`` is the predicted benefit of making the move,
    ``cost`` the re-billed restart waste it incurs; the scheduler makes
    the move only when the gain STRICTLY exceeds the cost, so a move that
    merely breaks even never discards partial work."""

    gain: float
    cost: float

    @property
    def worth_it(self) -> bool:
        return self.gain > self.cost


def restart_cost(threads: int, elapsed: float, restart_waste: float,
                 efficiency: float = 1.0) -> float:
    """Core-seconds of partial work a checkpoint-free revoke throws away,
    re-billed at the machine's restart-waste factor (the same formula the
    pool's ``refund`` charges back, so a priced move and the accounting
    it triggers can never disagree)."""
    return threads * elapsed * efficiency * restart_waste


def claim_price(width: int, time_without: float, time_with: float,
                waste: float) -> MovePrice:
    """Multi-victim revoke, priced in core-seconds: the SLO gain is the
    waiter's predicted-time improvement at its preferred ``width`` (vs
    the best width reachable without the extra victims), weighted by that
    width; the cost is the summed restart waste of the victim set."""
    return MovePrice(gain=max(0.0, time_without - time_with) * width,
                     cost=waste)


def migration_price(remaining: float, relaunch_time: float, elapsed: float,
                    restart_waste: float) -> MovePrice:
    """Width migration, priced in op-seconds: relaunching is worth it only
    when the predicted relaunch duration plus the re-billed waste (the
    discarded ``elapsed`` at the restart-waste factor) strictly undercuts
    finishing at the current width."""
    return MovePrice(gain=remaining - relaunch_time,
                     cost=elapsed * restart_waste)


def split_price(whole_time: float, split_time: float, transfer_cost: float,
                restart_cost_s: float = 0.0) -> MovePrice:
    """Cross-machine split/move, priced in seconds of the tenant's own
    makespan: spanning a second machine is worth it only when the
    predicted parallel finish strictly undercuts staying put PLUS the
    modeled working-set transfer and any restart waste of already-started
    work.  Same strict-inequality discipline as every other priced move:
    a split that merely breaks even stays on one machine."""
    return MovePrice(gain=max(0.0, whole_time - split_time),
                     cost=transfer_cost + restart_cost_s)


# ---------------------------------------------------------------------------
# demand queries per machine fingerprint — the cluster-routing currency
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DemandIndex:
    """Memoized demand (core-seconds) estimates keyed by
    ``(machine fingerprint, workload key)``.

    The cluster router bin-packs jobs against per-machine free capacity,
    which on a heterogeneous cluster means re-estimating every arriving
    job's demand under EACH candidate machine's cost model.  A full
    re-profile per (job, machine) pair would be absurdly expensive, but
    demand is a pure function of (workload shape, machine fingerprint):
    training jobs repeat a handful of step-graph shapes, so the first
    estimate per pair is authoritative for every later arrival of the
    same shape.  Estimates are keyed by the same canonical fingerprint
    reprs the ``PlanCache`` namespaces curves under — the two caches
    agree about what "the same machine" means."""

    values: dict = dataclasses.field(default_factory=dict)
    hits: int = 0
    misses: int = 0

    @staticmethod
    def workload_key(graph) -> tuple:
        """Canonical shape key of a graph: the sorted multiset of its
        per-op cross-graph keys.  Two independently built graphs with the
        same op population have the same demand on the same machine."""
        from repro_torch.core.perfmodel import cross_graph_key
        return tuple(sorted(map(repr, (cross_graph_key(op)
                                       for op in graph.ops.values()))))

    def query(self, fingerprint, graph, compute) -> float:
        """Demand of ``graph`` on the machine ``fingerprint`` — memoized;
        ``compute()`` (profile + ``remaining_demand`` under that
        machine's planstore) runs only on the first miss per pair."""
        key = (repr(fingerprint), self.workload_key(graph))
        if key in self.values:
            self.hits += 1
            return self.values[key]
        self.misses += 1
        value = float(compute())
        self.values[key] = value
        return value

    def peek(self, fingerprint, graph, *,
             count: bool = False) -> float | None:
        """Memoized demand if present, without computing (used by the
        router's capacity projections, which must never trigger a
        profile).  ``count=True`` bills a found value as a hit — the
        router's facts pass sets it so reuse shows up in the stats;
        existence probes leave the counters alone."""
        v = self.values.get((repr(fingerprint), self.workload_key(graph)))
        if count and v is not None:
            self.hits += 1
        return v


class PlanStore(abc.ABC):
    """Every prediction a scheduler consumes and every completion it
    produces, through one interface (see module docstring)."""

    # ---- predict side --------------------------------------------------
    @abc.abstractmethod
    def predict(self, op: Op, threads: int, variant: bool) -> float:
        """Predicted solo execution time of ``op`` at a width/affinity."""

    @abc.abstractmethod
    def candidates(self, op: Op, k: int = 3) -> list[OpPlan]:
        """Strategy 3's top-k candidate configurations for ``op``."""

    def replan(self, op: Op, base: OpPlan) -> OpPlan:
        """The frozen plan's width, re-priced by the store — the
        instance-plan lookup both scheduler adapters use."""
        return OpPlan(base.threads, base.variant,
                      self.predict(op, base.threads, base.variant))

    # ---- observe side --------------------------------------------------
    def observe(self, obs: OpObservation) -> None:
        """Report an execution event.  The frozen store discards it."""

    def observe_region(self, region, outcome: float) -> None:
        """Report a region resolution (observed trip count for a while,
        1.0/0.0 branch direction for a cond).  Frozen stores discard it;
        the adaptive store feeds its ``TripCountEstimator``."""

    @property
    def adaptive(self) -> bool:
        """True when observations can change future predictions (callers
        that re-derive cached aggregates key off this)."""
        return False

    # ---- region expectations -------------------------------------------
    # Unresolved regions have no materialized ops to price, so their
    # contribution to demand/critical-path is an EXPECTATION: expected
    # remaining trip count x per-iteration body cost for a while region,
    # probability-weighted branch costs for a cond.  The frozen store
    # prices from the build-time priors (``est_trips``/``p_true``); the
    # adaptive store substitutes pool-wide learned estimates.

    def region_trips(self, region) -> float:
        """Expected TOTAL trip count of a while region (prior-based)."""
        return min(max(float(region.est_trips), 0.0),
                   float(region.max_trips))

    def region_taken_p(self, region) -> float:
        """Probability the cond region takes its true branch."""
        return min(max(float(region.p_true), 0.0), 1.0)

    def _plan_time(self, op: Op, plan: ConcurrencyPlan) -> float:
        p = plan.per_instance[op.size_key]
        return self.predict(op, p.threads, p.variant)

    def _plan_demand(self, body: OpGraph, plan: ConcurrencyPlan) -> float:
        total = 0.0
        for op in body.ops.values():
            p = plan.per_instance[op.size_key]
            total += self.predict(op, p.threads, p.variant) * p.threads
        return total

    def _body_tail(self, body: OpGraph, plan: ConcurrencyPlan) -> float:
        pred = {u: self._plan_time(op, plan) for u, op in body.ops.items()}
        return max(critical_path_from(body, pred).values(), default=0.0)

    def region_demand(self, region, plan: ConcurrencyPlan) -> float:
        """Expected outstanding core-seconds of an unresolved region
        (iterations/branches not yet materialized, plus the exit op)."""
        p_exit = plan.per_instance[region.exit_op.size_key]
        exit_d = (self.predict(region.exit_op, p_exit.threads,
                               p_exit.variant) * p_exit.threads)
        if region.kind == "cond":
            p = self.region_taken_p(region)
            return (p * self._plan_demand(region.branches[0], plan)
                    + (1.0 - p) * self._plan_demand(region.branches[1], plan)
                    + exit_d)
        future = max(self.region_trips(region) - region.trips_started, 0.0)
        return future * self._plan_demand(region.body, plan) + exit_d

    def region_tail(self, region, plan: ConcurrencyPlan) -> float:
        """Expected serial time through an unresolved region's not-yet
        materialized part (iteration critical paths chain; branches are
        probability-weighted), ending with the exit op."""
        exit_t = self._plan_time(region.exit_op, plan)
        if region.kind == "cond":
            p = self.region_taken_p(region)
            return (p * self._body_tail(region.branches[0], plan)
                    + (1.0 - p) * self._body_tail(region.branches[1], plan)
                    + exit_t)
        future = max(self.region_trips(region) - region.trips_started, 0.0)
        return future * self._body_tail(region.body, plan) + exit_t

    # ---- aggregate predictions ----------------------------------------
    def remaining_demand(self, graph: OpGraph, plan: ConcurrencyPlan,
                         done: frozenset[int] | set[int] = frozenset()
                         ) -> float:
        """Outstanding predicted core-seconds of ``graph`` under the
        frozen plan widths, excluding completed uids — the admission and
        fair-share currency (``Job.demand``).  Unresolved regions add
        their expected demand (a dynamic graph with zero unresolved
        regions prices bit-identically to the static graph)."""
        total = 0.0
        for uid, op in graph.ops.items():
            if uid in done:
                continue
            p = plan.per_instance[op.size_key]
            total += self.predict(op, p.threads, p.variant) * p.threads
        regions = graph.unresolved_regions()
        if regions:
            total += sum(self.region_demand(r, plan) for r in regions)
        return total

    def remaining_critical_path(self, graph: OpGraph, plan: ConcurrencyPlan,
                                done: frozenset[int] | set[int] = frozenset()
                                ) -> dict[int, float]:
        """uid -> predicted time from starting that node to finishing the
        graph (the node's own re-priced plan prediction plus the longest
        consumer chain; completed nodes contribute zero).  This is what
        turns a job deadline into per-node slack (``Job.cp``).

        Unresolved regions join the longest-path computation as VIRTUAL
        nodes: each reserved exit uid gets weight ``region_tail`` (the
        expected serial time through the unmaterialized part) and a
        virtual edge from every gate uid, so a node upstream of a
        half-unrolled loop sees deadline slack through the loop's
        expected remainder.  The virtual exit entries stay in the
        returned dict (the pool's root-slack takes a max over values).
        With zero unresolved regions this is exactly the static path."""
        pred = {}
        for uid, op in graph.ops.items():
            if uid in done:
                pred[uid] = 0.0
            else:
                p = plan.per_instance[op.size_key]
                pred[uid] = self.predict(op, p.threads, p.variant)
        regions = graph.unresolved_regions()
        if not regions:
            return critical_path_from(graph, pred)
        tail = {r.exit_uid: self.region_tail(r, plan) for r in regions}
        extra: dict[int, list[int]] = {}
        for r in regions:
            for g in r.gate:
                extra.setdefault(g, []).append(r.exit_uid)

        def succ(u: int) -> list[int]:
            return list(graph.consumers(u)) + extra.get(u, [])

        cp: dict[int, float] = {}
        for root in (*graph.ops, *tail):
            stack = [root]
            while stack:
                u = stack[-1]
                if u in cp:
                    stack.pop()
                    continue
                pending = [s for s in succ(u) if s not in cp]
                if pending:
                    stack.extend(pending)
                    continue
                own = tail[u] if u in tail else pred[u]
                cp[u] = own + max((cp[s] for s in succ(u)), default=0.0)
                stack.pop()
        return cp


class FrozenPlanStore(PlanStore):
    """``feedback="off"``: the profiling-time curves, verbatim.

    Predictions resolve against the controller's frozen ``ProfileStore``
    exactly as the pre-feedback schedulers did (same floats, same
    candidate order), and ``observe`` is a no-op — so every scheduler
    built on this store is bit-for-bit the PR-4 scheduler."""

    def __init__(self, controller: ConcurrencyController):
        self.controller = controller

    def predict(self, op: Op, threads: int, variant: bool) -> float:
        return self.controller.store.curve(op).predict(threads, variant)

    def candidates(self, op: Op, k: int = 3) -> list[OpPlan]:
        return self.controller.candidates_for(op, k)


@dataclasses.dataclass
class CorrectionTable:
    """Shared EWMA state: observed/predicted service ratios per curve
    point, blended incrementally (``c += alpha * (ratio - c)``).

    One table can back many ``AdaptivePlanStore`` views (the pool shares
    one across all tenants, keyed by ``cross_graph_key`` — the same key
    the PlanCache shares curves under, so an op two tenants both run
    teaches both).  ``point`` entries correct the exact (key, width,
    variant) observed; ``overall`` keeps a per-key ratio used as the
    fallback for widths never observed, so a correction learned at the
    plan width still informs a squeezed fallback launch.

    ``zero_error`` is the parity-suite hook: every observation is
    treated as exactly matching its prediction (ratio 1.0), which must
    leave the adaptive store bit-identical to the frozen one — any drift
    is a bug in the blend math."""

    alpha: float = 0.25
    # observed/predicted ratios outside this band are clamped before
    # blending: a single pathological co-run (or a division by a tiny
    # prediction) must not catapult the correction
    ratio_bounds: tuple[float, float] = (0.125, 8.0)
    zero_error: bool = False
    point: dict[tuple[Hashable, int, bool], float] = dataclasses.field(
        default_factory=dict)
    overall: dict[Hashable, float] = dataclasses.field(default_factory=dict)
    observed: int = 0        # finish observations blended
    revoked: int = 0         # preemption revokes reported (not blended)

    def update(self, key: Hashable, threads: int, variant: bool,
               ratio: float) -> None:
        lo, hi = self.ratio_bounds
        ratio = min(max(ratio, lo), hi)
        for table, k in ((self.point, (key, threads, variant)),
                         (self.overall, key)):
            old = table.get(k, 1.0)
            table[k] = old + self.alpha * (ratio - old)
        self.observed += 1

    def factor(self, key: Hashable, threads: int, variant: bool) -> float:
        c = self.point.get((key, threads, variant))
        if c is None:
            c = self.overall.get(key, 1.0)
        return c

    def stats(self) -> dict[str, float]:
        mags = [abs(math.log(max(c, 1e-12))) for c in self.point.values()]
        return {
            "observed": self.observed,
            "revoked": self.revoked,
            "points": len(self.point),
            "keys": len(self.overall),
            # how far the blended corrections sit from the frozen curves,
            # in |log| space (0.0 = profiles were exact) — the metrics
            # registry surfaces these as feedback.* gauges
            "mean_abs_log_correction": (sum(mags) / len(mags)
                                        if mags else 0.0),
            "max_abs_log_correction": max(mags, default=0.0),
        }

    # ---- persistence (service daemon job store) -----------------------
    def to_dict(self) -> dict:
        """JSON form.  Floats round-trip exactly (shortest-repr doubles),
        so a reloaded table corrects predictions bit-identically — the
        property the daemon crash-recovery test pins."""
        return {
            "alpha": self.alpha,
            "ratio_bounds": list(self.ratio_bounds),
            "zero_error": self.zero_error,
            "point": [{"key": k, "threads": t, "variant": v, "c": c}
                      for (k, t, v), c in self.point.items()],
            "overall": [{"key": k, "c": c}
                        for k, c in self.overall.items()],
            "observed": self.observed,
            "revoked": self.revoked,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CorrectionTable":
        return cls(
            alpha=float(d["alpha"]),
            ratio_bounds=tuple(d["ratio_bounds"]),
            zero_error=bool(d["zero_error"]),
            point={(_freeze(e["key"]), int(e["threads"]),
                    bool(e["variant"])): float(e["c"])
                   for e in d["point"]},
            overall={_freeze(e["key"]): float(e["c"])
                     for e in d["overall"]},
            observed=int(d["observed"]),
            revoked=int(d["revoked"]),
        )


@dataclasses.dataclass
class TripCountEstimator:
    """Pool-wide EWMA over observed region outcomes, keyed by region key
    (the ``CorrectionTable`` pattern applied to control flow): while
    regions blend observed trip counts, cond regions blend taken
    fractions (resolutions arrive as 1.0/0.0, so the EWMA converges on
    the empirical taken probability).  One estimator backs every
    adaptive store in a pool, so the second tenant running the same loop
    starts with the learned trip count instead of the build-time prior.

    The first observation for a key initializes the estimate directly
    (the build-time prior is a guess, not evidence — don't average
    against it); later observations blend incrementally."""

    alpha: float = 0.5
    values: dict[Hashable, float] = dataclasses.field(default_factory=dict)
    observed: int = 0

    def update(self, key: Hashable, outcome: float) -> None:
        old = self.values.get(key)
        self.values[key] = (outcome if old is None
                            else old + self.alpha * (outcome - old))
        self.observed += 1

    def estimate(self, key: Hashable, prior: float) -> float:
        return self.values.get(key, prior)

    def stats(self) -> dict[str, float]:
        return {"observed": self.observed, "keys": len(self.values)}

    # ---- persistence (service daemon job store) -----------------------
    def to_dict(self) -> dict:
        return {"alpha": self.alpha,
                "values": [{"key": k, "v": v}
                           for k, v in self.values.items()],
                "observed": self.observed}

    @classmethod
    def from_dict(cls, d: dict) -> "TripCountEstimator":
        return cls(alpha=float(d["alpha"]),
                   values={_freeze(e["key"]): float(e["v"])
                           for e in d["values"]},
                   observed=int(d["observed"]))


class AdaptivePlanStore(PlanStore):
    """``feedback="ewma"``: frozen curves, online corrections.

    Predictions are the frozen curve value times the EWMA correction for
    that (op key, width, variant); Strategy-3 candidates are re-ranked
    by their CORRECTED times, so a width the profile under-predicted
    loses its top-k seat once observations expose it.  Only finish
    events blend (a launch carries no duration yet; a revoked partial
    run is not a service time; a hyper-lane duration measures the
    0.55-efficiency spare-thread lane, not the curve's placement) — but
    all events flow through ``observe`` so accounting hooks and future
    stores see the full stream.

    A correction factor of exactly 1.0 short-circuits to the raw curve
    value, so an all-zero-error observation stream keeps this store
    bit-identical to ``FrozenPlanStore`` (the parity lock)."""

    def __init__(self, controller: ConcurrencyController,
                 corrections: CorrectionTable | None = None,
                 trip_counts: TripCountEstimator | None = None):
        self.controller = controller
        self.corrections = (corrections if corrections is not None
                            else CorrectionTable())
        self.trip_counts = (trip_counts if trip_counts is not None
                            else TripCountEstimator())

    @property
    def adaptive(self) -> bool:
        return True

    # region expectations use the learned estimates instead of the priors
    def region_trips(self, region) -> float:
        est = self.trip_counts.estimate(region.key, float(region.est_trips))
        return min(max(est, 0.0), float(region.max_trips))

    def region_taken_p(self, region) -> float:
        p = self.trip_counts.estimate(region.key, float(region.p_true))
        return min(max(p, 0.0), 1.0)

    def observe_region(self, region, outcome: float) -> None:
        self.trip_counts.update(region.key, float(outcome))

    def predict(self, op: Op, threads: int, variant: bool) -> float:
        base = self.controller.store.curve(op).predict(threads, variant)
        c = self.corrections.factor(cross_graph_key(op), threads, variant)
        return base if c == 1.0 else base * c

    def candidates(self, op: Op, k: int = 3) -> list[OpPlan]:
        if not op.tunable:
            # non-tunable ops keep the controller's pinned plan (the
            # runtime never re-tunes them); only the time is re-priced
            base = self.controller.candidates_for(op, 1)[0]
            return [self.replan(op, base)]
        curve = self.controller.store.curve(op)
        # CurveModel.candidates over the same measured-case source and
        # ranking rule, but with CORRECTED times (identical output when
        # every correction is 1.0 — predict() at a probed point returns
        # the sample value exactly, see the zero-error parity suite)
        scored = [(t, v, self.predict(op, t, v))
                  for t, v, _ in curve.measured_cases()]
        return [OpPlan(t, v, y)
                for t, v, y in CurveModel.rank_cases(scored, k)]

    def observe(self, obs: OpObservation) -> None:
        if obs.kind == OBS_REVOKE:
            self.corrections.revoked += 1
            return
        if obs.kind != OBS_FINISH or obs.hyper:
            return
        if self.corrections.zero_error:
            ratio = 1.0
        else:
            # the ratio is observed over the BASE curve prediction, not
            # over obs.predicted (the launch-time prediction, which
            # already carries the current correction — dividing by it
            # would chase the fixed point c^2 = observed/base instead of
            # c = observed/base, stalling convergence at the square root)
            try:
                base = self.controller.store.curve(obs.op).predict(
                    obs.threads, obs.variant)
            except KeyError:
                return              # no curve to correct (unprofiled op)
            ratio = obs.observed / max(base, 1e-12)
        self.corrections.update(cross_graph_key(obs.op), obs.threads,
                                obs.variant, ratio)


def make_plan_store(feedback: str, controller: ConcurrencyController, *,
                    corrections: CorrectionTable | None = None,
                    trip_counts: TripCountEstimator | None = None
                    ) -> PlanStore:
    """The one constructor every runtime/pool uses, so the gating knob
    (``StrategyConfig.feedback``) has a single interpretation."""
    if feedback == "off":
        return FrozenPlanStore(controller)
    if feedback == "ewma":
        return AdaptivePlanStore(controller, corrections, trip_counts)
    raise ValueError(
        f"unknown feedback mode {feedback!r}; expected one of "
        f"{FEEDBACK_MODES}")
