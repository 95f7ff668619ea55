"""Shared strategy core — Strategies 2-4 in ONE place (paper §III-D).

The paper's co-run decision rules used to exist twice: once in
``repro_torch.core.scheduler.CorunScheduler`` (one step graph) and once in
``repro.multitenant.pool.PoolScheduler`` (many tenant graphs), differing
only in job plumbing — a drift hazard the ROADMAP flagged explicitly.
``StrategyCore`` owns the rules once:

* **Strategy 3 admission fixpoint** — ``try_corun`` admits a ready op into
  idle cores when a top-k candidate fits AND won't outlast the running set
  (``free_cores`` / ``remaining_horizon`` / ``pick_admissible``), with the
  ``run_biggest`` fallback (most time-consuming ready op at its frozen
  plan, throughput-guarded when others run);
* **Strategy 4** — ``try_hyper`` runs the smallest ready ops on the
  hyper-thread lane once physical cores are exhausted;
* **Strategy 2 interaction** — every S3 proposal passes through the
  adapter's ``clamp`` (per-class hysteresis guard);
* the **launch drain loop** (``drain``) that fixpoints S3/fallback/S4 at
  one scheduling instant, including the S3-off serial gating;
* the **deadline path** (``try_preempt``, gated by
  ``StrategyConfig.preemption`` — OFF by default): an overdue op (adapter
  reports non-positive deadline slack) launches with the throughput guard
  waived, squeezed to a bounded-loss width if need be, or by revoking the
  longest-remaining running op (checkpoint-free, work-conserving — the
  victim returns to its ready frontier via ``StrategyAdapter.revoke``).

What *varies* between the single-graph scheduler and the multi-tenant pool
is injected through ``StrategyAdapter``:

* **candidate source** — ``ready_groups()`` yields ordered groups of ready
  node keys (one global group for a single graph; one group per tenant,
  ordered by weighted fair share, for the pool);
* **plan/controller lookup** — ``instance_plan`` / ``candidates_for`` /
  ``clamp`` / ``predict`` resolve against the node's own job's frozen plan;
* **bandwidth-share policy** — ``StrategyCore(bw_share=...)``, defaulting
  to the machine's ``corun_bw_share`` contention rule;
* **interference blacklist** — the injected ``InterferenceRecorder`` spans
  whatever co-runs: within one graph or across tenants;
* **accounting** — ``charge`` (weighted-fair-share service for the pool,
  a no-op for a single graph).

Node keys are opaque to the core (``int`` uid for a single graph,
``(jid, uid)`` for the pool).  Because both schedulers execute the same
core, a single-job pool reproduces the single-graph scheduler's timeline
bit-for-bit — locked down by ``tests/test_strategy_differential.py``.
"""

from __future__ import annotations

import abc
import dataclasses
import warnings
from typing import Callable, Hashable, Iterable, Mapping, Sequence

from repro_torch.core.concurrency import OpPlan
from repro_torch.core.graph import Op
from repro_torch.core.interference import InterferenceRecorder, _pair_key
from repro_torch.core.placement import (REL_ANY, REL_CROSS, REL_LOCAL,
                                  place, placement_relation, quadrants_of)
from repro_torch.core.planstore import (OBS_LAUNCH, OBS_REVOKE, MovePrice,
                                  claim_price, migration_price, restart_cost)
from repro_torch.core.simmachine import Placement, SimMachine
from repro_torch.obs.trace import (FAM_PLACEMENT, FAM_PREEMPTION, FAM_STRATEGY,
                             NullSink, TraceEvent, TraceSink)

NodeKey = Hashable            # int (uid) or (jid, uid) — opaque to the core


@dataclasses.dataclass
class ScheduledOp:
    op: Op
    threads: int
    variant: bool
    hyper: bool
    start: float
    finish: float
    predicted: float
    # concrete core ids under topology="quadrant"; empty for flat topology
    # and for hyper-thread-lane launches (they borrow busy cores' spare HW
    # threads machine-wide rather than booking physical cores)
    cores: tuple[int, ...] = ()

    @property
    def duration(self) -> float:
        return self.finish - self.start


@dataclasses.dataclass
class ScheduleResult:
    makespan: float
    records: list[ScheduledOp]
    events: list[tuple[float, int]]      # (time, #co-running) — paper Fig 4
    profiling_probes: int = 0

    @property
    def mean_corunning(self) -> float:
        if not self.events:
            return 0.0
        return sum(n for _, n in self.events) / len(self.events)

    def per_class_time(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for r in self.records:
            out[r.op.op_class] = out.get(r.op.op_class, 0.0) + r.duration
        return out


def free_cores(running: Iterable[ScheduledOp], total_cores: int) -> int:
    """Physical cores not occupied by non-hyper-thread runners."""
    used = sum(r.threads for r in running if not r.hyper)
    return max(0, total_cores - used)


def remaining_horizon(running: Iterable[ScheduledOp], clock: float) -> float:
    """Longest remaining time among running ops — Strategy 3's throughput
    guard: a new co-runner must not outlast everything already running."""
    return max((r.finish - clock for r in running), default=float("inf"))


def pick_admissible(cands: list[OpPlan], free: int,
                    horizon: float) -> OpPlan | None:
    """Strategy 3's admission rule: admissible = fits the idle cores AND
    won't outlast the running set; among admissible candidates pick the
    FEWEST threads (the paper deliberately leaves cores free for more
    co-runners)."""
    adm = [c for c in cands
           if c.threads <= free and c.predicted_time <= horizon]
    return min(adm, key=lambda c: c.threads) if adm else None


# On-disk schema version shared by every config ``to_dict``/``from_dict``
# pair (StrategyConfig here, RuntimeConfig/PoolConfig in repro_torch.core.runtime
# and repro.multitenant.pool).  The pool daemon persists configs with this
# schema and the CLI accepts them, so all three layers share ONE
# serialization; bump on any layout change — ``from_dict`` refuses other
# versions, so a stale daemon store can never half-load into live knobs.
CONFIG_SCHEMA_VERSION = 1


def _check_config_dict(cls_name: str, d: dict, known: set[str], *,
                       versioned: bool = True) -> dict:
    """Shared ``from_dict`` validation: schema version checked (when the
    dict is a top-level versioned document) and unknown keys REJECTED —
    a typo'd or future-schema knob must fail loudly, not be silently
    dropped into a config that then schedules differently."""
    d = dict(d)
    if versioned:
        schema = d.pop("schema", None)
        if schema != CONFIG_SCHEMA_VERSION:
            raise ValueError(
                f"{cls_name}.from_dict: schema version {schema!r} != "
                f"{CONFIG_SCHEMA_VERSION}")
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"{cls_name}.from_dict: unknown keys {unknown}")
    return d


def fold_deprecated_strategy_kwargs(cls_name: str, strategy: "StrategyConfig",
                                    kwargs: dict) -> "StrategyConfig":
    """Back-compat shim for the config redesign: ``RuntimeConfig`` and
    ``PoolConfig`` used to re-declare strategy-owned knobs (topology,
    feedback, preemption, fallback floors, ...) as their own constructor
    kwargs.  Those spellings keep working — folded onto the composed
    ``StrategyConfig`` with a DeprecationWarning naming the keys — so
    existing callers and benchmarks run unchanged while new code passes
    ``strategy=StrategyConfig(...)``.  Overrides apply ON TOP of an
    explicitly passed strategy, which keeps ``dataclasses.replace(cfg,
    feedback="ewma")`` working (replace re-passes the old ``strategy``
    field plus the deprecated key)."""
    if not kwargs:
        return strategy
    known = {f.name for f in dataclasses.fields(StrategyConfig)}
    unknown = sorted(set(kwargs) - known)
    if unknown:
        raise TypeError(
            f"{cls_name}() got unexpected keyword arguments {unknown}")
    warnings.warn(
        f"{cls_name}({', '.join(sorted(kwargs))}) is deprecated: these "
        f"knobs live on StrategyConfig — pass "
        f"strategy=StrategyConfig(...) instead",
        DeprecationWarning, stacklevel=3)
    return dataclasses.replace(strategy, **kwargs)


@dataclasses.dataclass(frozen=True)
class PreemptionPolicy:
    """Checkpoint-free preemption knobs (off by default, so every scheduler
    built on the core — and the differential/golden suites — behaves
    exactly as before unless a pool opts in).

    When a ready op belongs to a tenant whose deadline slack has run out
    (``StrategyAdapter.deadline_slack`` <= 0) and nothing else launched at
    this instant, the core may claim cores for it: first by launching into
    idle cores with the Strategy-3 throughput guard waived (a deadline
    outranks makespan), and failing that by CANCELLING the running op with
    the largest remaining time.  Preemption is work-conserving: the victim
    node returns to its job's ready frontier (it restarts from scratch —
    checkpoint-free) and its partial service is charged back at the
    machine's restart-waste factor.
    """

    enabled: bool = False
    # a victim must have at least this many times the urgent op's predicted
    # time still remaining — never axe an op that would have finished before
    # the waiter anyway (the revoked partial work is pure waste)
    min_victim_advantage: float = 1.0
    # ---- preemption economics (all OFF by default, so an enabled-but-
    # otherwise-default policy behaves exactly as before) ----
    # >1 arms multi-victim preemption: when one victim's cores cannot seat
    # the overdue op's PREFERRED width, assemble a victim set (cheapest
    # summed restart waste first, affinity-aware under quadrant topology)
    # and revoke it atomically — but only when the priced SLO gain exceeds
    # the summed waste (see repro_torch.core.planstore.claim_price)
    max_victims: int = 1
    # admission-level eviction (pool tier, see RuntimePool): before any
    # running work is revoked for an overdue waiter blocked in the
    # admission queue, an admitted job with NO launched ops may be
    # returned to the queue — a free move, zero restart waste
    evict_admitted: bool = False
    # width migration: a drain step that relaunches a running op at a
    # different width when (predicted relaunch time + re-billed restart
    # waste) strictly undercuts finishing at the current width (see
    # repro_torch.core.planstore.migration_price) — the move that un-sticks an
    # op squeezed at claim time or priced wrong by a stale curve
    migration: bool = False

    def to_dict(self) -> dict:
        """JSON form (nested inside a versioned StrategyConfig document,
        so it carries no schema key of its own)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "PreemptionPolicy":
        return cls(**_check_config_dict(
            cls.__name__, dict(d),
            {f.name for f in dataclasses.fields(cls)}, versioned=False))


@dataclasses.dataclass(frozen=True)
class StrategyConfig:
    """The strategy knobs shared by every scheduler built on the core."""

    enable_s3: bool = True
    enable_s4: bool = True
    candidates: int = 3              # Strategy 3 top-k
    max_ht_corunners: int = 2        # Strategy 4 hyper-thread lane width
    min_fallback_cores: int = 4      # don't squeeze the fallback op
    fallback_slack: float = 1.25     # horizon slack for the fallback launch
    preemption: PreemptionPolicy = PreemptionPolicy()
    # "flat": the paper's 68-core pool — no placement, global bw shares,
    # bit-for-bit the pre-topology scheduler (locked by the differential/
    # golden suites).  "quadrant": placement is a scheduling decision —
    # every non-hyper launch books a concrete core set (empty quadrant
    # first, then quadrant-local packing, then bounded spill), bw shares
    # are computed from actual quadrant co-residents, and interference is
    # recorded per placement relation (local vs cross-quadrant).
    topology: str = "flat"
    # closed-loop plan feedback ("off" | "ewma", see repro_torch.core.planstore).
    # "off" keeps every prediction frozen at profiling time — bit-for-bit
    # the pre-feedback schedulers (the golden/differential lock).  "ewma"
    # blends observed service back into the plan store: candidate ranking,
    # admission horizons, Job.demand, and deadline slack all track
    # observed reality when profiles mispredict.
    feedback: str = "off"
    # decision-trace sink (repro_torch.obs.trace).  The default NullSink keeps
    # every emit site dormant — the traced and untraced schedulers are
    # bit-for-bit identical (locked by the traced parity leg); all
    # NullSink instances compare equal so config equality is unaffected.
    sink: TraceSink = dataclasses.field(default_factory=NullSink)

    # the knobs excluded from serialization: a sink is a live process
    # object (a deserialized config starts with the inert NullSink and a
    # daemon attaches its own sink explicitly)
    _UNSERIALIZED = frozenset({"sink", "preemption"})

    def to_dict(self) -> dict:
        """Versioned JSON form — the ONE serialization of strategy knobs
        shared by the CLI (``--config``), the daemon's persisted store,
        and ``RuntimeConfig``/``PoolConfig`` round-trips."""
        d: dict = {"schema": CONFIG_SCHEMA_VERSION}
        for f in dataclasses.fields(self):
            if f.name not in self._UNSERIALIZED:
                d[f.name] = getattr(self, f.name)
        d["preemption"] = self.preemption.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "StrategyConfig":
        d = dict(d)
        pre = d.pop("preemption", None)
        kw = _check_config_dict(
            cls.__name__, d,
            {f.name for f in dataclasses.fields(cls)} - cls._UNSERIALIZED)
        if pre is not None:
            kw["preemption"] = PreemptionPolicy.from_dict(pre)
        return cls(**kw)


class StrategyAdapter(abc.ABC):
    """The seam a scheduler implements to drive ``StrategyCore``.

    An adapter is a *view* over one scheduler's discrete-event state plus
    its plan/controller lookups; the core never touches sims or jobs
    directly.  ``repro_torch.core.scheduler`` adapts one ``_EventSim``;
    ``repro.multitenant.pool`` adapts a ``_PoolSim`` with job-aware
    lookups and fair-share ordering."""

    # ---- sim view -----------------------------------------------------
    @property
    @abc.abstractmethod
    def clock(self) -> float: ...

    @property
    @abc.abstractmethod
    def running(self) -> Mapping[NodeKey, ScheduledOp]: ...

    @abc.abstractmethod
    def ready_groups(self) -> list[Sequence[NodeKey]]:
        """Ordered candidate groups of ready node keys.  The core tries
        groups in order (pool: most-owed tenant first) and, inside a
        group, orders ops itself per strategy.  Group order is the
        injected scheduling POLICY (fair share); in-group rule is the
        paper's MECHANISM."""

    @abc.abstractmethod
    def op(self, key: NodeKey) -> Op: ...

    # ---- plan / controller lookup --------------------------------------
    @abc.abstractmethod
    def instance_plan(self, key: NodeKey) -> OpPlan:
        """The node's frozen S1/S2 plan with an instance-specific
        predicted time (re-predicted from the node's own curve)."""

    @abc.abstractmethod
    def candidates_for(self, key: NodeKey, k: int) -> list[OpPlan]:
        """Strategy 3's top-k candidate configurations for the node."""

    @abc.abstractmethod
    def clamp(self, key: NodeKey, proposal: OpPlan) -> OpPlan:
        """Strategy 2 hysteresis guard over an S3 proposal."""

    @abc.abstractmethod
    def predict(self, key: NodeKey, threads: int, variant: bool) -> float:
        """Curve prediction for an arbitrary thread count (fallback clamp
        to idle cores)."""

    def serial_time(self, key: NodeKey) -> float:
        """Strategy 4's 'smallest op' metric: serial-execution time."""
        return self.predict(key, 1, False)

    # ---- commit --------------------------------------------------------
    @abc.abstractmethod
    def commit(self, key: NodeKey, sched: ScheduledOp) -> None:
        """Remove the node from the ready frontier and register the launch
        with the event sim."""

    def charge(self, key: NodeKey, sched: ScheduledOp) -> None:
        """Post-launch accounting hook (pool: weighted fair share)."""

    def observe(self, key: NodeKey, sched: ScheduledOp, kind: str,
                elapsed: float) -> None:
        """Report an execution event to the scheduler's plan store — the
        closed-loop seam (see ``repro_torch.core.planstore``).  The core calls
        it on every launch (``OBS_LAUNCH``, elapsed 0) and preemption
        revoke (``OBS_REVOKE``, elapsed = discarded partial run); the
        schedulers' event loops call it on every completion
        (``OBS_FINISH``, elapsed = service time).  The default is a
        no-op, so adapters without a store — and every
        ``feedback="off"`` scheduler — behave exactly as before."""

    def placement_hint(self, key: NodeKey) -> int | None:
        """Preferred quadrant for the node's launch under
        ``topology="quadrant"`` (pool: the tenant's last-used quadrant, so
        a job's ops keep landing where its working set already lives).
        ``None`` means no affinity; flat topology never consults this."""
        return None

    # ---- deadlines / preemption (optional) -----------------------------
    def deadline_slack(self, key: NodeKey) -> float | None:
        """Deadline slack of the node's tenant at this instant: time left
        until the deadline minus the node's predicted downstream critical
        path.  ``None`` means no deadline (the default — single-graph
        scheduling has no SLOs, so preemption can never trigger there)."""
        return None

    def revoke(self, key: NodeKey) -> ScheduledOp:
        """Cancel a running launch: remove it from the event sim and return
        the node to its ready frontier (checkpoint-free — it will restart
        from scratch).  Only adapters that opt into preemption implement
        this; the core never calls it unless the policy is enabled."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support preemption")

    def refund(self, key: NodeKey, sched: ScheduledOp,
               elapsed: float) -> None:
        """Accounting reversal for a revoked launch: un-charge the launch-
        time service and bill the wasted partial run instead (pool: at the
        machine's restart-waste factor)."""

    def migrated(self, key: NodeKey, revoked: ScheduledOp) -> None:
        """Bookkeeping hook for a width migration (the revoke/refund pair
        already handled the accounting; this only lets the adapter count
        the move separately from SLO preemptions — pool: Job.migrations)."""


class StrategyCore:
    """Strategies 2-4 over any ``StrategyAdapter``.

    ``bw_share`` is the injected contention policy ``(threads,
    co_running_threads) -> share``; it defaults to the machine's
    ``corun_bw_share`` so every scheduler divides MCDRAM identically.
    """

    def __init__(self, machine: SimMachine,
                 config: StrategyConfig | None = None, *,
                 recorder: InterferenceRecorder | None = None,
                 total_cores: int | None = None,
                 bw_share: Callable[[int, Iterable[int]], float] | None = None):
        self.machine = machine
        self.config = config or StrategyConfig()
        self.recorder = (recorder if recorder is not None
                         else InterferenceRecorder())
        self.cores = total_cores or machine.spec.cores
        self.bw_share = bw_share or machine.corun_bw_share
        self.sink = self.config.sink
        self._blacklist: frozenset[tuple[str, str]] | None = None

    def _emit(self, family: str, kind: str, key: NodeKey,
              clock: float, **data) -> None:
        """Build and emit one decision event.  Callers guard on
        ``self.sink.enabled`` FIRST so the default NullSink path never
        constructs event payloads (tracing must cost one attribute read
        when off)."""
        self.sink.emit(TraceEvent(ts=clock, family=family, kind=kind,
                                  key=key, data=data))

    # ------------------------------------------------------------------
    def begin_run(self) -> None:
        """Freeze the interference blacklist for one scheduling run.

        The paper avoids recorded-interference pairs "in the future
        training steps": the snapshot taken here is what every launch
        path of THIS run enforces, while observations recorded during the
        run accumulate in the recorder and only bite on the next
        ``begin_run``.  Live-consulting the recorder instead would let
        ordinary modeled contention (every co-run observation exceeds the
        solo prediction by construction) serialize the machine mid-run."""
        self._blacklist = self.recorder.blacklist()

    def _blacklisted_pair(self, a: str, b: str, relation: str) -> bool:
        if self._blacklist is None:        # no snapshot: live recorder view
            return self.recorder.blacklisted(a, b, relation)
        return _pair_key(a, b) + (relation,) in self._blacklist

    def _compat_relations(self, hyper: bool) -> tuple[str, ...]:
        """Which blacklist relations make a pair HARD-incompatible.

        Flat topology has one bucket.  Under quadrant topology an "any"
        entry (pre-seeded or carried over from a flat run) and a "local"
        entry (the pair interferes even placed in disjoint quadrants —
        a true global-bandwidth conflict) always forbid the co-run; a
        "cross"-only entry does NOT — the pair is re-admitted as long as
        placement keeps their quadrants disjoint (see
        ``_placement_avoid``).  A hyper-thread launch rides busy cores
        machine-wide, so every co-run it joins IS a cross-quadrant one
        and the cross relation turns hard for it."""
        if self.config.topology != "quadrant":
            return (REL_ANY,)
        return (REL_ANY, REL_LOCAL, REL_CROSS) if hyper \
            else (REL_ANY, REL_LOCAL)

    def _compatible(self, op_class: str, running_classes: list[str],
                    hyper: bool = False) -> bool:
        rels = self._compat_relations(hyper)
        return not any(self._blacklisted_pair(op_class, r, rel)
                       for r in running_classes for rel in rels)

    def _placement_avoid(self, op_class: str,
                         adapter: StrategyAdapter) -> frozenset[int] | None:
        """Quadrants the launch must stay out of: those occupied by
        runners whose class pair is blacklisted under the CROSS relation
        (they may still co-run quadrant-LOCALLY — the whole point of
        splitting the recorder key).  ``None`` = no feasible placement at
        all: a cross-blacklisted co-runner with no placement (hyper lane)
        rides every quadrant, so no core set can dodge it."""
        if self.config.topology != "quadrant":
            return frozenset()
        avoid: set[int] = set()
        for r in adapter.running.values():
            if self._blacklisted_pair(op_class, r.op.op_class, REL_CROSS):
                if not r.cores:
                    return None
                avoid |= quadrants_of(self.machine.spec, r.cores)
        return frozenset(avoid)

    def _place(self, adapter: StrategyAdapter, key: NodeKey, plan: OpPlan,
               avoid: frozenset[int]) -> tuple[int, ...] | None:
        """Concrete core set for a non-hyper launch (empty tuple under
        flat topology — placement stays out of the flat scheduler
        entirely, preserving bit-for-bit parity)."""
        if self.config.topology != "quadrant":
            return ()
        busy = frozenset(c for r in adapter.running.values()
                         for c in r.cores)
        return place(self.machine.spec, plan.threads, busy,
                     cache_sharing=plan.variant,
                     prefer=adapter.placement_hint(key), avoid=avoid)

    def free(self, adapter: StrategyAdapter) -> int:
        return free_cores(adapter.running.values(), self.cores)

    def _share(self, plan: OpPlan, adapter: StrategyAdapter,
               cores: tuple[int, ...] = ()) -> float:
        """Modeled bandwidth share of the launch against what's running."""
        if cores:
            # topology-aware contention: share computed from the actual
            # quadrant co-residents, not the flat global pool
            return self.machine.quadrant_bw_share(
                cores, [(r.threads, r.cores)
                        for r in adapter.running.values()])
        return self.bw_share(
            plan.threads, (r.threads for r in adapter.running.values()))

    def _duration(self, op: Op, plan: OpPlan, hyper: bool,
                  share: float) -> float:
        pl = Placement(plan.threads, cache_sharing=plan.variant,
                       hyper_thread=hyper)
        return self.machine.op_time(op, pl, bw_share=share)

    def launch(self, adapter: StrategyAdapter, key: NodeKey, plan: OpPlan,
               hyper: bool, cores: tuple[int, ...] = (), *,
               path: str = "s3_admit") -> ScheduledOp:
        op = adapter.op(key)
        share = self._share(plan, adapter, cores)
        dur = self._duration(op, plan, hyper, share)
        sched = ScheduledOp(op=op, threads=plan.threads, variant=plan.variant,
                            hyper=hyper, start=adapter.clock,
                            finish=adapter.clock + dur,
                            predicted=plan.predicted_time, cores=cores)
        if self.sink.enabled:
            self._emit(FAM_STRATEGY, path, key, adapter.clock,
                       op_class=op.op_class, threads=plan.threads,
                       variant=plan.variant, hyper=hyper,
                       predicted=plan.predicted_time, bw_share=share,
                       finish=sched.finish, cores=cores,
                       co_running=len(adapter.running))
            if self.config.topology == "quadrant" and cores:
                quads = quadrants_of(self.machine.spec, cores)
                self._emit(FAM_PLACEMENT,
                           "spill" if len(quads) > 1 else "book",
                           key, adapter.clock, quadrants=sorted(quads),
                           spill=len(quads) > 1, width=len(cores),
                           prefer=adapter.placement_hint(key))
        # interference bookkeeping: observed co-run duration vs solo model,
        # keyed by class pair (the machine doesn't care who launched what)
        # plus, under quadrant topology, the pair's placement relation —
        # a cross-quadrant slowdown must not blacklist quadrant-local
        # co-runs of the same classes
        quadrant = self.config.topology == "quadrant"
        for other in adapter.running.values():
            rel = (placement_relation(self.machine.spec, cores, other.cores)
                   if quadrant else REL_ANY)
            self.recorder.record(op.op_class, other.op.op_class,
                                 plan.predicted_time, dur, relation=rel)
        adapter.commit(key, sched)
        adapter.charge(key, sched)
        adapter.observe(key, sched, OBS_LAUNCH, 0.0)
        return sched

    # ---- Strategy 3 ----------------------------------------------------
    def try_corun(self, adapter: StrategyAdapter) -> bool:
        """Admit one ready op into idle cores.  True if launched."""
        free = self.free(adapter)
        if free <= 0:
            return False
        running = adapter.running
        running_classes = [r.op.op_class for r in running.values()]
        horizon = remaining_horizon(running.values(), adapter.clock)
        for group in adapter.ready_groups():
            # examine ready ops, most expensive first (they gate the
            # critical path)
            order = sorted(
                group,
                key=lambda k: -adapter.instance_plan(k).predicted_time)
            for key in order:
                op = adapter.op(key)
                traced = self.sink.enabled
                if not self._compatible(op.op_class, running_classes):
                    if traced:
                        self._emit(FAM_STRATEGY, "reject", key,
                                   adapter.clock, cause="blacklist",
                                   op_class=op.op_class)
                    continue
                avoid = self._placement_avoid(op.op_class, adapter)
                if avoid is None:
                    if traced:
                        self._emit(FAM_STRATEGY, "reject", key,
                                   adapter.clock, cause="no_feasible_quadrant",
                                   op_class=op.op_class)
                    continue
                cands = adapter.candidates_for(key, self.config.candidates)
                pick = pick_admissible(cands, free, horizon)
                if pick is None:
                    if traced:
                        self._emit(FAM_STRATEGY, "reject", key,
                                   adapter.clock, cause="no_admissible",
                                   op_class=op.op_class, free=free,
                                   horizon=horizon,
                                   candidates=[(c.threads, c.predicted_time)
                                               for c in cands])
                    continue
                proposal = pick
                pick = adapter.clamp(key, pick)
                if traced and (pick.threads != proposal.threads
                               or pick.variant != proposal.variant):
                    self._emit(FAM_STRATEGY, "s2_clamp", key, adapter.clock,
                               op_class=op.op_class,
                               from_threads=proposal.threads,
                               to_threads=pick.threads,
                               from_variant=proposal.variant,
                               to_variant=pick.variant)
                if pick.threads > free:
                    if traced:
                        self._emit(FAM_STRATEGY, "reject", key,
                                   adapter.clock, cause="clamp_overflow",
                                   op_class=op.op_class,
                                   threads=pick.threads, free=free)
                    continue
                cores = self._place(adapter, key, pick, avoid)
                if cores is None:
                    if traced:
                        self._emit(FAM_STRATEGY, "reject", key,
                                   adapter.clock, cause="no_placement",
                                   op_class=op.op_class,
                                   threads=pick.threads,
                                   avoid=sorted(avoid))
                    continue
                self.launch(adapter, key, pick, hyper=False, cores=cores)
                return True
        return False

    # ---- fallback ------------------------------------------------------
    def run_biggest(self, adapter: StrategyAdapter) -> bool:
        """Fallback: most time-consuming ready op at its frozen plan.

        When other ops are running, the clamped-to-idle-cores launch must
        still respect the throughput guard (with a little slack for
        contention): squeezing a big op into a few leftover cores makes it
        outlast everything and hurts throughput — better to wait.  With
        several groups (pool tenants), a later group's op may still fit
        when the most-owed group's biggest would outlast the running set —
        don't idle the cores over it.

        The fallback launches NEXT TO running ops, so it must honor the
        interference blacklist like every other launch path — this used to
        be the forked schedulers' silent gap: only ``try_corun`` and
        ``try_hyper`` checked compatibility, letting a blacklisted pair
        co-launch through the fallback."""
        free = self.free(adapter)
        if free <= 0:
            return False
        running = adapter.running
        if running and free < self.config.min_fallback_cores:
            return False
        running_classes = [r.op.op_class for r in running.values()]
        horizon = (remaining_horizon(running.values(), adapter.clock)
                   if running else float("inf"))
        traced = self.sink.enabled
        for group in adapter.ready_groups():
            cand = [k for k in group if self._compatible(
                adapter.op(k).op_class, running_classes)]
            if not cand:
                continue
            # biggest first; on a PLACEMENT failure (quadrant topology
            # only — flat placement cannot fail, so flat stays bit-for-bit
            # the single-candidate fallback) try the next-biggest op in
            # the SAME group instead of skipping the whole group.  A
            # horizon failure still skips to the next group: every smaller
            # op in this group outlasts the running set even harder at the
            # same clamped width, and a later group's op may still fit.
            order = sorted(
                cand,
                key=lambda k: -adapter.instance_plan(k).predicted_time)
            for key in order:
                plan = adapter.instance_plan(key)
                if plan.threads > free:
                    plan = OpPlan(free, plan.variant,
                                  adapter.predict(key, free, plan.variant))
                if plan.predicted_time > horizon * self.config.fallback_slack:
                    if traced:
                        self._emit(FAM_STRATEGY, "reject", key, adapter.clock,
                                   cause="fallback_outlasts_horizon",
                                   op_class=adapter.op(key).op_class,
                                   predicted=plan.predicted_time,
                                   horizon=horizon,
                                   slack=self.config.fallback_slack)
                    break
                avoid = self._placement_avoid(adapter.op(key).op_class,
                                              adapter)
                if avoid is None:
                    if traced:
                        self._emit(FAM_STRATEGY, "reject", key, adapter.clock,
                                   cause="no_feasible_quadrant",
                                   op_class=adapter.op(key).op_class)
                    continue
                cores = self._place(adapter, key, plan, avoid)
                if cores is None:
                    if traced:
                        self._emit(FAM_STRATEGY, "reject", key, adapter.clock,
                                   cause="no_placement",
                                   op_class=adapter.op(key).op_class,
                                   threads=plan.threads, avoid=sorted(avoid))
                    continue
                self.launch(adapter, key, plan, hyper=False, cores=cores,
                            path="fallback")
                return True
        return False

    # ---- Strategy 4 ----------------------------------------------------
    def try_hyper(self, adapter: StrategyAdapter) -> bool:
        """Free physical cores exhausted — run the smallest ready ops on
        the hyper-thread lane."""
        if not self.config.enable_s4:
            return False
        if self.free(adapter) > 0:
            return False
        running = adapter.running
        if sum(1 for r in running.values()
               if r.hyper) >= self.config.max_ht_corunners:
            return False
        running_classes = [r.op.op_class for r in running.values()]
        # smallest = shortest serial-execution time; ties resolve by group
        # order (fair share), then readiness order within the group
        keyed = [(adapter.serial_time(k), gi, i, k)
                 for gi, group in enumerate(adapter.ready_groups())
                 for i, k in enumerate(group)]
        for _, _, _, key in sorted(keyed, key=lambda t: t[:3]):
            op = adapter.op(key)
            # a hyper launch borrows busy cores machine-wide: every co-run
            # it joins is cross-quadrant, so the cross relation is hard
            if not self._compatible(op.op_class, running_classes,
                                    hyper=True):
                continue
            inst = adapter.instance_plan(key)
            threads = min(inst.threads, self.cores)
            if threads == inst.threads:
                plan = inst
            else:
                # clamped width => re-predict at the clamped width (same
                # rule as the run_biggest clamp); keeping the unclamped
                # width's predicted_time would mis-price the launch
                plan = OpPlan(threads, inst.variant,
                              adapter.predict(key, threads, inst.variant))
            self.launch(adapter, key, plan, hyper=True, path="s4_hyper")
            return True
        return False

    # ---- deadline-driven preemption ------------------------------------
    def _overdue_by_urgency(self, adapter: StrategyAdapter
                            ) -> list[NodeKey]:
        """Ready ops with non-positive deadline slack, most urgent first
        (earliest-deadline-first among tenants that are already late).
        The deadline path tries them ALL in order: one op being stuck
        (blacklisted against a running class, no viable victim) must not
        deny a less-urgent-but-claimable tenant its launch."""
        overdue: list[tuple[float, int, NodeKey]] = []
        for gi, group in enumerate(adapter.ready_groups()):
            for key in group:
                s = adapter.deadline_slack(key)
                if s is not None and s <= 0.0:
                    overdue.append((s, gi, key))
        overdue.sort(key=lambda t: t[:2])
        return [key for _, _, key in overdue]

    def try_preempt(self, adapter: StrategyAdapter) -> bool:
        """Deadline path, tried before normal S3 admission each drain
        iteration so an overdue op gets its PREFERRED width instead of
        being squeezed into whatever S3 happens to leave idle.

        If a ready op's tenant has run out of deadline slack, claim cores
        for it: (1) if a candidate fits the idle cores, launch it with the
        throughput guard waived (an op that outlasts the running set is a
        makespan concern; a blown SLO is worse); (2) otherwise cancel the
        running op with the largest remaining time and launch into the
        reclaimed cores.  Work-conserving: the victim returns to its ready
        frontier and the adapter's ``refund`` re-prices its partial run at
        the restart-waste factor.  Victims must predate this scheduling
        instant (an op relaunched at the same clock is never re-revoked, so
        one instant cannot ping-pong) and must be strictly less urgent than
        the waiter."""
        pol = self.config.preemption
        if not pol.enabled:
            return False
        for key in self._overdue_by_urgency(adapter):
            if self._try_claim(adapter, key):
                return True
        return False

    def _try_claim(self, adapter: StrategyAdapter, key: NodeKey) -> bool:
        """Claim cores for ONE overdue ready op (see ``try_preempt``)."""
        pol = self.config.preemption
        op = adapter.op(key)
        cands = adapter.candidates_for(key, self.config.candidates)
        if not cands:
            return False
        running = adapter.running
        free = self.free(adapter)
        floor = self.config.min_fallback_cores
        need = min(c.threads for c in cands)
        pred = min(c.predicted_time for c in cands if c.threads == need)
        # S3 off = serial execution: the deadline path must not introduce
        # co-running — it may only act on an idle machine or by REPLACING
        # the sole runner (one revoke), never by launching alongside it
        serial = not self.config.enable_s3
        if serial and running and (
                len(running) > 1 or next(iter(running.values())).hyper):
            return False
        must_preempt = serial and bool(running)
        # otherwise idle cores suffice when the preferred width fits OR a
        # squeezed launch loses at most ~2x width (bounded time penalty
        # beats the waste of revoking someone's partial work)
        traced = self.sink.enabled
        waiter_slack = adapter.deadline_slack(key)
        victim_keys: list[NodeKey] = []
        prefer: OpPlan | None = None       # multi-victim: seat this width
        price: MovePrice | None = None
        n_eligible = 0
        if must_preempt or (free < need
                            and free < max(floor, (need + 1) // 2)):
            # pick the victim(s) BEFORE revoking so a failed fit leaves
            # the running set untouched
            slack = waiter_slack
            eligible: list[tuple[NodeKey, ScheduledOp, int, float]] = []
            for idx, (vk, r) in enumerate(running.items()):
                if r.hyper or r.start >= adapter.clock:
                    continue
                vs = adapter.deadline_slack(vk)
                if vs is not None and (slack is None or vs <= slack):
                    continue               # never rob a tenant just as late
                remaining = r.finish - adapter.clock
                if remaining <= pred * pol.min_victim_advantage:
                    continue               # it finishes before the waiter
                eligible.append((vk, r, idx, remaining))
            n_eligible = len(eligible)
            victim_key = None
            if eligible:
                # largest remaining time; ties break on the scheduler-
                # meaningful key — fewest threads revoked (cheapest claim),
                # then the earliest-launched runner (stable launch order) —
                # never on the opaque NodeKey
                victim_key = max(
                    eligible,
                    key=lambda e: (e[3], -e[1].threads, -e[2]))[0]
                if (not must_preempt
                        and free + running[victim_key].threads < floor):
                    victim_key = None      # revoking gains too little
            if victim_key is not None:
                victim_keys = [victim_key]
            if pol.max_victims > 1 and not serial and eligible:
                mv = self._assemble_victim_set(adapter, key, eligible,
                                               free, victim_key)
                if mv is not None:
                    victim_keys, prefer, price = mv
            if not victim_keys and (must_preempt or free < floor):
                if traced:
                    self._emit(FAM_PREEMPTION, "no_victim", key,
                               adapter.clock, op_class=op.op_class,
                               waiter_slack=waiter_slack, free=free,
                               need=need, n_candidates=n_eligible)
                return False               # nothing useful to claim now
        rest = [r.op.op_class for vk, r in running.items()
                if vk not in victim_keys]
        if not self._compatible(op.op_class, rest):
            if traced:
                self._emit(FAM_PREEMPTION, "incompatible", key,
                           adapter.clock, op_class=op.op_class,
                           waiter_slack=waiter_slack)
            return False
        if victim_keys:
            for vk in victim_keys:
                revoked = adapter.revoke(vk)
                elapsed = adapter.clock - revoked.start
                if traced:
                    self._emit(FAM_PREEMPTION, "revoke", key, adapter.clock,
                               op_class=op.op_class,
                               waiter_slack=waiter_slack,
                               waiter_pred=pred, victim=vk,
                               victim_class=revoked.op.op_class,
                               victim_threads=revoked.threads,
                               victim_remaining=(revoked.finish
                                                 - adapter.clock),
                               victim_elapsed=elapsed,
                               n_candidates=n_eligible,
                               set_size=len(victim_keys))
                adapter.refund(vk, revoked, elapsed)
                adapter.observe(vk, revoked, OBS_REVOKE, elapsed)
            free = self.free(adapter)
            if traced and prefer is not None:
                self._emit(FAM_PREEMPTION, "multi_revoke", key,
                           adapter.clock, op_class=op.op_class,
                           waiter_slack=waiter_slack,
                           victims=list(victim_keys),
                           prefer_threads=prefer.threads,
                           gain=price.gain, waste=price.cost)
        elif traced:
            # the throughput guard is waived: the overdue op launches into
            # idle cores even though it may outlast the running set
            self._emit(FAM_PREEMPTION, "waive", key, adapter.clock,
                       op_class=op.op_class, waiter_slack=waiter_slack,
                       free=free, need=need)
        # multi-victim claims launch at the preferred width the set was
        # priced to seat; otherwise fewest-thread admissible candidate,
        # horizon deliberately waived; clamp to the claimed cores when the
        # preferred width is unreachable
        if prefer is not None:
            pick = prefer
        else:
            pick = pick_admissible(cands, free, float("inf"))
            if pick is None:
                pick = min(cands, key=lambda c: c.threads)
        pick = adapter.clamp(key, pick)
        if pick.threads > free:
            if traced:
                self._emit(FAM_PREEMPTION, "squeeze", key, adapter.clock,
                           op_class=op.op_class, from_threads=pick.threads,
                           to_threads=free, waiter_slack=waiter_slack)
            pick = OpPlan(free, pick.variant,
                          adapter.predict(key, free, pick.variant))
        # quadrant placement for the claimed launch: the cross-relation
        # avoid set is ADVISORY here — a blown SLO outranks re-observing a
        # cross-quadrant slowdown, and the victim is already revoked, so
        # when avoidance leaves too few cores the launch lands anyway
        avoid = self._placement_avoid(op.op_class, adapter) or frozenset()
        cores = self._place(adapter, key, pick, avoid)
        if cores is None:
            if traced and avoid:
                self._emit(FAM_PLACEMENT, "avoid_override", key,
                           adapter.clock, op_class=op.op_class,
                           avoid=sorted(avoid), width=pick.threads)
            cores = self._place(adapter, key, pick, frozenset())
        self.launch(adapter, key, pick, hyper=False, cores=cores,
                    path="deadline_claim")
        return True

    def _assemble_victim_set(
            self, adapter: StrategyAdapter, key: NodeKey,
            eligible: list[tuple[NodeKey, ScheduledOp, int, float]],
            free: int, single_key: NodeKey | None,
    ) -> tuple[list[NodeKey], OpPlan, MovePrice] | None:
        """Multi-victim preemption (``PreemptionPolicy.max_victims > 1``):
        a victim SET that seats the overdue op's preferred width when the
        single longest-remaining victim cannot.

        Victims are accumulated cheapest summed re-billed restart waste
        first, affinity-aware under quadrant topology (a victim whose
        cores sit in the waiter's preferred quadrant frees the cores the
        placement actually wants).  The set is adopted — atomically, no
        revoke happens on a failed price check — only when the priced SLO
        gain (predicted-time improvement at the preferred width, weighted
        by that width) STRICTLY exceeds the summed waste of the whole set
        (``repro_torch.core.planstore.claim_price``).  Returns ``(victims,
        preferred_plan, price)`` or ``None`` to fall back to the
        single-victim move."""
        pol = self.config.preemption
        spec = self.machine.spec
        inst = adapter.instance_plan(key)
        prefer_w = min(inst.threads, self.cores)
        achievable = free + (adapter.running[single_key].threads
                             if single_key is not None else 0)
        if achievable >= prefer_w:
            return None                    # the single move already seats it
        t_with = (inst.predicted_time if prefer_w == inst.threads
                  else adapter.predict(key, prefer_w, inst.variant))
        hint = (adapter.placement_hint(key)
                if self.config.topology == "quadrant" else None)

        def waste_of(r: ScheduledOp) -> float:
            return restart_cost(r.threads, adapter.clock - r.start,
                                spec.restart_waste)

        def affinity(r: ScheduledOp) -> int:
            if hint is None or not r.cores:
                return 1
            return 0 if any(spec.quadrant_of_core(c) == hint
                            for c in r.cores) else 1

        order = sorted(eligible,
                       key=lambda e: (affinity(e[1]), waste_of(e[1]), e[2]))
        chosen: list[NodeKey] = []
        width = free
        waste = 0.0
        for vk, r, _, _ in order:
            if len(chosen) >= pol.max_victims or width >= prefer_w:
                break
            chosen.append(vk)
            width += r.threads
            waste += waste_of(r)
        if width < prefer_w:
            return None                    # even the full set can't seat it
        # the no-multi-victim alternative: launch at the best width the
        # single move reaches, or (machine fully busy, no single victim
        # viable) wait out the shortest eligible runner first
        if achievable >= 1:
            t_without = adapter.predict(key, achievable, inst.variant)
        else:
            t_without = min(rem for *_, rem in eligible) + t_with
        price = claim_price(prefer_w, t_without, t_with, waste)
        if not price.worth_it:
            if self.sink.enabled:
                self._emit(FAM_PREEMPTION, "multi_too_costly", key,
                           adapter.clock, op_class=adapter.op(key).op_class,
                           victims=list(chosen), prefer_threads=prefer_w,
                           gain=price.gain, waste=price.cost)
            return None
        return chosen, OpPlan(prefer_w, inst.variant, t_with), price

    # ---- width migration ------------------------------------------------
    def try_migrate(self, adapter: StrategyAdapter) -> bool:
        """Relaunch one running op at a different width when that is
        priced strictly cheaper than letting it finish where it is
        (``PreemptionPolicy.migration``; see ``migration_price``).

        Two situations make this win: the op was SQUEEZED at claim time
        (deadline path clamped it to whatever was free) and cores have
        since freed up, or the PlanStore's corrected curve moved the op's
        best width under ``feedback="ewma"``.  The move reuses the
        preemption machinery — revoke, refund (the discarded partial run
        is re-billed at the restart-waste factor), observe — and then
        relaunches the SAME node immediately, so exactly-once completion
        holds by construction.  A relaunch starts at the current clock and
        runners started at this instant are never migrated, so one
        scheduling instant cannot ping-pong an op between widths."""
        pol = self.config.preemption
        if not (pol.enabled and pol.migration):
            return False
        clock = adapter.clock
        free = self.free(adapter)
        quadrant = self.config.topology == "quadrant"
        spec = self.machine.spec
        best = None      # (net, key, plan, cores, price)
        for key, r in adapter.running.items():
            if r.hyper or r.start >= clock:
                continue
            remaining = r.finish - clock
            elapsed = clock - r.start
            budget = free + r.threads
            others = [o for k2, o in adapter.running.items() if k2 != key]
            other_loads = [(o.threads, o.cores) for o in others]
            busy = frozenset(c for o in others for c in o.cores)
            for c in adapter.candidates_for(key, self.config.candidates):
                if c.threads > budget:
                    continue
                if c.threads == r.threads and c.variant == r.variant:
                    continue               # same config: nothing to migrate
                if adapter.clamp(key, c) != c:
                    continue               # S2 hysteresis vetoes the width
                cores: tuple[int, ...] = ()
                if quadrant:
                    placed = place(spec, c.threads, busy,
                                   cache_sharing=c.variant,
                                   prefer=adapter.placement_hint(key),
                                   avoid=frozenset())
                    if placed is None:
                        continue
                    cores = placed
                    share = self.machine.quadrant_bw_share(
                        cores, other_loads)
                else:
                    share = self.bw_share(c.threads,
                                          (o.threads for o in others))
                # price the move against the duration the relaunch will
                # ACTUALLY get (contention-aware, same formula launch()
                # applies after the revoke) — not the solo curve
                dur = self._duration(r.op, c, False, share)
                price = migration_price(remaining, dur, elapsed,
                                        spec.restart_waste)
                if not price.worth_it:
                    continue
                net = price.gain - price.cost
                if best is None or net > best[0]:
                    best = (net, key, c, cores, price)
        if best is None:
            return False
        _, key, plan, cores, price = best
        revoked = adapter.revoke(key)
        elapsed = clock - revoked.start
        if self.sink.enabled:
            self._emit(FAM_PREEMPTION, "migrate", key, clock,
                       op_class=revoked.op.op_class,
                       from_threads=revoked.threads,
                       to_threads=plan.threads,
                       from_variant=revoked.variant,
                       to_variant=plan.variant,
                       remaining=revoked.finish - clock,
                       elapsed=elapsed, gain=price.gain, cost=price.cost)
        adapter.refund(key, revoked, elapsed)
        adapter.observe(key, revoked, OBS_REVOKE, elapsed)
        adapter.migrated(key, revoked)
        self.launch(adapter, key, plan, hyper=False, cores=cores,
                    path="migrate")
        return True

    # ---- the launch fixpoint loop --------------------------------------
    def drain(self, adapter: StrategyAdapter) -> None:
        """Launch everything launchable at this scheduling instant.

        S3 on: co-run admission with the run-biggest fallback.  S3 off:
        serial execution with per-op tuned concurrency only (Strategies
        1-2, the paper's Fig 3.a configuration).  The deadline path
        (``try_preempt``) runs first each iteration — an overdue op
        belongs on real cores at its preferred width, not squeezed into
        S3 leftovers or the 0.55-efficiency HT lane.  S4 tops up the
        hyper-thread lane either way."""
        launched = True
        while launched:
            # deadline path first: an overdue op must get its preferred
            # width now (preempting if the cores are taken), not be
            # squeezed into whatever S3 happens to leave idle
            launched = self.try_preempt(adapter)
            if launched:
                continue
            if self.config.enable_s3:
                if adapter.running:
                    launched = self.try_corun(adapter)
                    if not launched:
                        # paper fallback: no candidate fits without
                        # decreasing throughput -> run the most
                        # time-consuming ready op in the idle cores
                        launched = self.run_biggest(adapter)
                else:
                    launched = self.run_biggest(adapter)
            elif not adapter.running:
                launched = self.run_biggest(adapter)
            if not launched:
                # width migration before the HT lane: re-seating a running
                # op on real cores beats topping up the 0.55-efficiency
                # hyper-thread lane (a no-op unless the policy arms it)
                launched = self.try_migrate(adapter)
            if not launched:
                launched = self.try_hyper(adapter)
