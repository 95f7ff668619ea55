"""Jobs and admission control for the multi-tenant runtime pool.

A *job* is one tenant's workload: an ``OpGraph`` (a training step, a
serving wave) plus — once admitted — the frozen ``ConcurrencyPlan`` the
paper's Strategies 1-2 produce for it.  ``JobQueue`` is the admission
controller: jobs wait in priority order and are admitted while the pool
has an active-job slot and the job's *predicted demand* (core-seconds,
the ``perfmodel`` cost currency) fits under the outstanding-demand cap.

Fair sharing uses the classic weighted virtual-time rule: each job
accrues ``service`` (core-seconds actually granted) and the scheduler
always prefers the job with the smallest ``service / priority``.  Charging
service at launch time (not completion) makes the share responsive within
a single scheduling instant.

Deadlines (SLOs) ride on top of the static weights: a job may carry a
``deadline`` (absolute time its owner wants it finished by), which makes
its priority DYNAMIC — ``effective_priority`` scales the static weight up
as slack runs out — and makes the queue order earliest-deadline-first
within a priority level.  ``downstream_critical_path`` prices how much
predicted work still separates each node from the job's completion, which
is what turns a deadline into per-node slack the pool's preemption path
can act on (see ``repro_torch.core.strategy.PreemptionPolicy``).
"""

from __future__ import annotations

import bisect
import dataclasses
import itertools

from repro_torch.core.concurrency import ConcurrencyController, ConcurrencyPlan
from repro_torch.core.graph import OpGraph
from repro_torch.core.planstore import PlanStore, critical_path_from


@dataclasses.dataclass
class Job:
    """One admitted-or-waiting tenant workload."""

    jid: int
    name: str
    graph: OpGraph
    priority: float = 1.0             # weight in the fair-share rule
    submit_time: float = 0.0
    deadline: float | None = None     # absolute SLO target (None = best-effort)
    # filled at profiling/admission time
    plan: ConcurrencyPlan | None = None
    controller: ConcurrencyController | None = None
    # the job's closed-loop plan store (repro_torch.core.planstore): every
    # prediction the pool consumes for this job flows through it, and
    # under feedback="ewma" the pool's observations flow back — demand
    # and cp below are DERIVED from it and re-derived on completions
    store: PlanStore | None = None
    demand: float = 0.0               # predicted core-seconds (perfmodel);
    #                                   under feedback="ewma" this is the
    #                                   REMAINING corrected demand, updated
    #                                   as ops complete
    # uid -> predicted critical path from that node to job completion,
    # inclusive (filled at profiling time; prices deadline slack per node;
    # re-derived from observations under feedback="ewma")
    cp: dict[int, float] = dataclasses.field(default_factory=dict)
    # demand in force when the job was admitted (reporting: under
    # feedback="ewma" the live ``demand`` decays to 0 as ops complete,
    # so "what was this tenant priced at" needs its own field)
    admitted_demand: float | None = None
    # accounting, maintained by the pool
    admit_time: float | None = None
    finish_time: float | None = None
    service: float = 0.0              # core-seconds granted so far
    ops_done: int = 0
    preemptions: int = 0              # launches revoked from this job
    # admission-level evictions: times this job was returned to the queue
    # while admitted with no launched ops (the FREE preemption-economics
    # move — zero restart waste; see PreemptionPolicy.evict_admitted)
    evictions: int = 0
    # width migrations: launches of this job revoked and immediately
    # relaunched at a different width (PreemptionPolicy.migration);
    # counted separately from ``preemptions`` (which includes them at the
    # sim level) so reporting can tell an SLO revoke from a priced re-seat
    migrations: int = 0
    # the queue-order ticket assigned at FIRST submit and reused on every
    # readmit, so an evicted job re-enters under its ORIGINAL submit order
    queue_seq: int | None = None
    # quadrant of the job's most recent placed launch (topology="quadrant"
    # only) — the pool's tenant-to-quadrant affinity hint
    last_quadrant: int | None = None
    # set by RuntimePool.cancel: the job left the pool before finishing
    # (finish_time stays None — a cancelled job has no latency)
    cancelled: bool = False

    @property
    def done(self) -> bool:
        return self.finish_time is not None

    @property
    def latency(self) -> float | None:
        """Submit-to-finish (includes queueing) — the per-tenant SLO view.
        ``None`` until the job finishes (a rejected or still-queued tenant
        has no latency yet; callers reporting on unfinished jobs should
        use ``waiting_time(now)``)."""
        if self.finish_time is None:
            return None
        return self.finish_time - self.submit_time

    @property
    def run_latency(self) -> float | None:
        """Admit-to-finish — what the SCHEDULER did to the job, with the
        admission queue factored out.  ``None`` until finished."""
        if self.finish_time is None or self.admit_time is None:
            return None
        return self.finish_time - self.admit_time

    @property
    def queue_wait(self) -> float | None:
        """Submit-to-admit, or ``None`` for a never-admitted job (deadline
        rejection and reporting paths must not crash on those)."""
        if self.admit_time is None:
            return None
        return self.admit_time - self.submit_time

    def waiting_time(self, now: float) -> float:
        """Queue wait as of ``now``: submit-to-admit once admitted,
        submit-to-now while still waiting."""
        until = self.admit_time if self.admit_time is not None else now
        return max(0.0, until - self.submit_time)

    def slack(self, now: float) -> float | None:
        """Raw deadline slack (no remaining-work estimate): time left
        until the deadline, or ``None`` for best-effort jobs."""
        if self.deadline is None:
            return None
        return self.deadline - now

    def effective_priority(self, now: float) -> float:
        """Dynamic priority = f(deadline slack).

        Best-effort jobs keep their static weight.  A deadlined job's
        weight scales linearly from 1x at submit to 2x at (and past) the
        deadline, so a tenant running out of slack is progressively
        preferred by the fair-share order without ever dominating a
        static-priority tier above it."""
        if self.deadline is None:
            return self.priority
        budget = max(self.deadline - self.submit_time, 1e-12)
        frac = (self.deadline - now) / budget       # 1 at submit, 0 at SLO
        return self.priority * (2.0 - min(max(frac, 0.0), 1.0))

    @property
    def virtual_time(self) -> float:
        """Weighted service — the fair-share ordering key (smaller = owed)."""
        return self.service / max(self.priority, 1e-9)

    def virtual_time_at(self, now: float) -> float:
        """Fair-share key under the dynamic (slack-scaled) priority.
        Identical to ``virtual_time`` for best-effort jobs, so schedulers
        that never set deadlines are bit-for-bit unchanged."""
        return self.service / max(self.effective_priority(now), 1e-9)


def downstream_critical_path(graph: OpGraph,
                             plan: ConcurrencyPlan) -> dict[int, float]:
    """uid -> predicted time from starting that node to finishing the job
    (the node's own frozen-plan prediction plus the longest consumer
    chain).  This is the remaining-work estimate that converts a job
    deadline into per-node slack: a ready node with
    ``deadline - now - cp[uid] <= 0`` cannot make its SLO even if granted
    cores immediately, which is the pool's preemption trigger.

    This is the FROZEN-plan view (the pre-feedback behavior, kept for
    callers without a store); the pool derives ``Job.cp`` through
    ``PlanStore.remaining_critical_path``, which additionally applies
    observation corrections and drops completed nodes under
    ``feedback="ewma"``."""
    pred = {uid: plan.per_instance[op.size_key].predicted_time
            for uid, op in graph.ops.items()}
    return critical_path_from(graph, pred)


class JobQueue:
    """Priority-ordered admission controller with a demand cap.

    ``max_active`` bounds concurrently admitted jobs (each admitted graph's
    ready frontier competes for cores — too many tenants and the Strategy-3
    horizon guard starts rejecting everything).  ``max_outstanding_demand``
    optionally bounds the summed predicted core-seconds of active jobs; a
    job whose demand would overflow the cap waits, but is never skipped in
    favor of a lower-priority job (no starvation by overtaking).  The cap
    is deliberately waived when the pool is idle: a job bigger than the
    cap must still run eventually, alone — otherwise it would deadlock
    the queue.

    Deadline awareness: within a priority level the queue is earliest-
    deadline-first (best-effort jobs sort after any deadlined peer), and a
    positive ``reservation_window`` holds the LAST active slot open for a
    strictly-higher-priority deadlined arrival due within the window, so
    an imminent SLO tenant doesn't find the pool freshly packed with
    best-effort work."""

    def __init__(self, max_active: int = 3,
                 max_outstanding_demand: float | None = None,
                 reservation_window: float = 0.0):
        self.max_active = max_active
        self.max_outstanding_demand = max_outstanding_demand
        self.reservation_window = reservation_window
        # kept sorted by (-priority, deadline, submit_time, seq): strict
        # priority, EDF within a level (no deadline = +inf, so best-effort
        # jobs keep FIFO among themselves), FIFO as the final tie-break
        # (seq is unique, so Jobs are never compared)
        self._waiting: list[tuple[float, float, float, int, Job]] = []
        self._seq = itertools.count()
        self.submitted: list[Job] = []

    def submit(self, job: Job) -> None:
        if job.queue_seq is None:
            job.queue_seq = next(self._seq)
        self._enqueue(job)
        self.submitted.append(job)

    def readmit(self, job: Job) -> None:
        """Return an EVICTED job to the queue (admission-level preemption,
        see ``PreemptionPolicy.evict_admitted``).  The job keeps its
        original ``submit_time`` and ``queue_seq``, so it re-enters under
        exactly its original submit order — eviction defers the tenant, it
        never demotes it.  Not appended to ``submitted`` again: it is the
        same submission, bounced back."""
        self._enqueue(job)

    def _enqueue(self, job: Job) -> None:
        deadline = job.deadline if job.deadline is not None else float("inf")
        bisect.insort(self._waiting,
                      (-job.priority, deadline, job.submit_time,
                       job.queue_seq, job))

    def remove(self, jid: int) -> bool:
        """Drop one WAITING job from the queue (job cancellation).
        Returns False when the jid is not waiting (already admitted,
        finished, or unknown) — the caller decides what that means."""
        for i, (*_, job) in enumerate(self._waiting):
            if job.jid == jid:
                del self._waiting[i]
                return True
        return False

    def __len__(self) -> int:
        return len(self._waiting)

    def peek(self) -> Job | None:
        return self._waiting[0][4] if self._waiting else None

    def waiting_jobs(self) -> list[Job]:
        """Snapshot of queued jobs in admission order (the pool's
        feedback path re-derives their demand/cp before admission checks
        so the cap prices tenants at TODAY's estimates)."""
        return [job for *_, job in self._waiting]

    def next_arrival(self, now: float) -> float | None:
        """Earliest submit_time strictly in the future, or None."""
        future = [j.submit_time for *_, j in self._waiting
                  if j.submit_time > now]
        return min(future) if future else None

    def next_admissible_arrival(self, active: list[Job],
                                now: float) -> float | None:
        """Earliest strictly-future arrival instant at which some waiting
        job would actually be admitted, or None.  The pool's wakeup time:
        the EARLIEST arrival may be inadmissible (demand cap, reservation)
        while a later one within the same op's runtime is not — that later
        arrival still deserves its scheduling instant."""
        future = sorted({j.submit_time for *_, j in self._waiting
                         if j.submit_time > now})
        for t in future:
            if self.admissible_at(active, t):
                return t
        return None

    def _admissible_index(self, active: list[Job],
                          now: float) -> tuple[int | None, str]:
        """``(index, cause)``: the waiting-list index of the job
        ``pop_admissible`` would hand out (cause ``"ok"``), or ``None``
        with WHY nothing is admissible — ``"empty"`` / ``"not_arrived"``
        (nothing to decide yet), ``"max_active"`` / ``"demand_cap"`` /
        ``"reserved"`` (an arrived tenant was actually blocked; these are
        the causes the admission trace reports).  One predicate for both
        popping and the pool's arrival-wakeup check, so a wakeup can
        never disagree with the admission it is waking up for."""
        if not self._waiting:
            return None, "empty"
        if len(active) >= self.max_active:
            return None, "max_active"
        for i, (*_, job) in enumerate(self._waiting):
            if job.submit_time > now:
                continue
            if self.max_outstanding_demand is not None and active:
                outstanding = sum(j.demand for j in active)
                if outstanding + job.demand > self.max_outstanding_demand:
                    return None, "demand_cap"
            if (self.reservation_window > 0.0
                    and len(active) == self.max_active - 1
                    and self._imminent_urgent_arrival(job, now)):
                return None, "reserved"
            return i, "ok"
        return None, "not_arrived"

    def block_cause(self, active: list[Job], now: float) -> str | None:
        """Why no waiting job is admissible right now (see
        ``_admissible_index`` for the vocabulary), or ``None`` when one
        IS admissible — the pool's admission decision trace reads this."""
        i, cause = self._admissible_index(active, now)
        return None if i is not None else cause

    def _imminent_urgent_arrival(self, job: Job, now: float) -> bool:
        """Is a strictly-higher-priority deadlined job due within the
        reservation window?  If so, the last slot is held for it."""
        horizon = now + self.reservation_window
        return any(h.priority > job.priority and h.deadline is not None
                   and now < h.submit_time <= horizon
                   for *_, h in self._waiting)

    def peek_admissible(self, active: list[Job],
                        now: float = float("inf")) -> Job | None:
        """The job ``pop_admissible`` WOULD hand out, without removing it
        — the eviction path's what-if probe: 'if the active set were
        ``active``, who would be admitted?'."""
        i, _ = self._admissible_index(active, now)
        return self._waiting[i][4] if i is not None else None

    def pop_admissible(self, active: list[Job],
                       now: float = float("inf")) -> Job | None:
        """Next job to admit given the currently active set, or None.

        Highest priority among jobs that have already arrived
        (``submit_time <= now``); within a priority level, earliest
        deadline first, then FIFO.  The demand cap never lets a lower-
        priority job overtake one that is merely too big — the big job
        waits, everything behind it waits too (strict priority, no
        starvation by overtaking)."""
        i, _ = self._admissible_index(active, now)
        if i is None:
            return None
        return self._waiting.pop(i)[4]

    def admissible_at(self, active: list[Job], t: float) -> bool:
        """Would ``pop_admissible(active, now=t)`` hand out a job?  The
        pool's arrival-wakeup predicate: waking the scheduling loop for an
        arrival that the demand cap (or a reservation) would bounce is a
        spurious scheduling instant."""
        return self._admissible_index(active, t)[0] is not None


def jain(values: list[float]) -> float:
    """Jain's fairness index: 1.0 = all equal, 1/n = one takes all.
    Empty or all-zero inputs count as perfectly fair (nothing competed)."""
    if not values:
        return 1.0
    s = sum(values)
    sq = sum(x * x for x in values)
    if sq == 0:
        return 1.0
    return (s * s) / (len(values) * sq)


def fairness_index(jobs: list[Job]) -> float:
    """Jain's fairness index over priority-normalized service.

    1.0 = every job got service exactly proportional to its priority;
    1/n = one job got everything.  Computed over jobs that were admitted.

    Caveat: in a run-to-completion pool, final service converges to each
    job's own demand whatever the scheduler did, so this index mostly
    reflects demand/priority skew of the MIX.  To judge the SCHEDULER,
    use ``PoolResult.slowdown_fairness`` (per-job latency relative to
    running alone), where a starved tenant shows up as a large slowdown."""
    return jain([j.service / max(j.priority, 1e-9)
                 for j in jobs if j.admit_time is not None])
