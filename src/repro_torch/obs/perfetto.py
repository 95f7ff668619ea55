"""Chrome-trace / Perfetto export of a scheduled timeline + decision trace.

Emits the Trace Event Format JSON that ui.perfetto.dev (and
chrome://tracing) loads directly: ``{"traceEvents": [...]}`` where every
event carries ``ph`` (phase), ``ts`` (microseconds), ``pid``/``tid``.
The export lays the run out as four synthetic processes:

* **pid 1 "cores"** — one lane per physical core under
  ``topology="quadrant"`` (an op slice appears on every core it booked);
  flat-topology and hyper-lane launches, which book no concrete cores,
  get greedy virtual lanes (``tid`` 1000+ / 2000+) so overlap is still
  visible;
* **pid 2 "jobs"** — one track per tenant: its op slices, revoked
  partials (``preempted:`` prefix), and the revoke→relaunch **flow
  arrows** (``ph`` s/f) that make a preemption's cost visually traceable;
* **pid 3 "counters"** — ``co_running`` (the paper's Fig-4 signal),
  ``queue_depth`` from admission events, and ``bw_share_demand`` (sum of
  modeled bandwidth shares of everything running) from launch events;
* **pid 4 "decisions"** — one thread per event family, every decision as
  an instant (``ph`` "i") with its cause/inputs in ``args``.

Everything is duck-typed over ``ScheduleResult``/``PoolResult`` — the
obs layer never imports the schedulers it observes.
"""

from __future__ import annotations

import json
from typing import Iterable, Mapping

from repro_torch.obs.trace import FAMILIES, TraceEvent

US = 1e6                       # seconds -> Trace Event Format microseconds

CORES_PID = 1
JOBS_PID = 2
COUNTERS_PID = 3
DECISIONS_PID = 4
# cluster export: one process per machine, pid = MACHINE_PID_BASE + index
# (well above the four single-machine pids so both exports can coexist in
# one viewer session without colliding)
MACHINE_PID_BASE = 100

# virtual-lane tid bases on the cores process for launches with no booked
# core set (flat topology / hyper-thread lane)
FLAT_LANE_BASE = 1000
HYPER_LANE_BASE = 2000


def _jsonable(v):
    """Trace args must be plain JSON; decision-event payloads carry
    tuples, frozensets, and tuple keys."""
    if isinstance(v, Mapping):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set, frozenset)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


def _meta(pid: int, name: str, tid: int | None = None,
          tname: str | None = None) -> list[dict]:
    out = [{"ph": "M", "pid": pid, "name": "process_name",
            "args": {"name": name}}]
    if tid is not None:
        out.append({"ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_name", "args": {"name": tname}})
    return out


def _slice(name: str, ts: float, dur: float, pid: int, tid: int,
           args: dict, cat: str = "op") -> dict:
    return {"ph": "X", "name": name, "cat": cat, "ts": ts * US,
            "dur": max(dur, 0.0) * US, "pid": pid, "tid": tid,
            "args": _jsonable(args)}


def _greedy_lanes(records) -> dict[int, int]:
    """Assign overlap-free virtual lanes: record index -> lane index."""
    lanes: list[float] = []          # per-lane last finish time
    out: dict[int, int] = {}
    order = sorted(range(len(records)), key=lambda i: records[i].start)
    for i in order:
        r = records[i]
        for li, busy_until in enumerate(lanes):
            if busy_until <= r.start + 1e-12:
                lanes[li] = r.finish
                out[i] = li
                break
        else:
            out[i] = len(lanes)
            lanes.append(r.finish)
    return out


def _op_args(r) -> dict:
    return {"op_class": r.op.op_class, "uid": r.op.uid,
            "threads": r.threads, "variant": r.variant, "hyper": r.hyper,
            "predicted": r.predicted, "duration": r.duration,
            "cores": list(r.cores)}


def _core_lane_events(jobs_records: dict, trace: list[dict]) -> None:
    """Cores process: booked ops on their core tids, unbooked ops on
    greedy virtual lanes (flat launches vs hyper lane kept separate)."""
    used_cores: set[int] = set()
    flat, hyper = [], []
    for label, recs in jobs_records.items():
        for r in recs:
            if r.cores:
                used_cores.update(r.cores)
                for c in r.cores:
                    trace.append(_slice(f"{label}:{r.op.op_class}",
                                        r.start, r.duration, CORES_PID, c,
                                        _op_args(r)))
            elif r.hyper:
                hyper.append((label, r))
            else:
                flat.append((label, r))
    for base, group, cat in ((FLAT_LANE_BASE, flat, "op"),
                             (HYPER_LANE_BASE, hyper, "hyper")):
        lanes = _greedy_lanes([r for _, r in group])
        for i, (label, r) in enumerate(group):
            trace.append(_slice(f"{label}:{r.op.op_class}", r.start,
                                r.duration, CORES_PID, base + lanes[i],
                                _op_args(r), cat=cat))
    for c in sorted(used_cores):
        trace.extend(_meta(CORES_PID, "cores", c, f"core {c}")[1:])


def _flow_pair(fid: int, ts_from: float, ts_to: float, tid: int,
               name: str, pid: int = JOBS_PID,
               cat: str = "preempt") -> list[dict]:
    return [{"ph": "s", "id": fid, "name": name, "cat": cat,
             "ts": ts_from * US, "pid": pid, "tid": tid},
            {"ph": "f", "bp": "e", "id": fid, "name": name,
             "cat": cat, "ts": ts_to * US, "pid": pid,
             "tid": tid}]


def _counter(name: str, ts: float, value: float, series: str) -> dict:
    return {"ph": "C", "name": name, "ts": ts * US, "pid": COUNTERS_PID,
            "tid": 0, "args": {series: value}}


def _decision_events(events: Iterable[TraceEvent], trace: list[dict]) -> None:
    fam_tid = {fam: i for i, fam in enumerate(FAMILIES)}
    queue_depth_seen = False
    share_points: list[tuple[float, float, float]] = []  # start, finish, share
    for e in events:
        trace.append({"ph": "i", "s": "t", "name": f"{e.family}:{e.kind}",
                      "cat": e.family, "ts": e.ts * US,
                      "pid": DECISIONS_PID, "tid": fam_tid[e.family],
                      "args": _jsonable({"key": e.key, **e.data})})
        if e.family == "admission" and "queue_depth" in e.data:
            queue_depth_seen = True
            trace.append(_counter("queue_depth", e.ts,
                                  e.data["queue_depth"], "waiting"))
        if (e.family == "strategy" and "bw_share" in e.data
                and "finish" in e.data):
            share_points.append((e.ts, e.data["finish"], e.data["bw_share"]))
    # bw_share_demand: total modeled bandwidth share in force over time
    if share_points:
        deltas: dict[float, float] = {}
        for start, finish, share in share_points:
            deltas[start] = deltas.get(start, 0.0) + share
            deltas[finish] = deltas.get(finish, 0.0) - share
        total = 0.0
        for ts in sorted(deltas):
            total += deltas[ts]
            trace.append(_counter("bw_share_demand", ts,
                                  round(total, 9), "share"))
    for fam, tid in fam_tid.items():
        trace.extend(_meta(DECISIONS_PID, "decisions", tid, fam)[1:])
    if queue_depth_seen or share_points:
        trace.extend(_meta(COUNTERS_PID, "counters"))


def pool_trace(result, events: Iterable[TraceEvent] = ()) -> dict:
    """Trace Event Format dict for one pool run (+ its decision events).

    ``result`` is duck-typed over ``PoolResult``: ``jobs``, ``records``
    (jid -> launches), ``preempted`` (jid -> revoked partials), and
    ``events`` (the (time, #co-running) signal)."""
    trace: list[dict] = []
    events = list(events)
    # width migrations revoke + relaunch at one instant; the decision
    # event marks which revoke→relaunch arrows are migrations so the flow
    # name distinguishes a priced re-seat from an SLO preemption
    migrates = {(e.key, e.ts) for e in events
                if e.family == "preemption" and e.kind == "migrate"}
    names = {j.jid: f"j{j.jid}:{j.name}" for j in result.jobs}
    trace.extend(_meta(CORES_PID, "cores"))
    trace.extend(_meta(JOBS_PID, "jobs"))
    trace.extend(_meta(DECISIONS_PID, "decisions"))
    labeled = {names[jid]: recs for jid, recs in result.records.items()}
    _core_lane_events(labeled, trace)
    flow_id = 0
    for jid, recs in result.records.items():
        tid = jid
        trace.extend(_meta(JOBS_PID, "jobs", tid, names[jid])[1:])
        for r in recs:
            trace.append(_slice(r.op.op_class, r.start, r.duration,
                                JOBS_PID, tid, _op_args(r)))
        for p in result.preempted.get(jid, []):
            trace.append(_slice(f"preempted:{p.op.op_class}", p.start,
                                p.duration, JOBS_PID, tid, _op_args(p),
                                cat="preempted"))
            # flow arrow revoke -> relaunch: the next launch of the same
            # node at or after the revoke instant (work-conserving restart)
            relaunch = min(
                (r for r in recs
                 if r.op.uid == p.op.uid and r.start >= p.finish - 1e-12),
                key=lambda r: r.start, default=None)
            if relaunch is not None:
                flow_id += 1
                name = ("migrate→relaunch"
                        if ((jid, p.op.uid), p.finish) in migrates
                        else "revoke→relaunch")
                trace.extend(_flow_pair(flow_id, p.finish, relaunch.start,
                                        tid, name))
    for ts, n in result.events:
        trace.append(_counter("co_running", ts, float(n), "ops"))
    if result.events:
        trace.extend(_meta(COUNTERS_PID, "counters"))
    _decision_events(events, trace)
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def cluster_trace(result, events: Iterable[TraceEvent] = ()) -> dict:
    """Trace Event Format dict for one cluster run (+ decision events).

    ``result`` is duck-typed over ``repro_torch.cluster.ClusterResult``: it
    carries ``machines`` (one ``PoolResult``-shaped object per machine).
    Each machine becomes its own process (pid ``MACHINE_PID_BASE + m``)
    holding one track per tenant routed there, so the per-machine load
    balance is visible at a glance; ``cluster``-family ``route`` events
    draw a **route→launch flow arrow** from the routing instant to the
    job's first launch on its assigned machine, making a queued-behind
    routing decision visually traceable the same way preemption cost is
    on the single-machine export."""
    machines = getattr(result, "machines", result)
    events = list(events)
    trace: list[dict] = []
    first_launch: dict[int, tuple[int, float]] = {}  # jid -> (pid, start)
    for m, res in enumerate(machines):
        pid = MACHINE_PID_BASE + m
        trace.extend(_meta(pid, f"machine {m}"))
        names = {j.jid: f"j{j.jid}:{j.name}" for j in res.jobs}
        for jid, recs in res.records.items():
            trace.extend(_meta(pid, f"machine {m}", jid, names[jid])[1:])
            for r in recs:
                trace.append(_slice(r.op.op_class, r.start, r.duration,
                                    pid, jid, _op_args(r)))
            if recs:
                start = min(r.start for r in recs)
                if jid not in first_launch or start < first_launch[jid][1]:
                    first_launch[jid] = (pid, start)
            for p in res.preempted.get(jid, []):
                trace.append(_slice(f"preempted:{p.op.op_class}", p.start,
                                    p.duration, pid, jid, _op_args(p),
                                    cat="preempted"))
        for ts, n in res.events:
            trace.append(_counter(f"co_running.m{m}", ts, float(n), "ops"))
    if any(res.events for res in machines):
        trace.extend(_meta(COUNTERS_PID, "counters"))
    flow_id = 10_000   # clear of pool_trace's revoke-arrow id range
    for e in events:
        if e.family != "cluster" or e.kind != "route":
            continue
        landed = first_launch.get(e.key)
        if landed is None:
            continue
        pid, start = landed
        if start >= e.ts - 1e-12:
            flow_id += 1
            trace.extend(_flow_pair(flow_id, e.ts, start, e.key,
                                    "route→launch", pid=pid, cat="cluster"))
    trace.extend(_meta(DECISIONS_PID, "decisions"))
    _decision_events(events, trace)
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def write_trace(path, trace: dict) -> None:
    with open(path, "w") as f:
        json.dump(trace, f)


def export_pool_trace(result, path,
                      events: Iterable[TraceEvent] = ()) -> dict:
    """Build and write a pool run's Perfetto trace; returns the dict."""
    trace = pool_trace(result, events)
    write_trace(path, trace)
    return trace


def export_cluster_trace(result, path,
                         events: Iterable[TraceEvent] = ()) -> dict:
    """Build and write a cluster run's Perfetto trace; returns the dict."""
    trace = cluster_trace(result, events)
    write_trace(path, trace)
    return trace
