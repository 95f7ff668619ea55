"""Multi-tenant pool launcher: ``python -m repro_torch.launch.pool ...``

Builds a tenant mix of paper step graphs (and optionally serving waves),
runs it through the ``RuntimePool`` co-scheduler and through the serial
one-graph-at-a-time baseline, and reports aggregate throughput, per-job
latency, fairness, and plan-cache amortization as JSON.

Deadline/SLO knobs: ``--deadlines`` gives each job an absolute deadline
(submit time + per-job budget) and ``--preempt`` arms checkpoint-free
op preemption, so a tenant that runs out of slack can revoke the
longest-remaining running op (see ``repro_torch.core.strategy.PreemptionPolicy``).
The preemption-economics knobs (``--max-victims``, ``--evict-admitted``,
``--migrate``) arm the priced moves on top of that — multi-victim revoke,
free admission-level eviction, and width migration; each implies
``--preempt``.

Closed-loop knobs: ``--feedback ewma`` arms the adaptive plan store
(observed service EWMA-corrects every prediction — candidate ranking,
admission demand, deadline slack; see ``repro_torch.core.planstore``), and
``--plan-cache-path`` persists the cross-job curve cache across launcher
invocations (loaded before the run if the file exists, dumped after), so
profiling probes paid today are still amortized tomorrow.

Observability knobs: ``--trace-out trace.json`` records every scheduling
decision (see ``repro_torch.obs.trace``) and writes the run as a Chrome-trace/
Perfetto JSON timeline — open it at https://ui.perfetto.dev;
``--log-level`` configures the shared ``repro_torch`` logger.

Dynamic control flow: ``--dynamic`` switches the tenant mix to dynamic
graphs — ``--jobs`` entries become ``rnn`` (data-dependent while loop,
``repro_torch.core.graph.build_recurrent_step_graph``) and ``wave``
(early-exit serving pipeline, ``build_early_exit_wave``) instead of
paper models.  Region expansion and resolution instants land in the
decision-event stream, so ``--dynamic --trace-out trace.json`` shows
every loop iteration materializing on the Perfetto timeline.
``--trip-count-feedback`` arms the pool-wide EWMA trip-count estimator
(implies ``--feedback ewma``): unresolved loops are priced at learned
trip counts instead of their build-time priors.
"""

from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.core import SimMachine
from repro_torch.multitenant import (PlanCache, PoolConfig, PreemptionPolicy,
                               RuntimePool)
from repro_torch.obs import (RecordingSink, configure_logging, export_pool_trace,
                       get_logger)
from repro_torch.service.spec import DYNAMIC_WORKLOADS, JobSpec, submit_spec

logger = get_logger(__name__)


def mix_specs(models: list[str], prios: list[float],
              budgets: list[float | None], *, arrival_gap: float = 0.0,
              dynamic: bool = False, scale: int = 1) -> list[JobSpec]:
    """The tenant mix as ``JobSpec``s — this launcher is a thin parser
    over the wire schema (the daemon inbox and ``ServeEngine`` consume
    the same schema).  Dynamic-mix trips/depths vary with the job index
    so a ``--trip-count-feedback`` run has a distribution to learn."""
    specs = []
    for i, (model, prio, budget) in enumerate(zip(models, prios, budgets)):
        common = dict(name=f"{model}-{i}", priority=prio,
                      submit_time=i * arrival_gap, latency_budget=budget)
        if not dynamic:
            specs.append(JobSpec(workload=model, scale=scale, **common))
        elif model == "rnn":
            specs.append(JobSpec(workload="rnn", trips=4 + (i % 3),
                                 max_trips=8, **common))
        elif model == "wave":
            specs.append(JobSpec(workload="wave", depth=1 + (i % 3),
                                 max_depth=6, accept=(i % 2 == 0),
                                 **common))
        else:
            raise SystemExit(
                f"--dynamic jobs must be {'|'.join(DYNAMIC_WORKLOADS)}, "
                f"got {model!r}")
    return specs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", default=None,
                    help="comma-separated paper models, one job each "
                         "(with --dynamic: rnn|wave entries instead; "
                         "default resnet50,dcgan,resnet50,dcgan or "
                         "rnn,wave,rnn,wave)")
    ap.add_argument("--priorities", default=None,
                    help="comma-separated weights (default: all 1.0)")
    ap.add_argument("--max-active", type=int, default=3)
    ap.add_argument("--arrival-gap", type=float, default=0.0,
                    help="seconds between successive job arrivals")
    ap.add_argument("--deadlines", default=None,
                    help="comma-separated per-job latency budgets in "
                         "seconds (deadline = submit time + budget; empty "
                         "entry = best-effort job)")
    ap.add_argument("--preempt", action="store_true",
                    help="enable deadline-driven checkpoint-free "
                         "preemption (off: no launch is ever revoked; "
                         "note --deadlines alone already reorders "
                         "admission/fair-share — only a run with neither "
                         "flag is bit-for-bit the PR-2 pool)")
    ap.add_argument("--max-victims", type=int, default=1,
                    help="preemption economics: >1 lets the deadline path "
                         "revoke a SET of runners (cheapest summed restart "
                         "waste first, affinity-aware) when one victim "
                         "cannot seat the overdue op's preferred width — "
                         "only when the priced SLO gain exceeds the "
                         "summed waste (implies --preempt)")
    ap.add_argument("--evict-admitted", action="store_true",
                    help="preemption economics: return an admitted job "
                         "with no launched ops to the queue when that "
                         "unblocks an overdue deadlined waiter — the free "
                         "move, zero restart waste (implies --preempt)")
    ap.add_argument("--migrate", action="store_true",
                    help="preemption economics: relaunch a running op at "
                         "a different width when predicted-remaining-time "
                         "gain strictly exceeds the re-billed restart "
                         "waste (implies --preempt)")
    ap.add_argument("--reservation-window", type=float, default=0.0,
                    help="hold the last active slot for a higher-priority "
                         "deadlined arrival due within this many seconds")
    ap.add_argument("--topology", choices=("flat", "quadrant"),
                    default="flat",
                    help="thread placement: 'flat' is the paper's 68-core "
                         "pool; 'quadrant' books concrete core sets "
                         "(empty quadrant first, quadrant-local packing, "
                         "bounded spill) with per-quadrant bandwidth "
                         "contention and tenant-to-quadrant affinity")
    ap.add_argument("--dynamic", action="store_true",
                    help="tenant mix of DYNAMIC graphs (data-dependent "
                         "while loops + early-exit branches): --jobs "
                         "entries become rnn|wave; region expansion and "
                         "resolution instants appear in --trace-out "
                         "timelines as decision events")
    ap.add_argument("--trip-count-feedback", action="store_true",
                    help="arm the pool-wide EWMA trip-count estimator "
                         "(implies --feedback ewma): unresolved regions "
                         "are priced at learned trip counts instead of "
                         "build-time priors")
    ap.add_argument("--feedback", choices=("off", "ewma"), default="off",
                    help="closed-loop plan store: 'off' freezes every "
                         "prediction at profiling time (bit-for-bit the "
                         "pre-feedback pool); 'ewma' blends observed "
                         "service back into predictions, re-estimating "
                         "demand and deadline slack online")
    ap.add_argument("--plan-cache-path", default=None,
                    help="JSON file to persist the cross-job plan cache "
                         "across invocations: loaded before the run when "
                         "it exists (corrupted/mismatched files degrade "
                         "to an empty cache with a warning), dumped "
                         "after the run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=int, default=1,
                    help="layer-count multiplier for every job graph")
    ap.add_argument("--check-parity", action="store_true",
                    help="preflight: verify a single-job pool reproduces "
                         "the single-graph scheduler bit-for-bit on this "
                         "tenant mix's models (fails fast on divergence)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record every scheduling decision and write the "
                         "run as Chrome-trace/Perfetto JSON (open at "
                         "https://ui.perfetto.dev); tracing never changes "
                         "the schedule — the traced timeline is "
                         "bit-for-bit the untraced one")
    ap.add_argument("--log-level", default="warning",
                    choices=("debug", "info", "warning", "error"),
                    help="level for the shared 'repro' logger")
    args = ap.parse_args()
    configure_logging(args.log_level)
    if args.trip_count_feedback:
        args.feedback = "ewma"

    jobs = args.jobs or ("rnn,wave,rnn,wave" if args.dynamic
                         else "resnet50,dcgan,resnet50,dcgan")
    models = [m.strip() for m in jobs.split(",") if m.strip()]
    if not models:
        raise SystemExit("--jobs must name at least one model")
    prios = ([float(p) for p in args.priorities.split(",")]
             if args.priorities else [1.0] * len(models))
    if len(prios) != len(models):
        raise SystemExit("--priorities length must match --jobs")
    budgets: list[float | None] = [None] * len(models)
    if args.deadlines:
        entries = args.deadlines.split(",")
        if len(entries) != len(models):
            raise SystemExit("--deadlines length must match --jobs")
        budgets = [float(e) if e.strip() else None for e in entries]

    parity = None
    if args.check_parity:
        if args.dynamic:
            # check_parity covers the dynamic machinery via its
            # zero-region legs on the paper zoo; a mix of genuinely
            # dynamic graphs has no single-graph golden to diff against
            raise SystemExit("--check-parity runs on the paper-model "
                             "mix; drop --dynamic for the preflight")
        from repro_torch.multitenant import check_parity
        report = check_parity(models, seed=args.seed, scale=args.scale)
        if not report["ok"]:
            for model, rec in report["models"].items():
                for d in rec["divergences"][:10]:
                    logger.error("parity divergence [%s]: %s", model, d)
            raise SystemExit("pool-vs-corun parity check FAILED")
        parity = {m: rec["ok"] for m, rec in report["models"].items()}

    cache_path = (pathlib.Path(args.plan_cache_path)
                  if args.plan_cache_path else None)
    plan_cache = (PlanCache.load(cache_path)
                  if cache_path is not None and cache_path.exists()
                  else PlanCache())
    sink = RecordingSink() if args.trace_out else None
    pool = RuntimePool(
        machine=SimMachine(seed=args.seed),
        plan_cache=plan_cache,
        config=PoolConfig(
            max_active=args.max_active,
            reservation_window=args.reservation_window,
            topology=(args.topology if args.topology != "flat" else None),
            feedback=(args.feedback if args.feedback != "off" else None),
            sink=sink,
            preemption=(PreemptionPolicy(
                enabled=True,
                max_victims=max(1, args.max_victims),
                evict_admitted=args.evict_admitted,
                migration=args.migrate)
                if (args.preempt or args.max_victims > 1
                    or args.evict_admitted or args.migrate) else None)))
    for spec in mix_specs(models, prios, budgets,
                          arrival_gap=args.arrival_gap,
                          dynamic=args.dynamic, scale=args.scale):
        submit_spec(pool, spec)
    res = pool.run()
    serial = pool.run_serial()
    if cache_path is not None:
        plan_cache.dump(cache_path)
    if sink is not None:
        trace = export_pool_trace(res, args.trace_out, sink.events)
        logger.info("wrote %d trace events (%d decision events) to %s",
                    len(trace["traceEvents"]), len(sink.events),
                    args.trace_out)

    print(json.dumps({
        "jobs": [{
            "name": j.name,
            "priority": j.priority,
            "queue_wait_s": j.queue_wait,
            "latency_s": j.latency,
            "run_latency_s": j.run_latency,
            "serial_latency_s": serial.job_latencies[j.jid],
            "service_core_s": j.service,
            # the demand the admission tier priced the job at; under
            # --feedback ewma the live Job.demand is REMAINING demand
            # (0 once finished), which is not what this field reports
            "demand_core_s": (j.admitted_demand
                              if j.admitted_demand is not None
                              else j.demand),
            "preemptions": j.preemptions,      # launches revoked FROM j
            "evictions": j.evictions,          # admission-level bounces
            "migrations": j.migrations,        # priced width re-seats
            **({"deadline_s": j.deadline,
                "deadline_met": (j.latency is not None
                                 and j.finish_time <= j.deadline)}
               if j.deadline is not None else {}),
        } for j in res.jobs],
        "topology": args.topology,
        "pool_makespan_s": res.makespan,
        "serial_makespan_s": serial.makespan,
        "aggregate_speedup": serial.makespan / res.makespan,
        "pool_throughput_ops_s": res.aggregate_throughput,
        "serial_throughput_ops_s": serial.aggregate_throughput,
        "fairness_jain": res.fairness,
        # e2e divides submit-to-finish by the solo makespan (charges the
        # scheduler for admission queueing); sched divides admit-to-finish
        # (isolates the core scheduler from pure queue wait)
        "slowdown_fairness_e2e_jain": res.slowdown_fairness(
            serial.job_makespans),
        "slowdown_fairness_sched_jain": res.slowdown_fairness(
            serial.job_makespans, include_queue_wait=False),
        "preemptions": res.n_preemptions,
        "evictions": res.n_evictions,
        "migrations": res.n_migrations,
        **({"region_expands": res.n_region_expands,
            "region_resolves": res.n_region_resolves}
           if args.dynamic else {}),
        **({"trip_counts": {str(k): v for k, v
                            in sorted(pool.trip_counts.values.items(),
                                      key=str)},
            "trip_count_stats": pool.trip_counts.stats()}
           if args.trip_count_feedback and pool.trip_counts is not None
           else {}),
        "feedback": args.feedback,
        **({"feedback_stats": res.feedback_stats}
           if res.feedback_stats is not None else {}),
        "plan_cache": res.cache_stats,
        **({"plan_cache_path": str(cache_path)}
           if cache_path is not None else {}),
        "serial_profiling_probes": serial.profiling_probes,
        **({"parity_check": parity} if parity is not None else {}),
        **({"trace_out": args.trace_out,
            "trace_decision_events": len(sink.events)}
           if sink is not None else {}),
        "metrics": res.metrics,
    }, indent=1))


if __name__ == "__main__":
    main()
