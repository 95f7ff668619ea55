"""Cluster pool launcher: ``python -m repro_torch.launch.cluster ...``

Runs a tenant mix through the multi-machine ``ClusterPool`` —
demand-aware routing over N per-machine schedulers — and reports
placement, per-job latency, rebalances, and aggregate throughput as
JSON.  ``--compare`` reruns the same mix under round-robin routing and
on a single machine, so one invocation shows what demand-aware routing
and the extra machines each buy.

``--check-parity`` preflights the layering claim behind the whole
design: a 1-machine cluster must reproduce the single-machine pool
bit-for-bit (the ``cluster-1m`` leg of ``check_parity``).

``--trace-out`` writes the run as a Perfetto timeline with one process
lane per machine plus route->launch flow arrows (open at
https://ui.perfetto.dev).
"""

from __future__ import annotations

import argparse
import json

from repro_torch.cluster import ClusterPool, RouterConfig
from repro_torch.core import StrategyConfig
from repro_torch.hw import ClusterSpec
from repro_torch.multitenant import PlanCache, PoolConfig
from repro_torch.obs import RecordingSink, configure_logging, \
    export_cluster_trace, get_logger
from repro_torch.service.spec import submit_spec
from repro_torch.launch.pool import mix_specs

logger = get_logger(__name__)

DEFAULT_JOBS = ("resnet50,dcgan,resnet50,dcgan,"
                "resnet50,dcgan,resnet50,dcgan")


def run_mix(specs, *, n_machines: int, policy: str, rebalance: bool,
            split: bool, max_active: int, feedback: str | None,
            seed: int, sink=None) -> tuple:
    """One cluster run of the mix; returns (pool, result)."""
    strat = StrategyConfig(feedback=feedback or "off",
                           **({"sink": sink} if sink is not None else {}))
    pool = ClusterPool(
        ClusterSpec.homogeneous(n_machines),
        config=PoolConfig(max_active=max_active, strategy=strat),
        router=RouterConfig(policy=policy, rebalance=rebalance,
                            split=split),
        plan_cache=PlanCache(), seed=seed)
    for spec in specs:
        submit_spec(pool, spec)
    return pool, pool.run()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--machines", type=int, default=2,
                    help="number of (homogeneous KNL-like) machines")
    ap.add_argument("--jobs", default=DEFAULT_JOBS,
                    help="comma-separated paper models, one job each")
    ap.add_argument("--policy", choices=("demand", "round_robin"),
                    default="demand",
                    help="routing policy: 'demand' bin-packs by "
                         "planstore-re-estimated core-seconds against "
                         "per-machine free capacity; 'round_robin' is "
                         "the arrival-index baseline")
    ap.add_argument("--no-rebalance", action="store_true",
                    help="disable the cross-machine admission-level "
                         "eviction (deadline-critical waiters stay put)")
    ap.add_argument("--split", action="store_true",
                    help="arm MovePrice-gated cross-machine splits of "
                         "multi-component graphs (off by default, like "
                         "every priced move)")
    ap.add_argument("--max-active", type=int, default=3,
                    help="per-machine co-run admission cap")
    ap.add_argument("--arrival-gap", type=float, default=0.0)
    ap.add_argument("--deadlines", default=None,
                    help="comma-separated per-job latency budgets in "
                         "seconds (empty entry = best-effort)")
    ap.add_argument("--feedback", choices=("off", "ewma"), default="off")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--compare", action="store_true",
                    help="also run the round-robin and single-machine "
                         "baselines on the same mix and report ratios")
    ap.add_argument("--check-parity", action="store_true",
                    help="preflight: a 1-machine cluster must reproduce "
                         "the single-machine pool bit-for-bit on this "
                         "mix's models (the cluster-1m parity leg)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the run as Perfetto JSON: one process "
                         "lane per machine, route->launch flow arrows")
    ap.add_argument("--log-level", default="warning",
                    choices=("debug", "info", "warning", "error"))
    args = ap.parse_args()
    configure_logging(args.log_level)

    models = [m.strip() for m in args.jobs.split(",") if m.strip()]
    if not models:
        raise SystemExit("--jobs must name at least one model")
    if args.machines < 1:
        raise SystemExit("--machines must be >= 1")
    budgets: list[float | None] = [None] * len(models)
    if args.deadlines:
        entries = args.deadlines.split(",")
        if len(entries) != len(models):
            raise SystemExit("--deadlines length must match --jobs")
        budgets = [float(e) if e.strip() else None for e in entries]

    parity = None
    if args.check_parity:
        from repro_torch.multitenant import check_parity
        report = check_parity(models, seed=args.seed, scale=args.scale)
        if not report["ok"]:
            for model, rec in report["models"].items():
                for d in rec["divergences"][:10]:
                    logger.error("parity divergence [%s]: %s", model, d)
            raise SystemExit("cluster-1m parity check FAILED")
        parity = {m: rec["ok"] for m, rec in report["models"].items()}

    feedback = args.feedback if args.feedback != "off" else None
    specs = mix_specs(models, [1.0] * len(models), budgets,
                      arrival_gap=args.arrival_gap, scale=args.scale)
    sink = RecordingSink() if args.trace_out else None
    pool, res = run_mix(specs, n_machines=args.machines,
                        policy=args.policy,
                        rebalance=not args.no_rebalance, split=args.split,
                        max_active=args.max_active, feedback=feedback,
                        seed=args.seed, sink=sink)
    if sink is not None:
        trace = export_cluster_trace(res, args.trace_out, sink.events)
        logger.info("wrote %d trace events to %s",
                    len(trace["traceEvents"]), args.trace_out)

    report = {
        "machines": args.machines,
        "policy": args.policy,
        "jobs": [{
            "name": cj.name,
            "machine": cj.machine,
            "split": cj.split,
            "moves": cj.moves,
            "latency_s": cj.latency,
            **({"deadline_s": cj.deadline,
                "deadline_met": (cj.finish_time is not None
                                 and cj.finish_time <= cj.deadline)}
               if cj.deadline is not None else {}),
        } for cj in res.cluster_jobs],
        "machine_makespans_s": [r.makespan for r in res.machines],
        "machine_ops": [r.total_ops for r in res.machines],
        "cluster_makespan_s": res.makespan,
        "aggregate_throughput_ops_s": res.aggregate_throughput,
        "rebalances": res.n_rebalances,
        "splits": res.n_splits,
        "demand_index": res.demand_index_stats,
        **({"parity_check": parity} if parity is not None else {}),
        **({"trace_out": args.trace_out,
            "trace_decision_events": len(sink.events)}
           if sink is not None else {}),
        "metrics": res.metrics,
    }
    if args.compare:
        _, rr = run_mix(specs, n_machines=args.machines,
                        policy="round_robin",
                        rebalance=not args.no_rebalance,
                        split=args.split, max_active=args.max_active,
                        feedback=feedback, seed=args.seed)
        _, single = run_mix(specs, n_machines=1, policy=args.policy,
                            rebalance=False, split=False,
                            max_active=args.max_active,
                            feedback=feedback, seed=args.seed)
        report["round_robin_throughput_ops_s"] = rr.aggregate_throughput
        report["single_machine_throughput_ops_s"] = \
            single.aggregate_throughput
        report["throughput_vs_round_robin"] = (
            res.aggregate_throughput / rr.aggregate_throughput
            if rr.aggregate_throughput else None)
        report["throughput_vs_single_machine"] = (
            res.aggregate_throughput / single.aggregate_throughput
            if single.aggregate_throughput else None)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
