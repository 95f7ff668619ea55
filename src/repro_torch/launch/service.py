"""Service CLI: ``python -m repro_torch.launch.service <command> ...``

The client side of the pool daemon (``repro_torch.service.PoolDaemon``).  One
daemon owns one ``RuntimePool`` + worker set per ``--state-dir``; every
other command talks to it through the file inbox (one JSON command file
in ``<state_dir>/inbox/``, one JSON reply in ``<state_dir>/outbox/``).

Commands:

* ``start``  — run the daemon loop in the foreground (payloads on
  ``--device``, ``cuda`` by default; it raises without a card unless
  ``--device cpu`` is given).  ``--once`` exits
  after the first ``drain`` completes (submit-all-then-drain mode);
  ``--crash-after-steps N`` hard-kills the process after N decision
  instants (the recovery tests' kill switch).
* ``submit`` — submit one job, either from ``--spec '<json>'`` (the
  ``JobSpec`` wire dict) or from flags mirroring ``repro_torch.launch.pool``.
* ``cancel`` / ``status`` / ``drain`` / ``stop`` — the obvious verbs.
* ``smoke``  — self-contained CI choreography (no running daemon
  needed): enqueue submit/status/cancel/drain through the REAL file
  protocol, run a ``--once`` daemon over the inbox, and assert the
  drained metrics are bit-for-bit an equivalent direct
  ``RuntimePool.run``.  It builds the daemon's executor on ``--device``
  as ``start`` does.

Restart the daemon after a kill with the same ``--state-dir`` and it
recovers its world from the job store (see ``repro_torch.service.jobstore``).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import time

from repro_torch.core import SimMachine
from repro_torch.core.runtime import RuntimeConfig
from repro_torch.core.strategy import StrategyConfig
from repro_torch.multitenant.plancache import atomic_write_text
from repro_torch.multitenant.pool import PoolConfig, RuntimePool
from repro_torch.service import JobSpec, PoolDaemon, submit_spec


# ---------------------------------------------------------------------------
# file-protocol client
# ---------------------------------------------------------------------------

def enqueue_command(state_dir: str | pathlib.Path, cmd: dict,
                    seq: int | None = None) -> pathlib.Path:
    """Drop one command file into the daemon inbox (atomic write, so the
    daemon never reads a partial command); returns the reply path the
    daemon will write.  ``seq`` pins the processing order (the daemon
    reads in filename order) — defaults to a wall-clock ticket."""
    state_dir = pathlib.Path(state_dir)
    inbox = state_dir / "inbox"
    inbox.mkdir(parents=True, exist_ok=True)
    ticket = seq if seq is not None else time.time_ns()
    name = f"{ticket:020d}-{os.getpid()}-{cmd['op']}.json"
    atomic_write_text(inbox / name, json.dumps(cmd))
    return state_dir / "outbox" / name


def read_reply(reply_path: pathlib.Path, *, timeout: float = 30.0,
               poll: float = 0.05) -> dict:
    """Wait for (and consume) the daemon's reply file."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if reply_path.exists():
            reply = json.loads(reply_path.read_text())
            reply_path.unlink()
            return reply
        time.sleep(poll)
    raise SystemExit(f"no daemon reply at {reply_path} "
                     f"within {timeout:.0f}s — is the daemon running?")


def send_command(state_dir: str | pathlib.Path, cmd: dict, *,
                 timeout: float = 30.0) -> dict:
    return read_reply(enqueue_command(state_dir, cmd), timeout=timeout)


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def _daemon_config(args: argparse.Namespace) -> PoolConfig:
    return PoolConfig(
        max_active=args.max_active,
        runtime=RuntimeConfig(
            strategy=StrategyConfig(feedback=args.feedback)))


def cmd_start(args: argparse.Namespace) -> None:
    daemon = PoolDaemon(args.state_dir,
                        config=_daemon_config(args),
                        machine=SimMachine(seed=args.seed),
                        checkpoint_every=args.checkpoint_every,
                        max_workers=args.max_workers,
                        payload_feedback=args.payload_feedback,
                        device=args.device)
    daemon.serve(poll_interval=args.poll_interval, once=args.once,
                 crash_after_steps=args.crash_after_steps)


def _spec_from_args(args: argparse.Namespace) -> JobSpec:
    if args.spec:
        return JobSpec.from_dict(json.loads(args.spec))
    return JobSpec(workload=args.workload, name=args.name,
                   scale=args.scale, priority=args.priority,
                   submit_time=args.submit_time, deadline=args.deadline,
                   latency_budget=args.latency_budget,
                   demand_hint=args.demand_hint)


def cmd_submit(args: argparse.Namespace) -> None:
    spec = _spec_from_args(args)
    print(json.dumps(send_command(
        args.state_dir, {"op": "submit", "spec": spec.to_dict()},
        timeout=args.timeout)))


def cmd_verb(args: argparse.Namespace) -> None:
    cmd: dict = {"op": args.verb}
    if args.verb == "cancel":
        cmd["job"] = args.job
    print(json.dumps(send_command(args.state_dir, cmd,
                                  timeout=args.timeout), indent=1))


def cmd_smoke(args: argparse.Namespace) -> None:
    """CI fast-lane choreography over the real file protocol.

    All commands are enqueued first (filename order = processing
    order), then one ``--once`` daemon run consumes them: 3 submits,
    status, cancel the still-queued third job, drain, exit.  The
    drained metrics must be bit-for-bit an equivalent direct
    ``RuntimePool.run`` with the same submissions and the same
    pre-run cancellation (``max_active=2`` keeps the cancelled job
    queued on both paths, so the ledgers agree exactly)."""
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        state_dir = pathlib.Path(td)
        specs = [JobSpec(workload="resnet50", name="resnet50-0"),
                 JobSpec(workload="dcgan", name="dcgan-1"),
                 JobSpec(workload="dcgan", name="dcgan-2")]
        replies = [enqueue_command(
            state_dir, {"op": "submit", "spec": s.to_dict()}, seq=i)
            for i, s in enumerate(specs)]
        replies.append(enqueue_command(state_dir, {"op": "status"}, seq=3))
        replies.append(enqueue_command(
            state_dir, {"op": "cancel", "job": "job-2"}, seq=4))
        replies.append(enqueue_command(state_dir, {"op": "drain"}, seq=5))

        config = PoolConfig(max_active=2)
        daemon = PoolDaemon(state_dir, config=config,
                            machine=SimMachine(seed=args.seed),
                            device=args.device)
        daemon.serve(once=True)

        out = [read_reply(p, timeout=1.0) for p in replies]
        assert all(r["ok"] for r in out), out
        sub, status, cancel, drain = out[:3], out[3], out[4], out[5]
        assert [r["job"] for r in sub] == ["job-0", "job-1", "job-2"]
        states = {j["id"]: j["state"] for j in status["jobs"]}
        assert states == {"job-0": "admitted", "job-1": "admitted",
                          "job-2": "queued"}, states

        # the reference: same submissions, same pre-run cancel, one
        # direct library run
        pool = RuntimePool(machine=SimMachine(seed=args.seed),
                           config=PoolConfig(max_active=2))
        jobs = [submit_spec(pool, s) for s in specs]
        assert pool.cancel(jobs[2].jid)
        ref = pool.run()
        if drain["metrics"] != ref.metrics:
            diff = {k: (drain["metrics"].get(k), ref.metrics.get(k))
                    for k in set(drain["metrics"]) | set(ref.metrics)
                    if drain["metrics"].get(k) != ref.metrics.get(k)}
            raise SystemExit(f"daemon smoke: drained metrics diverge "
                             f"from direct RuntimePool.run: {diff}")
        print(json.dumps({"ok": True, "makespan": drain["makespan"],
                          "cancelled": cancel["ok"],
                          "jobs": len(sub),
                          "metrics_match": True}))


def main() -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.service")
    sub = ap.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("start", help="run the pool daemon (foreground)")
    sp.add_argument("--state-dir", required=True)
    sp.add_argument("--once", action="store_true",
                    help="exit after the first drain completes")
    sp.add_argument("--poll-interval", type=float, default=0.05)
    sp.add_argument("--checkpoint-every", type=int, default=1)
    sp.add_argument("--max-active", type=int, default=3)
    sp.add_argument("--max-workers", type=int, default=2)
    sp.add_argument("--feedback", choices=("off", "ewma"), default="off")
    sp.add_argument("--payload-feedback", action="store_true",
                    help="report real payload wall times through the "
                         "jobs' plan stores")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--crash-after-steps", type=int, default=None,
                    help="hard-kill (os._exit) after N decision instants "
                         "— crash-recovery testing only")
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where payloads run (cuda raises without a card)")
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("submit", help="submit one job")
    sp.add_argument("--state-dir", required=True)
    sp.add_argument("--timeout", type=float, default=30.0)
    sp.add_argument("--spec", default=None,
                    help="JobSpec wire dict as JSON (overrides the "
                         "individual flags)")
    sp.add_argument("--workload", default="resnet50")
    sp.add_argument("--name", default=None)
    sp.add_argument("--scale", type=int, default=1)
    sp.add_argument("--priority", type=float, default=1.0)
    sp.add_argument("--submit-time", type=float, default=0.0)
    sp.add_argument("--deadline", type=float, default=None)
    sp.add_argument("--latency-budget", type=float, default=None)
    sp.add_argument("--demand-hint", type=float, default=None)
    sp.set_defaults(fn=cmd_submit)

    for verb in ("cancel", "status", "drain", "stop"):
        sp = sub.add_parser(verb)
        sp.add_argument("--state-dir", required=True)
        sp.add_argument("--timeout", type=float, default=30.0)
        if verb == "cancel":
            sp.add_argument("--job", required=True,
                            help="client-facing job id (job-N)")
        sp.set_defaults(fn=cmd_verb, verb=verb)

    sp = sub.add_parser("smoke",
                        help="CI fast-lane: file-protocol round trip + "
                             "metrics parity vs a direct pool run")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the daemon's payload device (cuda raises "
                         "without a card)")
    sp.set_defaults(fn=cmd_smoke)

    args = ap.parse_args()
    args.fn(args)


if __name__ == "__main__":
    main()
