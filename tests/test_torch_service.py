"""The port's pool service (``repro_torch.service``: job spec, job store,
``PoolDaemon``; ``launch/service.py``) against ``repro.service``.

The daemon runs here on the CPU (``device="cpu"``; without it, building a
daemon that executes payloads raises where there is no card).  Both
packages' daemons take the same submissions, cancels and drains, and
their status documents, drained results, service trace events and job
stores must be equal with ``==``; a store written by either package's
daemon recovers in the other into the same world after a kill, as the
reference's own crash test sets it up.  Payloads are torch tensors that
flow through the dependency futures and equal the in-order run; a job
revoked before its payload starts never runs it; with payload feedback
every payload op is observed once.  The service CLI's smoke runs in a
subprocess with ``--device cpu`` and prints the reference's JSON.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading

import pytest
import torch

import repro.core as RC
import repro.multitenant as RM
import repro.multitenant.parity as RPar
import repro.obs as RO
import repro.service as RS
import repro.launch.service as RL
import repro_torch.core as PC
import repro_torch.multitenant as PM
import repro_torch.multitenant.parity as PPar
import repro_torch.obs as PO
import repro_torch.service as PS
import repro_torch.launch.service as PL

PKGS = {"repro": dict(core=RC, mt=RM, obs=RO, service=RS, launch=RL, kw={}),
        "repro_torch": dict(core=PC, mt=PM, obs=PO, service=PS, launch=PL,
                            kw={"device": "cpu"})}


def plain(x):
    """A scheduling value as plain Python, comparable across packages:
    dataclasses by field, ops by identity, graphs by fingerprint, other
    objects by class name."""
    name = type(x).__name__
    if name == "Op":
        return ("op", x.uid, x.op_class, x.size_key)
    if name in ("OpGraph", "DynamicOpGraph"):
        return ("graph", x.fingerprint())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(plain(v) for v in x)
    if isinstance(x, list):
        return [plain(v) for v in x]
    if x is None or isinstance(x, (bool, int, float, str, frozenset)):
        return x
    return ("object", name)


def daemon(m, path, **kw):
    return m["service"].PoolDaemon(path, **m["kw"], **kw)


# ---------------------------------------------------------------------------
# wire schema and job store
# ---------------------------------------------------------------------------

SPECS = [dict(workload="rnn", name="r0", priority=2.0, submit_time=0.5,
              latency_budget=1.0, trips=5, max_trips=8),
         dict(workload="wave", depth=2, max_depth=6, accept=True),
         dict(workload="resnet50", scale=2, deadline=4.0, demand_hint=12.5),
         dict(workload="dcgan")]


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_job_spec_wire_dicts_cross_packages(i):
    ref, port = (m["service"].JobSpec(**SPECS[i]) for m in PKGS.values())
    assert port.to_dict() == ref.to_dict()
    assert RS.JobSpec.from_dict(port.to_dict()) == ref
    assert PS.JobSpec.from_dict(json.loads(json.dumps(ref.to_dict()))) \
        == port
    assert port.resolved_deadline() == ref.resolved_deadline()
    assert port.build_graph().fingerprint() == \
        ref.build_graph().fingerprint()


def test_job_spec_rejections_as_reference():
    assert PS.DYNAMIC_WORKLOADS == RS.DYNAMIC_WORKLOADS
    assert PS.ATTACHED_GRAPH == RS.ATTACHED_GRAPH
    with pytest.raises(ValueError, match="deadline"):
        PS.JobSpec(workload="resnet50", deadline=1.0, latency_budget=1.0)
    for key, value, match in (("thread_count", 4, "thread_count"),
                              ("schema", 999, "schema")):
        d = PS.JobSpec(workload="dcgan").to_dict()
        d[key] = value
        with pytest.raises(ValueError, match=match):
            PS.JobSpec.from_dict(d)
    with pytest.raises(ValueError, match="in-process graph"):
        PS.JobSpec(workload=PS.ATTACHED_GRAPH).build_graph()


def store_state(m):
    s = m["service"]
    return s.StoreState(
        clock=1.5, restarts=2, config=m["mt"].PoolConfig().to_dict(),
        entries=[s.JobEntry(spec=s.JobSpec(workload="rnn", trips=3),
                            order=0, state="running", carried_waste=0.25,
                            progress_core_s=1.0, machine=1),
                 s.JobEntry(spec=s.JobSpec(workload="dcgan"), order=1,
                            state="done", result={"latency_s": 2.0})],
        corrections={"alpha": 0.4, "ratio_bounds": [0.25, 4.0],
                     "zero_error": False, "point": [], "overall": [],
                     "observed": 3, "revoked": 0},
        clocks=[1.5, 1.25])


@pytest.mark.parametrize("writer", list(PKGS))
def test_store_files_load_in_either_package(writer, tmp_path):
    path = tmp_path / "store.json"
    PKGS[writer]["service"].save_store(path, store_state(PKGS[writer]))
    loaded = {root: m["service"].load_store(path).to_dict()
              for root, m in PKGS.items()}
    assert loaded["repro_torch"] == loaded["repro"] == \
        store_state(PKGS["repro"]).to_dict()
    with pytest.warns(UserWarning, match="starting fresh"):
        path.write_text("{not json")
        assert PS.load_store(path) is None


# ---------------------------------------------------------------------------
# the daemon, in process
# ---------------------------------------------------------------------------

def submit_cancel_drain(root, path):
    m = PKGS[root]
    sink = m["obs"].RecordingSink()
    d = daemon(m, path, machine=m["core"].SimMachine(seed=7),
               config=m["mt"].PoolConfig(
                   max_active=2,
                   strategy=m["core"].StrategyConfig(sink=sink)))
    ids = [d.submit(m["service"].JobSpec(workload=w, name=n))
           for w, n in (("resnet50", "r0"), ("dcgan", "d1"),
                        ("dcgan", "d2"))]
    first = d.status()
    cancels = (d.cancel("job-2"), d.cancel("job-9"))
    res = d.drain()
    d.close()
    store = json.loads((path / "store.json").read_text())
    return (ids, first, cancels, plain(res), d.status(), store,
            [e.to_json() for e in sink.events])


def test_submit_status_cancel_drain_equal_reference(tmp_path):
    worlds = {root: submit_cancel_drain(root, tmp_path / root)
              for root in PKGS}
    assert worlds["repro_torch"] == worlds["repro"]
    ids, first, _, _, last, _, _ = worlds["repro"]
    assert ids == ["job-0", "job-1", "job-2"]
    assert [j["state"] for j in first["jobs"]] == ["admitted", "admitted",
                                                   "queued"]
    assert [j["state"] for j in last["jobs"]] == ["done", "done",
                                                  "cancelled"]


def file_protocol(root, path):
    m = PKGS[root]
    enqueue, read = m["launch"].enqueue_command, m["launch"].read_reply
    specs = [m["service"].JobSpec(workload=w) for w in ("resnet50", "dcgan")]
    replies = [enqueue(path, {"op": "submit", "spec": s.to_dict()}, seq=i)
               for i, s in enumerate(specs)]
    replies.append(enqueue(path, {"op": "status"}, seq=2))
    replies.append(enqueue(path, {"op": "cancel", "job": "job-1"}, seq=3))
    replies.append(enqueue(path, {"op": "explode"}, seq=4))
    replies.append(enqueue(path, {"op": "drain"}, seq=5))
    d = daemon(m, path, machine=m["core"].SimMachine(seed=7),
               config=m["mt"].PoolConfig(max_active=1))
    d.serve(once=True)
    return [read(p, timeout=1.0) for p in replies]


def test_file_protocol_replies_equal_reference(tmp_path):
    replies = {root: file_protocol(root, tmp_path / root) for root in PKGS}
    assert replies["repro_torch"] == replies["repro"]
    assert [r["ok"] for r in replies["repro"]] == [True] * 4 + [False, True]


def crash_world(root, path):
    """The reference's crash test: pump until EWMA corrections, learned
    trip counts and a queued job exist, drop the daemon without a
    close, restart twice, drain."""
    m = PKGS[root]
    mk = lambda: daemon(m, path, machine=m["core"].SimMachine(seed=3))  # noqa
    d = daemon(m, path, machine=m["core"].SimMachine(seed=3),
               config=m["mt"].PoolConfig(max_active=2, runtime=m[
                   "core"].RuntimeConfig(strategy=m["core"].StrategyConfig(
                       feedback="ewma"))))
    for w, kw in (("rnn", dict(name="loop", trips=3, max_trips=6)),
                  ("resnet50", dict(name="cnn")), ("dcgan", dict(name="g0")),
                  ("dcgan", dict(name="g1"))):
        d.submit(m["service"].JobSpec(workload=w, **kw))
    for _ in range(3000):
        if (d.pool.corrections.observed >= 1
                and d.pool.trip_counts.observed >= 1
                and len(d.pool.queue) >= 1):
            break
        assert d.pump(1), "mix drained before the crash point"
    before = d.status()
    d.executor.close()
    d2 = mk()
    after = (d2.status(), d2.pool.plan_cache.stats(),
             d2.pool.corrections.to_dict(), d2.pool.trip_counts.to_dict(),
             [j.name for j in d2.pool.queue.waiting_jobs()])
    d2.executor.close()
    d3 = mk()
    res = d3.drain()
    d3.close()
    return before, after, d3.status(), plain(res)


def test_kill_and_restart_recovers_the_reference_world(tmp_path):
    worlds = {root: crash_world(root, tmp_path / root) for root in PKGS}
    assert worlds["repro_torch"] == worlds["repro"]
    before, after, last, _ = worlds["repro"]
    assert after[0]["restarts"] == 1 and last["restarts"] == 2
    assert any(j["carried_waste"] > 0 for j in after[0]["jobs"])
    assert {j["state"] for j in last["jobs"]} == {"done"}


@pytest.mark.parametrize("writer", list(PKGS))
def test_a_store_recovers_in_the_other_package(writer, tmp_path):
    """A daemon of one package killed mid-mix; each package restarts on
    a copy of its state directory into the same world."""
    m = PKGS[writer]
    d = daemon(m, tmp_path / "state", machine=m["core"].SimMachine(seed=3),
               config=m["mt"].PoolConfig(max_active=2))
    for w in ("resnet50", "dcgan", "dcgan"):
        d.submit(m["service"].JobSpec(workload=w))
    d.pump(6)
    d.executor.close()
    worlds = {}
    for root, other in PKGS.items():
        state = tmp_path / root
        state.mkdir()
        for name in ("store.json", "plancache.json"):
            (state / name).write_text(
                (tmp_path / "state" / name).read_text())
        d2 = daemon(other, state, machine=other["core"].SimMachine(seed=3))
        first = d2.status()
        res = d2.drain()
        d2.close()
        worlds[root] = (first, plain(res), d2.status())
    assert worlds["repro_torch"] == worlds["repro"]
    assert worlds["repro"][0]["restarts"] == 1


def test_service_timeline_equals_reference():
    rows = {}
    for parity, core in ((RPar, RC), (PPar, PC)):
        res = parity.service_timeline("dcgan", core.SimMachine(seed=3))
        rows[parity] = (res.makespan, parity.timeline_rows(res))
    assert rows[PPar] == rows[RPar]


# ---------------------------------------------------------------------------
# payloads
# ---------------------------------------------------------------------------

def payload_graph(core, lib):
    """Two chains of tensor payloads joined at the end: x -> 2x -> x + 1,
    y -> y @ y, then their sum.  ``lib`` makes the tensors (torch or
    numpy), so both packages compute the same values."""
    b = core.GraphBuilder("tensors")
    x = b.add("X", (32, 16, 16, 64), flops=4e8, bytes_moved=2e6,
              payload=lambda deps: lib.arange(16.0).reshape(4, 4))
    x2 = b.add("X", (32, 16, 16, 64), flops=4e8, bytes_moved=2e6,
               deps=[x], payload=lambda deps: deps[x] * 2)
    x3 = b.add("X", (32, 16, 16, 32), flops=2e8, bytes_moved=1e6,
               deps=[x2], payload=lambda deps: deps[x2] + 1)
    y = b.add("Y", (16, 16, 64), flops=1e8, bytes_moved=1e6,
              payload=lambda deps: lib.ones((4, 4)) * 3)
    y2 = b.add("Y", (16, 16, 32), flops=5e7, bytes_moved=5e5,
               deps=[y], payload=lambda deps: deps[y] @ deps[y])
    b.add("Z", (8, 8), flops=1e6, bytes_moved=1e4, deps=[x3, y2],
          payload=lambda deps: deps[x3] + deps[y2])
    return b.build()


def payload_world(root, path, lib):
    m = PKGS[root]
    d = daemon(m, path, machine=m["core"].SimMachine(seed=7),
               config=m["mt"].PoolConfig(max_active=2), max_workers=2)
    d.submit(m["service"].JobSpec(workload=m["service"].ATTACHED_GRAPH,
                                  name="tensors"),
             graph=payload_graph(m["core"], lib))
    d.submit(m["service"].JobSpec(workload="dcgan"))
    res = d.drain()
    jid = d.pool.jobs[0].jid
    values = {u: f.result()[0].tolist()
              for u, f in d.observer.futures[jid].items()}
    d.close()
    return plain(res), values


def test_torch_payloads_flow_through_deps_as_the_reference(tmp_path):
    import numpy as np
    ref = payload_world("repro", tmp_path / "ref", np)
    port = payload_world("repro_torch", tmp_path / "port", torch)
    assert port == ref
    graph = payload_graph(PC, torch)
    in_order = {}
    for uid in graph.topo_order():
        op = graph.ops[uid]
        in_order[uid] = op.payload({d: in_order[d] for d in op.deps})
    assert port[1] == {u: v.tolist() for u, v in in_order.items()}


def test_revoked_before_start_never_runs(tmp_path):
    """One worker, held by the first job's payload; the second job's
    first payload waits behind it and is cancelled with its job."""
    gate, ran = threading.Event(), []
    b = PC.GraphBuilder("held")
    u = b.add("X", (32, 16, 16, 64), flops=4e8, bytes_moved=2e6,
              payload=lambda deps: (gate.wait(10), torch.ones(2))[1])
    b.add("X", (32, 16, 16, 64), flops=4e8, bytes_moved=2e6, deps=[u],
          payload=lambda deps: deps[u] + 1)
    b2 = PC.GraphBuilder("victim")
    b2.add("X", (32, 16, 16, 64), flops=4e8, bytes_moved=2e6,
           payload=lambda deps: ran.append("victim"))
    d = PS.PoolDaemon(tmp_path, machine=PC.SimMachine(),
                      config=PM.PoolConfig(max_active=2), max_workers=1,
                      device="cpu")
    try:
        held = d.submit(PS.JobSpec(workload=PS.ATTACHED_GRAPH, name="held"),
                        graph=b.build())
        victim = d.submit(PS.JobSpec(workload=PS.ATTACHED_GRAPH,
                                     name="victim"), graph=b2.build())
        jids = [j.jid for j in d.pool.jobs]
        for _ in range(100):
            if all(j in d.observer.futures for j in jids):
                break
            assert d.pump(1)
        fut = d.observer.futures[jids[1]][0]
        assert not fut.done()
        assert d.cancel(victim)
        assert fut.cancelled()
    finally:
        gate.set()
    d.drain()
    out = d.observer.futures[jids[0]][1].result(timeout=10)[0]
    d.close()
    assert ran == []
    assert out.tolist() == [2.0, 2.0]
    assert {j["id"]: j["state"] for j in d.status()["jobs"]} == {
        held: "done", victim: "cancelled"}


def test_payload_feedback_observes_each_payload_op_once(tmp_path):
    d = PS.PoolDaemon(tmp_path, machine=PC.SimMachine(seed=7),
                      config=PM.PoolConfig(max_active=2, strategy=
                                           PC.StrategyConfig(
                                               feedback="ewma")),
                      max_workers=2, payload_feedback=True, device="cpu")
    graph = payload_graph(PC, torch)
    d.submit(PS.JobSpec(workload=PS.ATTACHED_GRAPH, name="tensors"),
             graph=graph)
    d.drain()
    job = d.pool.jobs[0]
    d.close()
    # the sim's own finish of each op and the payload's real time: two
    # observations an op in the job's store
    assert job.store.corrections.observed == 2 * graph.n_ops


def test_a_payload_daemon_needs_a_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        PS.PoolDaemon(tmp_path / "state")
    assert not (tmp_path / "state").exists()


def test_a_daemon_without_payloads_needs_no_device(tmp_path):
    d = PS.PoolDaemon(tmp_path, execute_payloads=False)
    d.submit(PS.JobSpec(workload="dcgan"))
    assert d.drain().makespan > 0
    d.close()
    assert d.executor is None


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def cli(root, *argv):
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(["src", os.environ.get(
               "PYTHONPATH", "")])}
    return subprocess.run([sys.executable, "-m", f"{root}.launch.service",
                           *argv], env=env, capture_output=True, text=True,
                          timeout=120, stdin=subprocess.DEVNULL)


def test_cli_smoke_on_the_cpu_prints_the_reference_json(capsys,
                                                        monkeypatch):
    port = cli("repro_torch", "smoke", "--device", "cpu")
    assert port.returncode == 0, port.stderr
    monkeypatch.setattr(sys, "argv", ["service", "smoke"])
    RL.main()
    ref = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert json.loads(port.stdout.splitlines()[-1]) == ref
    assert ref["metrics_match"]


@pytest.mark.parametrize("command", ["start", "smoke"])
def test_cli_without_a_card_raises(command, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    argv = ["service", command]
    if command == "start":
        argv += ["--state-dir", str(tmp_path / "state"), "--once"]
    monkeypatch.setattr(sys, "argv", argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PL.main()
    assert not (tmp_path / "state").exists()
