"""The port's cluster layer (``repro_torch.cluster``, ``hw.ClusterSpec``)
against ``repro.cluster``, exactly.

Both packages route the same mixes over the same machines: every
``ClusterResult`` (each member machine's pool result, the assignment,
each cluster job's parts, moves and history, the metrics), every
``FAM_CLUSTER`` decision event, the Perfetto ``cluster_trace`` and each
``JobRouter`` choice must be equal with ``==``.  The mixes are those of
``tests/test_cluster.py``: demand and round-robin routing, staggered
arrivals, a per-machine demand cap, a deadline that rebalances, priced
splits (cheap and refused), cancelling a split job, machines with other
timing identities.  The cluster CLI prints the reference's JSON, and
the cluster-mode daemon (on the CPU: these jobs carry no payloads)
restores its placement after a restart as the reference's does.
"""

import dataclasses
import json
import random
import sys
import warnings

import pytest

import repro.cluster as RCl
import repro.core as RC
import repro.hw.spec as RH
import repro.launch.cluster as RL
import repro.multitenant as RM
import repro.obs as RO
import repro.service as RS
import repro_torch.cluster as PCl
import repro_torch.core as PC
import repro_torch.hw.spec as PH
import repro_torch.launch.cluster as PL
import repro_torch.multitenant as PM
import repro_torch.obs as PO
import repro_torch.service as PS

PKGS = {
    "repro": dict(cluster=RCl, core=RC, hw=RH, launch=RL, mt=RM, obs=RO,
                  service=RS, daemon_kw={}),
    "repro_torch": dict(cluster=PCl, core=PC, hw=PH, launch=PL, mt=PM,
                        obs=PO, service=PS, daemon_kw={"device": "cpu"}),
}


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


def two_component_graph(m, chains=2, depth=5):
    b = m["core"].GraphBuilder("twin")
    for _ in range(chains):
        prev = None
        for _ in range(depth):
            prev = b.add("Conv2D", (32, 32, 32, 64), flops=4e9,
                         bytes_moved=1.5e7,
                         deps=([prev] if prev is not None else []))
    return b.build()


def cluster(m, n=2, **kw):
    return m["hw"].ClusterSpec.homogeneous(n, **kw)


def config(m, sink, **kw):
    strategy = (m["core"].StrategyConfig(sink=sink) if sink is not None
                else m["core"].StrategyConfig())
    return m["mt"].PoolConfig(strategy=strategy, **kw)


def paper(m, name):
    return m["core"].build_paper_graph(name)


def random_mix(m, sink, seed):
    rng = random.Random(seed)
    n = rng.choice([2, 3])
    models = [rng.choice(["resnet50", "dcgan"]) for _ in range(5)]
    pool = m["cluster"].ClusterPool(cluster(m, n),
                                    config=config(m, sink, max_active=2))
    for i, name in enumerate(models):
        pool.submit(paper(m, name), name=f"{name}.{i}",
                    submit_time=round(rng.uniform(0, 0.005), 6))
    return pool


def capped(m, sink):
    probe = m["cluster"].ClusterPool(cluster(m, 1))
    big = probe.submit(paper(m, "resnet50")).demand
    small = probe.submit(paper(m, "dcgan")).demand
    pool = m["cluster"].ClusterPool(cluster(m), config=config(
        m, sink, max_active=4, max_outstanding_demand=big + 1.5 * small))
    for i in range(3):
        pool.submit(paper(m, "resnet50"), name=f"r{i}")
        pool.submit(paper(m, "dcgan"), name=f"d{i}")
    return pool


def rebalance(m, sink, on=True):
    pool = m["cluster"].ClusterPool(
        cluster(m), config=config(m, sink, max_active=1),
        router=m["cluster"].RouterConfig(rebalance=on))
    pool.submit(paper(m, "resnet50"), name="hog", machine=0)
    pool.submit(paper(m, "dcgan"), name="urgent", machine=0,
                submit_time=0.001, deadline=0.04)
    return pool


def split(m, sink, cost=1e-4, cancel=False):
    knl = m["hw"].KNL
    pool = m["cluster"].ClusterPool(
        m["hw"].ClusterSpec(machines=(knl, knl), transfer_cost_s=cost),
        config=config(m, sink), router=m["cluster"].RouterConfig(split=True))
    job = pool.submit(two_component_graph(m), name="twin")
    pool.submit(paper(m, "dcgan"), name="dcgan")
    if cancel:
        assert pool.cancel(job.jid)
    return pool


def mix4(m, sink, policy="demand"):
    pool = m["cluster"].ClusterPool(
        cluster(m), config=config(m, sink, max_active=2),
        router=m["cluster"].RouterConfig(policy=policy))
    for i, name in enumerate(["resnet50", "dcgan", "resnet50", "dcgan"]):
        pool.submit(paper(m, name), name=f"{name}.{i}")
    return pool


def seeds(m, sink):
    core = m["core"]
    pool = m["cluster"].ClusterPool(
        cluster(m), config=config(m, sink),
        machines=[core.SimMachine(seed=0), core.SimMachine(seed=7)])
    pool.submit(paper(m, "dcgan"), machine=0)
    pool.submit(paper(m, "dcgan"), machine=1)
    pool.submit(paper(m, "resnet50"), deadline=0.05)
    return pool


MIXES = {
    "demand": mix4,
    "round-robin": lambda m, sink: mix4(m, sink, "round_robin"),
    "random-0": lambda m, sink: random_mix(m, sink, 0),
    "random-1": lambda m, sink: random_mix(m, sink, 1),
    "random-2": lambda m, sink: random_mix(m, sink, 2),
    "demand-cap": capped,
    "rebalance": rebalance,
    "rebalance-off": lambda m, sink: rebalance(m, sink, on=False),
    "split": split,
    "split-refused": lambda m, sink: split(m, sink, cost=1e9),
    "split-cancelled": lambda m, sink: split(m, sink, cancel=True),
    "machine-seeds": seeds,
}


def run_mix(root, name):
    m = PKGS[root]
    sink = m["obs"].RecordingSink()
    pool = MIXES[name](m, sink)
    res = pool.run()
    return {"result": plain(res),
            "events": [e.to_json() for e in sink.events],
            "trace": m["obs"].cluster_trace(res, sink.events),
            "event_metrics": m["obs"].metrics_from_events(
                sink.events).snapshot(),
            "cache": pool.plan_cache.stats(),
            "demand_index": (pool.demand_index.hits,
                             pool.demand_index.misses)}


@pytest.mark.parametrize("name", list(MIXES))
def test_cluster_mix_equals_reference(name):
    ref, port = run_mix("repro", name), run_mix("repro_torch", name)
    assert ref.keys() == port.keys()
    for key in ref:
        assert port[key] == ref[key], f"{key} differs from the reference"


def test_the_cluster_paths_are_exercised():
    res = {name: MIXES[name](PKGS["repro_torch"], None).run()
           for name in ("rebalance", "split")}
    assert res["rebalance"].n_rebalances == 1
    assert res["split"].n_splits == 1


def test_cluster_spec_equals_reference():
    for kw in ({}, {"name": "c3", "transfer_cost_s": 2e-3}):
        ref, port = (pkg.ClusterSpec.homogeneous(3, **kw) for pkg in (RH, PH))
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert (len(port), port.n_machines, port.total_cores) == \
            (len(ref), ref.n_machines, ref.total_cores)
    with pytest.raises(ValueError):
        PH.ClusterSpec(machines=())
    with pytest.raises(dataclasses.FrozenInstanceError):
        PH.ClusterSpec().name = "x"


def test_router_choices_equal_reference():
    rng = random.Random(0)
    tables = [[(rng.uniform(0, 1e4), rng.uniform(1e-3, 1e3),
                rng.choice([0.0, 0.5, 1.0])) for _ in range(rng.randint(1, 6))]
              for _ in range(200)]
    tables += [[(10.0, 5.0, 0.0), (10.0, 5.0, 1.0)],
               [(10.0, 5.0, 0.5)] * 2, [(100.0, 5.0, 0.0), (0.0, 5.0, 0.0)]]
    out = {}
    for pkg in (RCl, PCl):
        routers = [pkg.JobRouter(pkg.RouterConfig(policy=p))
                   for p in pkg.POLICIES]
        choices = []
        for rows in tables:
            facts = [pkg.MachineFacts(i, 68, load, demand, warm)
                     for i, (load, demand, warm) in enumerate(rows)]
            choices.append([(r.route(facts), [f.projected_finish
                                              for f in facts])
                            for r in routers])
        with pytest.raises(ValueError):
            pkg.RouterConfig(policy="lottery")
        with pytest.raises(ValueError):
            pkg.JobRouter().route([])
        unpriced = pkg.MachineFacts(0, 68, load=68.0, demand=None,
                                    warm_frac=0.0)
        out[pkg] = choices, unpriced.projected_finish
    assert tuple(PCl.POLICIES) == tuple(RCl.POLICIES)
    assert out[PCl] == out[RCl]


@pytest.mark.parametrize("model", ["resnet50", "dcgan"])
def test_cluster_timeline_equals_reference(model):
    rows = {}
    for root in PKGS:
        m = PKGS[root]
        parity = sys.modules[f"{root}.multitenant.parity"]
        res = parity.cluster_timeline(paper(m, model),
                                      m["core"].SimMachine(seed=3))
        rows[root] = (res.makespan, parity.timeline_rows(res))
    assert rows["repro_torch"] == rows["repro"]


CLI_ARGS = {
    "compare": ["--machines", "2", "--compare"],
    "round-robin-parity": ["--machines", "3", "--policy", "round_robin",
                           "--jobs", "resnet50,dcgan,dcgan",
                           "--check-parity"],
    "deadlines-split": ["--machines", "2", "--split", "--jobs",
                        "resnet50,dcgan,resnet50,dcgan", "--deadlines",
                        "0.05,,0.03,", "--arrival-gap", "0.001",
                        "--feedback", "ewma", "--no-rebalance"],
}


@pytest.mark.parametrize("name", list(CLI_ARGS))
def test_cluster_cli_prints_the_reference_json(name, capsys, monkeypatch,
                                               tmp_path):
    out = {}
    for root in PKGS:
        trace = tmp_path / f"{root}.json"
        monkeypatch.setattr(sys, "argv", ["cluster", *CLI_ARGS[name],
                                          "--trace-out", str(trace)])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            PKGS[root]["launch"].main()
        printed = json.loads(capsys.readouterr().out)
        printed.pop("trace_out", None)
        out[root] = (printed, json.loads(trace.read_text()))
    assert out["repro_torch"] == out["repro"]


def daemon_world(root, path):
    m = PKGS[root]
    spec = cluster(m)
    cfg = m["mt"].PoolConfig(max_active=2)
    d1 = m["service"].PoolDaemon(path, cluster=spec, config=cfg,
                                 **m["daemon_kw"])
    for i, w in enumerate(["resnet50", "dcgan", "dcgan", "resnet50"]):
        d1.submit(m["service"].JobSpec(workload=w, name=f"j{i}"))
    d1.pump(5)
    before = d1.status()
    # a crash: no close(), only what the per-step checkpoints persisted
    d2 = m["service"].PoolDaemon(path, cluster=spec, config=cfg,
                                 **m["daemon_kw"])
    after = d2.status()
    res = d2.drain()
    d2.close()
    d1.executor.close()
    return before, after, plain(res), d2.status()


def test_cluster_daemon_restart_equals_reference(tmp_path):
    worlds = {root: daemon_world(root, tmp_path / root) for root in PKGS}
    assert worlds["repro_torch"] == worlds["repro"]
    before, after = worlds["repro"][:2]
    assert {j["id"]: j["machine"] for j in after["jobs"]} == \
        {j["id"]: j["machine"] for j in before["jobs"]}
    with pytest.raises(ValueError):
        PS.PoolDaemon(tmp_path / "x", cluster=cluster(PKGS["repro_torch"]),
                      machine=PC.SimMachine(), device="cpu")
