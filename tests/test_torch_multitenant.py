"""The port's multi-tenant pool (``repro_torch.multitenant``) against
``repro.multitenant``, exactly.

Both packages build the same tenant mixes from the same arguments and
run them through ``RuntimePool``; every result (makespan, each job's
record and accounting, co-run events, plan-cache stats, the metrics
snapshot), every decision event of a ``RecordingSink`` and the serial
baseline must be equal with ``==``: the two copies run the same Python
floats, so no tolerance applies.  The mixes cover the knobs of
``tests/test_multitenant.py``: priorities, admission caps and demand
caps, deadlines with preemption, the preemption economics (several
victims, eviction of admitted jobs, width migration), the reservation
window, the quadrant topology, EWMA feedback and the dynamic graphs with
trip-count feedback.  Besides: ``check_parity``'s report and
``compare_timelines``' rows, the pool CLI's JSON and Perfetto file,
``PlanCache`` files written by either package, ``Job``/``JobQueue``
helpers, ``submit_waves_to_pool``'s deadlines and the deprecated flat
``PoolConfig`` keywords.  The file imports no CUDA and runs on the CPU.
"""

import dataclasses
import importlib
import json
import sys
import types
import warnings

import numpy as np
import pytest
import torch

ROOTS = ("repro", "repro_torch")


def package(root: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
    return types.SimpleNamespace(
        root=root, core=mod("core"), mt=mod("multitenant"),
        job=mod("multitenant.job"), plancache=mod("multitenant.plancache"),
        parity=mod("multitenant.parity"), obs=mod("obs"),
        strategy=mod("core.strategy"), spec=mod("service.spec"),
        launch_pool=mod("launch.pool"))


R, P = (package(root) for root in ROOTS)


def plain(x):
    """A scheduling value as plain Python, comparable across packages:
    dataclasses by field, ops by identity, graphs by fingerprint, other
    objects (plan stores, controllers, sinks) by class name."""
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


# ---------------------------------------------------------------------------
# tenant mixes, built alike in both packages
# ---------------------------------------------------------------------------

def big_graph(pkg, n=3):
    """Chain of very long ops: the head-of-line blocker."""
    b = pkg.core.GraphBuilder("big")
    prev = None
    for _ in range(n):
        prev = b.add("Huge", (512, 512, 64), flops=5e12, bytes_moved=1e9,
                     working_set=1e9, deps=[prev] if prev is not None else [])
    return b.build()


def urgent_chain(pkg, n=4):
    b = pkg.core.GraphBuilder("urgent")
    prev = None
    for _ in range(n):
        prev = b.add("WavePrefill", (32, 128, 64), flops=8e9,
                     bytes_moved=2e7, working_set=2e7,
                     parallel_fraction=0.97,
                     deps=[prev] if prev is not None else [])
    return b.build()


def mix(pkg, config, *, priorities=(1.0, 1.0, 2.0, 1.0), gap=0.0,
        deadlines=(None,) * 4, machine_seed=0, cache=None):
    pool = pkg.mt.RuntimePool(machine=pkg.core.SimMachine(seed=machine_seed),
                              config=config, plan_cache=cache)
    models = ["resnet50", "dcgan", "resnet50", "dcgan"]
    for i, (model, prio, budget) in enumerate(zip(models, priorities,
                                                  deadlines)):
        submit = i * gap
        pool.submit(pkg.core.build_paper_graph(model), priority=prio,
                    name=f"{model}-{i}", submit_time=submit,
                    deadline=None if budget is None else submit + budget)
    return pool


def preempt_mix(pkg, config):
    pool = pkg.mt.RuntimePool(machine=pkg.core.SimMachine(), config=config)
    pool.submit(big_graph(pkg), name="big")
    pool.submit(urgent_chain(pkg), name="urgent", submit_time=0.05,
                deadline=0.15)
    pool.submit(pkg.core.build_paper_graph("dcgan"), name="dcgan",
                submit_time=0.01, deadline=0.3)
    return pool


def dynamic_mix(pkg, config):
    pool = pkg.mt.RuntimePool(machine=pkg.core.SimMachine(), config=config)
    specs = pkg.launch_pool.mix_specs(["rnn", "wave", "rnn", "wave"],
                                      [1.0] * 4, [None, 0.05, None, None],
                                      arrival_gap=0.001, dynamic=True)
    for spec in specs:
        pkg.spec.submit_spec(pool, spec)
    return pool


def policy(pkg, **kw):
    return pkg.strategy.PreemptionPolicy(enabled=True, **kw)


def strategy(pkg, sink=None, **kw):
    if sink is not None:
        kw["sink"] = sink
    return pkg.core.StrategyConfig(**kw)


MIXES = {
    "max-active-3": lambda pkg, sink: mix(pkg, pkg.mt.PoolConfig(
        max_active=3, strategy=strategy(pkg, sink=sink))),
    "max-active-1": lambda pkg, sink: mix(pkg, pkg.mt.PoolConfig(
        max_active=1, strategy=strategy(pkg, sink=sink))),
    "demand-cap-arrivals": lambda pkg, sink: mix(pkg, pkg.mt.PoolConfig(
        max_active=2, max_outstanding_demand=5000.0,
        strategy=strategy(pkg, sink=sink)), gap=0.0005),
    "reservation": lambda pkg, sink: mix(pkg, pkg.mt.PoolConfig(
        max_active=2, reservation_window=0.01,
        strategy=strategy(pkg, sink=sink)), gap=0.002,
        deadlines=(None, 0.01, None, 0.02)),
    "s3-off": lambda pkg, sink: mix(pkg, pkg.mt.PoolConfig(
        max_active=3, strategy=strategy(pkg, sink=sink, enable_s3=False))),
    "preempt": lambda pkg, sink: preempt_mix(pkg, pkg.mt.PoolConfig(
        max_active=4, strategy=strategy(pkg, sink=sink,
                                        preemption=policy(pkg)))),
    "deadlines-no-preempt": lambda pkg, sink: preempt_mix(
        pkg, pkg.mt.PoolConfig(max_active=4,
                               strategy=strategy(pkg, sink=sink))),
    "economics": lambda pkg, sink: preempt_mix(pkg, pkg.mt.PoolConfig(
        max_active=2, strategy=strategy(pkg, sink=sink, preemption=policy(
            pkg, max_victims=3, evict_admitted=True, migration=True)))),
    "quadrant-ewma-preempt": lambda pkg, sink: mix(pkg, pkg.mt.PoolConfig(
        max_active=2, max_outstanding_demand=5000.0,
        strategy=strategy(pkg, sink=sink, topology="quadrant",
                          feedback="ewma", preemption=policy(pkg))),
        gap=0.0005, deadlines=(None, 0.002, None, 0.002)),
    "ewma-seed-5": lambda pkg, sink: mix(pkg, pkg.mt.PoolConfig(
        max_active=3, strategy=strategy(pkg, sink=sink, feedback="ewma")),
        machine_seed=5),
    "dynamic-trip-counts": lambda pkg, sink: dynamic_mix(
        pkg, pkg.mt.PoolConfig(max_active=2,
                               strategy=strategy(pkg, sink=sink,
                                                 feedback="ewma"))),
}


def run_mix(pkg, name):
    """Everything the pool of ``pkg`` decides about one mix."""
    sink = pkg.obs.RecordingSink()
    pool = MIXES[name](pkg, sink)
    res = pool.run()
    events = [e.to_json() for e in sink.events]
    assert events, "the traced run recorded no event"
    serial = pool.run_serial()
    return {"result": plain(res), "events": events,
            "metrics": res.metrics,
            "pool_metrics": pkg.obs.pool_metrics(res).snapshot(),
            "event_metrics": pkg.obs.metrics_from_events(
                sink.events).snapshot(),
            "fairness": res.fairness,
            "serial": plain(serial),
            "slowdowns": res.slowdowns(serial.job_makespans),
            "sched_fairness": res.slowdown_fairness(
                serial.job_makespans, include_queue_wait=False),
            "trace": pkg.obs.pool_trace(res, sink.events)}


@pytest.mark.parametrize("name", list(MIXES))
def test_pool_mix_equals_reference(name):
    ref, port = run_mix(R, name), run_mix(P, name)
    assert ref.keys() == port.keys()
    for key in ref:
        assert port[key] == ref[key], f"{key} differs from the reference"


def test_the_knobs_are_exercised():
    """The mixes above must reach the paths they are named for."""
    res = {name: MIXES[name](P, None).run()
           for name in ("preempt", "economics", "dynamic-trip-counts")}
    assert res["preempt"].n_preemptions > 0
    assert res["economics"].n_evictions + res["economics"].n_migrations > 0
    assert res["dynamic-trip-counts"].n_region_expands > 0


# ---------------------------------------------------------------------------
# parity report, timeline rows, CLI
# ---------------------------------------------------------------------------

def test_check_parity_report_equals_reference():
    ref = R.mt.check_parity(("resnet50", "dcgan"))
    port = P.mt.check_parity(("resnet50", "dcgan"))
    assert port == ref and port["ok"]


def test_compare_timelines_rows_equal_reference():
    out = {}
    for pkg in (R, P):
        rt = pkg.core.ConcurrencyRuntime(machine=pkg.core.SimMachine())
        graph = pkg.core.build_paper_graph("dcgan")
        rt.profile(graph)
        rows = pkg.mt.timeline_rows(rt.execute_step(graph))
        bent = [dict(r) for r in rows[:-1]]
        bent[3]["threads"] += 1
        bent[5]["finish"] *= 1.5
        out[pkg.root] = (rows, pkg.mt.compare_timelines(rows, bent),
                         pkg.mt.compare_timelines(rows, rows,
                                                  label_a="a", label_b="b"))
    assert out["repro_torch"] == out["repro"]
    assert len(out["repro"][1]) == 3 and out["repro"][2] == []


def cli_json(pkg, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["pool", *argv])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        pkg.launch_pool.main()
    return json.loads(capsys.readouterr().out)


CLI_ARGS = {
    "default": [],
    "parity": ["--jobs", "resnet50,dcgan", "--max-active", "2",
               "--check-parity"],
    "economics": ["--deadlines", "0.01,,0.02,", "--arrival-gap", "0.001",
                  "--max-victims", "2", "--evict-admitted", "--migrate",
                  "--topology", "quadrant", "--feedback", "ewma",
                  "--priorities", "1,2,1,3"],
    "dynamic": ["--dynamic", "--trip-count-feedback", "--max-active", "2"],
}


@pytest.mark.parametrize("name", list(CLI_ARGS))
def test_pool_cli_prints_the_reference_json(name, capsys, monkeypatch):
    ref = cli_json(R, CLI_ARGS[name], capsys, monkeypatch)
    port = cli_json(P, CLI_ARGS[name], capsys, monkeypatch)
    assert port == ref


def test_pool_cli_trace_and_plan_cache_files(tmp_path, capsys, monkeypatch):
    out = {}
    for pkg in (R, P):
        d = tmp_path / pkg.root
        d.mkdir()
        argv = ["--jobs", "resnet50,dcgan", "--trace-out",
                str(d / "trace.json"), "--plan-cache-path",
                str(d / "cache.json")]
        first, second = (cli_json(pkg, argv, capsys, monkeypatch)
                         for _ in range(2))
        for out_json in (first, second):
            assert out_json.pop("plan_cache_path") == str(d / "cache.json")
            assert out_json.pop("trace_out") == str(d / "trace.json")
        out[pkg.root] = (first, second,
                         json.loads((d / "trace.json").read_text()),
                         json.loads((d / "cache.json").read_text()))
    assert out["repro_torch"] == out["repro"]
    first, second = out["repro"][:2]
    assert second["plan_cache"]["probes_spent"] == \
        first["plan_cache"]["probes_spent"]


# ---------------------------------------------------------------------------
# plan cache files across packages
# ---------------------------------------------------------------------------

def warm_cache(pkg, path):
    cache = pkg.mt.PlanCache(max_entries=64)
    mix(pkg, pkg.mt.PoolConfig(max_active=3), cache=cache).run()
    cache.dump(path)
    return cache


@pytest.mark.parametrize("writer", ROOTS)
def test_plan_cache_files_load_in_either_package(writer, tmp_path):
    src = R if writer == "repro" else P
    path = tmp_path / "plancache.json"
    written = warm_cache(src, path)
    worlds = {}
    for pkg in (R, P):
        cache = pkg.mt.PlanCache.load(path)
        assert cache.stats() == written.stats()
        res = mix(pkg, pkg.mt.PoolConfig(max_active=3), cache=cache).run()
        worlds[pkg.root] = (plain(res), cache.stats())
    assert worlds["repro_torch"] == worlds["repro"]
    assert worlds["repro"][1]["hits"] > 0


def test_plan_cache_dumps_are_the_same_file(tmp_path):
    texts = {}
    for pkg in (R, P):
        path = tmp_path / f"{pkg.root}.json"
        warm_cache(pkg, path)
        texts[pkg.root] = path.read_text()
    assert texts["repro_torch"] == texts["repro"]


def test_atomic_write_text_as_reference(tmp_path):
    for pkg in (R, P):
        path = tmp_path / f"{pkg.root}.txt"
        pkg.plancache.atomic_write_text(path, "one")
        pkg.plancache.atomic_write_text(path, "two")
        assert path.read_text() == "two"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "repro.txt", "repro_torch.txt"]


# ---------------------------------------------------------------------------
# job helpers, queue, serving waves, config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["resnet50", "inception_v3"])
def test_downstream_critical_path_equals_reference(model):
    out = {}
    for pkg in (R, P):
        graph = pkg.core.build_paper_graph(model)
        rt = pkg.core.ConcurrencyRuntime(machine=pkg.core.SimMachine())
        rt.profile(graph)
        out[pkg.root] = pkg.job.downstream_critical_path(graph, rt.plan)
    assert out["repro_torch"] == out["repro"]


def test_jain_and_fairness_index_equal_reference():
    rng = np.random.default_rng(0)
    for values in ([], [0.0, 0.0], [1.0], list(rng.uniform(0, 5, 9))):
        assert P.job.jain(values) == R.job.jain(values)
    jobs = {pkg.root: mix(pkg, pkg.mt.PoolConfig(max_active=2)).run().jobs
            for pkg in (R, P)}
    assert P.job.fairness_index(jobs["repro_torch"]) == \
        R.job.fairness_index(jobs["repro"])


def queue_trace(pkg):
    """Admission decisions of a ``JobQueue`` under a demand cap, EDF and
    arrival times."""
    q = pkg.mt.JobQueue(max_active=2, max_outstanding_demand=10.0)
    graph = pkg.core.build_paper_graph("dcgan")
    specs = [(1.0, 0.0, None, 4.0), (1.0, 0.0, 0.5, 3.0),
             (2.0, 0.1, None, 8.0), (1.0, 0.0, 0.2, 2.0),
             (2.0, 0.3, 0.4, 1.0)]
    for jid, (prio, submit, deadline, demand) in enumerate(specs):
        q.submit(pkg.mt.Job(jid=jid, name=f"j{jid}", graph=graph,
                            priority=prio, submit_time=submit,
                            deadline=deadline, demand=demand))
    active, out = [], []
    for now in (0.0, 0.05, 0.1, 0.2, 0.3, 0.5):
        out.append((now, [j.jid for j in q.waiting_jobs()],
                    q.next_arrival(now), q.block_cause(active, now)))
        job = q.pop_admissible(active, now)
        while job is not None:
            active.append(job)
            out.append(("admit", job.jid, now))
            job = q.pop_admissible(active, now)
        if len(active) == 2:
            active.pop(0)
    return out


def test_job_queue_admissions_equal_reference():
    assert queue_trace(P) == queue_trace(R)


def serve_wave_deadlines(pkg):
    if pkg is R:
        from repro.models.common import ModelConfig
        from repro.serving import Request, ServeEngine
        params = {}
    else:
        from repro_torch.models.common import ModelConfig
        from repro_torch.serving import Request, ServeEngine
        params = {"embed": {"table": torch.zeros(1)}}
    cfg = ModelConfig(arch_id="tiny", family="dense", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                      vocab=256)
    out = []
    pool = pkg.mt.RuntimePool(machine=pkg.core.SimMachine(),
                              config=pkg.mt.PoolConfig(max_active=4))
    for n, kw in ((4, dict(priority=3.0, arrival_gap=0.5,
                           latency_target=0.25)), (3, {})):
        eng = ServeEngine(cfg, params=params, n_slots=2, max_len=64)
        for i in range(n):
            eng.submit(Request(rid=i, prompt=np.arange(6 + i, dtype=np.int32),
                               max_new_tokens=4))
        jobs = eng.submit_waves_to_pool(pool, **kw)
        out.append([(j.name, j.priority, j.submit_time, j.deadline,
                     j.graph.fingerprint()) for j in jobs])
        assert len(eng.queue) == n, "the engine's queue is left as it was"
    out.append(plain(pool.run()))
    return out


def test_submit_waves_to_pool_deadlines_equal_reference():
    port = serve_wave_deadlines(P)
    assert port == serve_wave_deadlines(R)
    assert [j[3] for j in port[0]] == [0.25, 0.75]
    assert [j[3] for j in port[1]] == [None, None]


@pytest.mark.parametrize("flat", [
    {"feedback": "ewma"}, {"topology": "quadrant"},
    {"preemption": "policy"}, {"enable_s4": False, "candidates": 2}])
def test_flat_pool_config_keywords_warn_and_fold_as_reference(flat):
    docs = {}
    for pkg in (R, P):
        kw = {k: (policy(pkg) if v == "policy" else v)
              for k, v in flat.items()}
        with pytest.warns(DeprecationWarning, match="PoolConfig"):
            cfg = pkg.mt.PoolConfig(max_active=2, **kw)
        docs[pkg.root] = cfg.to_dict()
    assert docs["repro_torch"] == docs["repro"]
    assert P.mt.PoolConfig.from_dict(docs["repro"]).to_dict() == \
        docs["repro"]
    assert R.mt.PoolConfig.from_dict(docs["repro_torch"]).to_dict() == \
        docs["repro"]


def test_exports_equal_reference():
    assert sorted(P.mt.__all__) == sorted(R.mt.__all__)
    assert sorted(P.obs.__all__) == sorted(R.obs.__all__)
    for name in ("pool", "job", "plancache", "parity"):
        ref = importlib.import_module(f"repro.multitenant.{name}")
        port = importlib.import_module(f"repro_torch.multitenant.{name}")
        public = {n for n in vars(ref) if not n.startswith("_")
                  and getattr(getattr(ref, n), "__module__", None)
                  == ref.__name__}
        assert public <= set(vars(port)), name
