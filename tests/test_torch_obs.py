"""The port's observability layer (``repro_torch.obs``: trace, metrics,
Perfetto export, logger) against ``repro.obs``, exactly.

The armed mix of ``tests/test_obs.py`` (quadrant topology, EWMA
feedback, staggered arrivals under a demand cap, deadlines with
preemption: every static decision family fires) runs through both
packages' pools; its decision events, ``pool_metrics`` (with the
machine's spec and the plan cache's stats), ``slowdown_metrics``,
``metrics_from_events``, ``pool_trace`` and the written Perfetto file
must be equal with ``==``.  The registry primitives, the sink seam and
the logger follow the reference's, under the port's own root logger
name, ``repro_torch``.  Runs on the CPU.
"""

import json
import logging
import warnings

import pytest

import repro.core as RC
import repro.multitenant as RM
import repro.obs as RO
import repro_torch.core as PC
import repro_torch.multitenant as PM
import repro_torch.obs as PO

MIX = [("resnet50", 1.0), ("dcgan", 1.0), ("resnet50", 2.0), ("dcgan", 1.0)]
PKGS = {"repro": (RC, RM, RO), "repro_torch": (PC, PM, PO)}


def run_mix(root, traced=True):
    core, mt, obs = PKGS[root]
    sink = obs.RecordingSink() if traced else None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        config = mt.PoolConfig(max_active=2, topology="quadrant",
                               feedback="ewma",
                               max_outstanding_demand=5000.0,
                               preemption=mt.PreemptionPolicy(enabled=True),
                               sink=sink)
    pool = mt.RuntimePool(machine=core.SimMachine(), config=config)
    for i, (model, prio) in enumerate(MIX):
        submit = i * 0.0005
        pool.submit(core.build_paper_graph(model), priority=prio,
                    name=f"{model}-{i}", submit_time=submit,
                    deadline=(submit + 0.002 if i % 2 else None))
    return pool, pool.run(), sink


@pytest.fixture(scope="module")
def mixes():
    return {root: run_mix(root) for root in PKGS}


def test_decision_events_equal_reference(mixes):
    ref, port = ([e.to_json() for e in mixes[r][2].events] for r in PKGS)
    assert port == ref
    assert {e["family"] for e in ref} == set(RO.FAMILIES) - {
        RO.FAM_REGION, RO.FAM_SERVICE, RO.FAM_CLUSTER}


def records(result):
    return {jid: [(r.op.uid, r.threads, r.variant, r.hyper, r.start,
                   r.finish, r.cores) for r in recs]
            for jid, recs in result.records.items()}


def test_tracing_is_inert_as_in_the_reference(mixes):
    _, untraced, _ = run_mix("repro_torch", traced=False)
    _, traced, _ = mixes["repro_torch"]
    assert records(traced) == records(untraced)
    assert traced.makespan == untraced.makespan
    assert traced.metrics == untraced.metrics
    assert records(traced) == records(mixes["repro"][1])


def test_pool_metrics_equal_reference(mixes):
    out = {}
    for root, (_, _, obs) in PKGS.items():
        pool, res, sink = mixes[root]
        reg = obs.pool_metrics(res, spec=pool.machine.spec,
                               cache_stats=pool.plan_cache.stats(),
                               corrections=pool.corrections)
        serial = pool.run_serial()
        obs.slowdown_metrics(reg, res, serial.job_makespans)
        out[root] = (reg.snapshot(), res.metrics,
                     obs.metrics_from_events(sink.events).snapshot())
    assert out["repro_torch"] == out["repro"]
    snap, metrics, from_events = out["repro"]
    assert snap["pool.preemptions"] > 0
    assert from_events["pool.total_ops"] == metrics["pool.total_ops"]


def test_pool_trace_and_file_equal_reference(tmp_path):
    """The written file, on a two-job mix (the armed mix's ``pool_trace``
    dicts are held in ``tests/test_torch_multitenant.py``)."""
    texts = {}
    for root, (core, mt, obs) in PKGS.items():
        sink = obs.RecordingSink()
        pool = mt.RuntimePool(machine=core.SimMachine(), config=mt.PoolConfig(
            max_active=2, strategy=core.StrategyConfig(sink=sink)))
        for model in ("dcgan", "dcgan"):
            pool.submit(core.build_paper_graph(model), name=model)
        res = pool.run()
        path = tmp_path / f"{root}.json"
        obs.export_pool_trace(res, path, sink.events)
        texts[root] = path.read_text()
    assert texts["repro_torch"] == texts["repro"]
    trace = json.loads(texts["repro"])
    assert trace["displayTimeUnit"] == "ms" and trace["traceEvents"]
    # the port's writer gives the reference's file back
    PO.write_trace(tmp_path / "again.json", trace)
    assert (tmp_path / "again.json").read_text() == texts["repro"]


def registry_ops(obs):
    reg = obs.MetricsRegistry()
    reg.counter("c").inc()
    reg.counter("c").inc(2.0)
    reg.gauge("g").set(0.5)
    for v in (3.0, 1.0, 4.0, 1.5, 9.0, 2.6):
        reg.histogram("h").observe(v)
    h = reg.histogram("h")
    with pytest.raises(KeyError):
        reg.value("renamed.metric")
    return (reg.snapshot(), reg.value("c"), h.count, h.total, h.mean,
            [h.percentile(p) for p in (0, 10, 50, 90, 99, 100)], h.max)


def test_registry_primitives_equal_reference():
    assert registry_ops(PO) == registry_ops(RO)
    assert registry_ops(PO)[0]["c"] == 3.0


def test_sink_seam_as_reference():
    assert PO.NullSink().enabled is False
    assert PO.NullSink() == PO.NullSink() == PO.NULL_SINK
    assert hash(PO.NullSink()) == hash(PO.NULL_SINK)
    assert PO.NullSink() != PO.RecordingSink()
    events = {}
    for obs in (RO, PO):
        sink = obs.RecordingSink()
        sink.emit(obs.TraceEvent(ts=0.0, family=obs.FAM_ADMISSION,
                                 kind="admit"))
        sink.emit(obs.TraceEvent(ts=1.0, family=obs.FAM_PLACEMENT,
                                 kind="book", key=(1, 2),
                                 data={"quadrants": (0,), "spill": False}))
        events[obs] = ([e.to_json() for e in sink.events], len(sink),
                       sorted(sink.families()),
                       [e.kind for e in sink.by_family(obs.FAM_PLACEMENT)])
    assert events[PO] == events[RO]
    assert json.loads(json.dumps(events[PO][0]))[1]["data"]["quadrants"] \
        == [0]


def test_logger_is_the_reference_under_the_port_root():
    assert PO.get_logger("repro_torch.obs.test").name == \
        "repro_torch.obs.test"
    assert PO.get_logger("obs.test").name == "repro_torch.obs.test"
    assert RO.get_logger("obs.test").name == "repro.obs.test"
    root = logging.getLogger("repro_torch")
    before = (list(root.handlers), root.level)
    try:
        PO.configure_logging("info")
        PO.configure_logging("debug")
        assert len(root.handlers) == 1
        assert root.level == logging.DEBUG
        assert all(h.level == logging.DEBUG for h in root.handlers)
    finally:
        for h in root.handlers[:]:
            if h not in before[0]:
                root.removeHandler(h)
        root.setLevel(before[1])
