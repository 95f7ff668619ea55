"""The port's copy of the scheduling stack (``repro_torch.core``) against
``repro.core``, exactly.

Every graph is built in both packages from the same arguments and must
have the same fingerprint; then the profile (every curve's samples), the
frozen plan (``per_instance``), ``ConcurrencyRuntime.train``'s summary,
``execute_step``'s schedule (makespan, co-run events and each op's launch
record), the two baselines (``uniform_schedule``, ``manual_best_schedule``)
and the decision events of a ``RecordingSink`` must be equal with ``==``:
the two packages run the same Python floats through the same numpy calls,
so no tolerance applies.  The same holds on dcgan under the strategy
knobs of ``tests/test_strategy_differential.py``, the quadrant topology,
EWMA feedback and another machine seed; the port's ``CorunScheduler``
reproduces the committed golden timelines; the six regressors predict
alike; and each package loads the other's config documents.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from repro.configs import get_config as jax_get_config
from repro.obs.trace import RecordingSink as RefRecordingSink
from repro.serving import Request as JaxRequest
from repro.serving import wave_op_graph as jax_wave_op_graph
from repro_torch.configs import get_config
from repro_torch.obs import RecordingSink
from repro_torch.serving import Request, wave_op_graph

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
SINKS = {R: RefRecordingSink, P: RecordingSink}

_OLMO = get_config("olmo-1b", smoke=True)
OLMO_DIMS = dict(n_layers=_OLMO.n_layers, d_model=_OLMO.d_model,
                 n_heads=_OLMO.n_heads, d_ff=_OLMO.d_ff, seq=64, batch=4)
# (prompt length, max_new_tokens) of the olmo-1b smoke wave
WAVE = [(12, 4), (7, 3), (9, 2)]


def _wave_graph(pkg):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, _OLMO.vocab, n).astype(np.int32)
               for n, _ in WAVE]
    if pkg is R:
        return jax_wave_op_graph(
            jax_get_config("olmo-1b", smoke=True),
            [JaxRequest(rid=i, prompt=p, max_new_tokens=m)
             for i, (p, (_, m)) in enumerate(zip(prompts, WAVE))], n_slots=4)
    return wave_op_graph(_OLMO, [Request(rid=i, prompt=p, max_new_tokens=m)
                                 for i, (p, (_, m)) in
                                 enumerate(zip(prompts, WAVE))], n_slots=4)


GRAPHS = {
    "resnet50": lambda pkg: pkg.build_paper_graph("resnet50"),
    "dcgan": lambda pkg: pkg.build_paper_graph("dcgan"),
    "inception_v3": lambda pkg: pkg.build_paper_graph("inception_v3"),
    "alexnet": lambda pkg: pkg.build_paper_graph("alexnet"),
    "transformer": lambda pkg: pkg.build_transformer_step_graph(
        **OLMO_DIMS),
    "transformer-moe": lambda pkg: pkg.build_transformer_step_graph(
        **OLMO_DIMS, moe_experts=4),
    "recurrent": lambda pkg: pkg.build_recurrent_step_graph(
        trips=3, est_trips=4.0),
    "early-exit": lambda pkg: pkg.build_early_exit_wave(depth=2,
                                                        accept=False),
    "olmo-1b-wave": _wave_graph,
}

# (RuntimeConfig kwargs, StrategyConfig kwargs, machine seed) on dcgan:
# the differential suite's five knob sets, the quadrant topology, EWMA
# feedback and another seed
CONFIGS = {
    "no-s4": ({}, {"enable_s4": False}, 0),
    "serial": ({}, {"enable_s3": False, "enable_s4": False}, 0),
    "no-s2": ({"strategy2": False}, {}, 0),
    "tight": ({}, {"candidates": 1, "max_ht_corunners": 1}, 0),
    "fallback-knobs": ({}, {"min_fallback_cores": 34,
                            "fallback_slack": 0.5}, 0),
    "quadrant": ({}, {"topology": "quadrant"}, 0),
    "ewma": ({}, {"feedback": "ewma"}, 0),
    "seed-7": ({}, {}, 7),
}


def timeline(result) -> list[dict]:
    """Each op's launch record, with the fields of the golden fixtures."""
    return [{"uid": r.op.uid, "op_class": r.op.op_class,
             "threads": r.threads, "variant": r.variant, "hyper": r.hyper,
             "start": r.start, "finish": r.finish, "predicted": r.predicted}
            for r in result.records]


def schedule(result) -> dict:
    return {"makespan": result.makespan, "events": result.events,
            "records": timeline(result)}


def _config(pkg, runtime_kw: dict, strategy_kw: dict, sink=None):
    return pkg.RuntimeConfig(**runtime_kw, strategy=pkg.StrategyConfig(
        **strategy_kw, **({"sink": sink} if sink is not None else {})))


def run_stack(pkg, graph_name: str, runtime_kw=(), strategy_kw=(),
              seed: int = 0, baselines: bool = True) -> dict:
    """Everything the stack of ``pkg`` decides about one graph, in plain
    Python values."""
    graph = GRAPHS[graph_name](pkg)
    sink = SINKS[pkg]()
    rt = pkg.ConcurrencyRuntime(
        machine=pkg.SimMachine(seed=seed),
        config=_config(pkg, dict(runtime_kw), dict(strategy_kw), sink))
    summary = rt.train(graph, total_steps=10_000)
    out = {
        "fingerprint": graph.fingerprint(),
        "summary": dataclasses.asdict(summary),
        "speedup": summary.speedup,
        "curves": {k: c.samples for k, c in rt.store.curves.items()},
        "per_instance": {k: dataclasses.asdict(p)
                         for k, p in rt.plan.per_instance.items()},
        "step": schedule(rt.execute_step(graph)),
    }
    out["trace"] = [e.to_json() for e in sink.events]
    assert out["trace"], "the traced run recorded no event"
    if baselines:
        machine = pkg.SimMachine(seed=seed)
        out["uniform"] = schedule(pkg.uniform_schedule(graph, machine,
                                                       intra=68, inter=1))
        manual, best = pkg.manual_best_schedule(graph, machine)
        out["manual"] = {**schedule(manual), "config": best}
    return out


def assert_same(ref: dict, port: dict) -> None:
    assert ref.keys() == port.keys()
    for key in ref:
        assert ref[key] == port[key], f"{key} differs from the reference"


@pytest.mark.parametrize("graph_name", list(GRAPHS))
def test_graph_stack_equals_reference(graph_name):
    assert_same(run_stack(R, graph_name), run_stack(P, graph_name))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_dcgan_config_equals_reference(config):
    runtime_kw, strategy_kw, seed = CONFIGS[config]
    ref, port = (run_stack(pkg, "dcgan", runtime_kw.items(),
                           strategy_kw.items(), seed, baselines=False)
                 for pkg in (R, P))
    assert_same(ref, port)


def test_ewma_feedback_moves_the_corrections():
    """The EWMA case above must exercise the feedback path, not pass as
    a frozen store would."""
    rt = P.ConcurrencyRuntime(config=_config(P, {}, {"feedback": "ewma"}))
    rt.train(P.build_paper_graph("dcgan"))
    assert rt.planstore.corrections.observed > 0


@pytest.mark.parametrize("model", ["resnet50", "dcgan"])
def test_port_matches_golden_timeline(model):
    golden = json.loads((GOLDEN_DIR / f"strategy_{model}.json").read_text())
    rt = P.ConcurrencyRuntime(machine=P.SimMachine(seed=golden["seed"]))
    rt.profile(P.build_paper_graph(model))
    res = rt.execute_step(P.build_paper_graph(model))
    assert res.makespan == golden["makespan"]
    assert timeline(res) == golden["records"]


@pytest.mark.parametrize("regressor", sorted(R.REGRESSORS))
def test_regressor_predictions_equal_reference(regressor):
    assert sorted(P.REGRESSORS) == sorted(R.REGRESSORS)
    preds = {}
    for pkg in (R, P):
        machine = pkg.SimMachine()

        def oracle(op, threads, variant, machine=machine, pkg=pkg):
            return machine.op_time(
                op, pkg.Placement(threads, cache_sharing=variant))

        cases = pkg.paper_case_lists()
        suite = pkg.RegressionSuite(feature_fn=machine.counters,
                                    oracle=oracle, cases=cases[True])
        train = list(pkg.build_paper_graph("resnet50").ops.values())[:24]
        test = list(pkg.build_paper_graph("alexnet").ops.values())[:12]
        out = []
        # the paper's 68 cases; every 16th for gradient boosting, whose
        # numpy fit (50 trees in Python loops) takes about 0.5 s a case
        every = 16 if regressor == "GradientBoosting" else 1
        for case in (cases[False] + cases[True])[::every]:
            xtr, ytr = suite.dataset(train, case, 4)
            xte, _ = suite.dataset(test, case, 4)
            model = pkg.REGRESSORS[regressor]().fit(xtr, np.log(ytr + 1e-12))
            out.append(model.predict(xte))
        preds[pkg] = np.stack(out)
    assert np.array_equal(preds[R], preds[P])


@pytest.mark.parametrize("config", list(CONFIGS))
def test_config_documents_load_across_packages(config):
    runtime_kw, strategy_kw, _ = CONFIGS[config]
    ref = _config(R, runtime_kw, strategy_kw).to_dict()
    port = _config(P, runtime_kw, strategy_kw).to_dict()
    assert port == ref
    assert P.RuntimeConfig.from_dict(ref).to_dict() == ref
    assert R.RuntimeConfig.from_dict(port).to_dict() == port


def test_deprecated_flat_kwargs_still_warn_and_fold():
    with pytest.warns(DeprecationWarning):
        cfg = P.RuntimeConfig(feedback="ewma")
    assert cfg.strategy == P.StrategyConfig(feedback="ewma")


def test_core_exports_the_reference_names_but_autotune():
    # the autotuner came with the sharding substrate: every name now
    autotune = {"RooflineMeasurement", "ShardDegreeAutotuner",
                "ShardDecision", "ShardPlanResult", "corun_groups",
                "CorunGroup"}
    assert autotune <= set(P.__all__)
    assert set(P.__all__) == set(R.__all__)
    from repro.hw.spec import KNL as REF_KNL
    from repro_torch.hw.spec import KNL
    assert dataclasses.asdict(KNL) == dataclasses.asdict(REF_KNL)
