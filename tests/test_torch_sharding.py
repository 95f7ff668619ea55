"""The port's sharding substrate against the reference, in this process:
logical axes, plans, specs, meshes and the shard-degree autotuner.

* ``zoo.specs(cfg)`` equals the reference's for all ten architectures,
  smoke and full, leaf by leaf (the port builds them on ``meta``).
* ``ShardingPlan.spec_for`` equals ``tuple`` of the reference's
  ``PartitionSpec`` over every logical tuple of every model and the
  first-use-wins cases (MoE (expert, embed, ff), rwkv (embed, embed)),
  under the default, replicated, degree-built and multi-axis plans.
* ``degree_to_axes``, ``plan_from_degrees``, ``clamp_degree_for_axis`` and
  ``validate_plan`` as the reference's (``tests/test_autotune_sharding.py``
  ``TestShardingPlans``).  The port's meshes are ``DeviceMesh``es over a
  fake process group of 256 or 512 ranks (torch's testing backend: no
  collective runs), torn down after the module; the reference's
  ``validate_plan`` reads only the mesh's axis names and device shape.
* ``placements_for``, ``named_sharding_tree``, ``batch_sharding`` and
  ``replicated``: one placement a mesh dim.
* ``ShardDegreeAutotuner`` and ``corun_groups``: the same decisions,
  predictions, probes and groups as the reference's on its synthetic
  roofline measures (``TestShardDegreeAutotuner``, ``TestCorunGroups``).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.core import RooflineMeasurement as JaxRooflineMeasurement
from repro.core import ShardDegreeAutotuner as JaxShardDegreeAutotuner
from repro.core import corun_groups as jax_corun_groups
from repro.models import zoo as jax_zoo
from repro.models.common import ShardingPlan as JaxShardingPlan
from repro.models.common import default_plan as jax_default_plan
from repro.models.common import replicated_plan as jax_replicated_plan
from repro.sharding import clamp_degree_for_axis as jax_clamp
from repro.sharding import degree_to_axes as jax_degree_to_axes
from repro.sharding import plan_from_degrees as jax_plan_from_degrees
from repro.sharding import validate_plan as jax_validate_plan
from repro_torch.configs import get_config
from repro_torch.core import (RooflineMeasurement, ShardDegreeAutotuner,
                              corun_groups)
from repro_torch.launch.mesh import (make_mesh, make_production_mesh,
                                     pod_size, use_mesh)
from repro_torch.models import zoo
from repro_torch.models.common import (LOGICAL_AXES, ShardingPlan,
                                       default_plan, replicated_plan)
from repro_torch.sharding import (OP_CLASS_AXES, batch_sharding,
                                  clamp_degree_for_axis, degree_to_axes,
                                  named_sharding_tree, placements_for,
                                  plan_from_degrees, replicated,
                                  validate_plan)
from repro_torch.train import state_specs, TrainConfig

FACTORED = (("mdl", 8), ("sub", 2))


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, path) if isinstance(v, dict) else {path: v})
    return out


def _plans():
    """(name, port plan, reference plan) pairs with the same rules."""
    multi = {"embed": ("pod", "data"), "ff": ("model", "data"),
             "heads": ("model",), "kv": ("data", "model"),
             "vocab": ("model", "pod"), "expert": ("data",)}
    degrees = {"mlp": 16, "attention": 8, "moe": 8, "embed": 1}
    return [
        ("default", default_plan(), jax_default_plan()),
        ("replicated", replicated_plan(), jax_replicated_plan()),
        ("degrees", plan_from_degrees(degrees, FACTORED),
         jax_plan_from_degrees(degrees, FACTORED)),
        ("multi-axis", ShardingPlan(rules=multi), JaxShardingPlan(
            rules=multi)),
    ]


def _logical_tuples():
    tuples = {(), (None,), ("expert", "embed", "ff"), ("embed", "embed"),
              ("ff", "ff"), ("heads", "embed"), ("vocab", "table_d"),
              ("layers", "expert", "ff", "embed"), ("kv", "heads", "kv"),
              ("embed", "ff", "vocab", "heads"), ("unknown", "embed")}
    for arch in ARCH_IDS:
        tuples.update(_leaves(zoo.specs(get_config(arch))).values())
    return sorted(tuples, key=repr)


@pytest.fixture(scope="module")
def fake_world():
    """A fake process group of 512 ranks (no collective runs), so
    ``DeviceMesh``es of the reference's shapes exist in this process;
    torn down after the module."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# specs and plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_reference(arch, smoke):
    want = jax_zoo.specs(jax_get_config(arch, smoke=smoke))
    got = zoo.specs(get_config(arch, smoke=smoke))
    assert got == want
    params = zoo.init(get_config(arch, smoke=smoke), device="meta")
    shapes = {p: t.shape for p, t in _leaves(params).items()}
    specs = _leaves(got)
    assert specs.keys() == shapes.keys() and specs
    assert all(len(specs[p]) == len(shapes[p]) for p in specs)
    assert {a for s in specs.values() for a in s} - {None} \
        <= set(LOGICAL_AXES)


@pytest.mark.parametrize("name", ["default", "replicated", "degrees",
                                  "multi-axis"])
def test_spec_for_equals_reference(name):
    port, ref = next((p, r) for n, p, r in _plans() if n == name)
    assert port.rules == ref.rules and port.batch_axes == ref.batch_axes \
        and port.seq_axes == ref.seq_axes
    for logical in _logical_tuples():
        assert port.spec_for(logical) == tuple(ref.spec_for(logical)), \
            logical


def test_spec_for_first_use_wins():
    plan = default_plan()
    assert plan.spec_for(("expert", "embed", "ff")) == ("model", "data",
                                                        None)
    assert plan.spec_for(("embed", "embed")) == ("data", None)
    assert plan.tree_specs({"a": ("embed", "ff"), "b": {"c": ()}}) == \
        {"a": ("data", "model"), "b": {"c": ()}}


def test_state_specs_follow_the_params():
    cfg = get_config("olmo-1b", smoke=True)
    out = state_specs(cfg, TrainConfig())
    assert out["params"] == out["opt"]["mu"] == out["opt"]["nu"] \
        == zoo.specs(cfg)
    assert out["opt"]["step"] == ()


class TestShardingPlans:
    def test_degree_to_axes(self):
        axes = (("model", 16),)
        for d in (16, 1):
            assert degree_to_axes(d, axes) == jax_degree_to_axes(d, axes)
        assert degree_to_axes(16, axes) == ("model",)
        assert degree_to_axes(1, axes) == ()
        with pytest.raises(ValueError):
            degree_to_axes(8, axes)      # not a product of sub-axes
        with pytest.raises(ValueError):
            jax_degree_to_axes(8, axes)

    def test_degree_with_factored_axes(self):
        for d in (1, 8, 16):
            assert degree_to_axes(d, FACTORED) == \
                jax_degree_to_axes(d, FACTORED)
        assert degree_to_axes(16, FACTORED) == ("mdl", "sub")
        assert degree_to_axes(8, FACTORED) == ("mdl",)

    def test_clamp_degree(self):
        for degree in range(1, 33):
            for axis_len in (1, 2, 3, 8, 12, 16, 24, 32):
                assert clamp_degree_for_axis(degree, axis_len) == \
                    jax_clamp(degree, axis_len)
        assert clamp_degree_for_axis(16, 8) == 8
        assert clamp_degree_for_axis(3, 8) == 2
        assert clamp_degree_for_axis(16, 12) == 4

    @pytest.mark.parametrize("degrees", [
        {"mlp": 16, "attention": 8}, {}, {"moe": 8, "embed": 16},
        {"recurrence": 16, "mlp": 1}])
    def test_plan_from_degrees(self, degrees):
        got = plan_from_degrees(degrees, FACTORED, fsdp_axes=("pod", "data"))
        want = jax_plan_from_degrees(degrees, FACTORED,
                                     fsdp_axes=("pod", "data"))
        assert got.rules == want.rules
        assert got.batch_axes == want.batch_axes
        assert got.seq_axes == want.seq_axes
        if degrees.get("mlp") == 16:
            assert got.rules["ff"] == ("mdl", "sub")
            assert got.rules["heads"] == ("mdl",)
        assert set(OP_CLASS_AXES) == {"attention", "mlp", "moe", "embed",
                                      "recurrence"}
        with pytest.raises(ValueError):
            plan_from_degrees({**degrees, "mlp": 2}, FACTORED)
        with pytest.raises(ValueError):
            jax_plan_from_degrees({**degrees, "mlp": 2}, FACTORED)

    @pytest.mark.parametrize("shape,axes", [
        ((1,), ("model",)), ((16, 16), ("data", "model")),
        ((2, 16, 16), ("pod", "data", "model")), ((4, 2), ("data", "model")),
        ((8, 3), ("data", "model"))])
    def test_validate_plan(self, fake_world, shape, axes):
        mesh = make_mesh(shape, axes, device_type="cpu")
        ref_mesh = types.SimpleNamespace(axis_names=axes,
                                         devices=np.empty(shape))
        cases = 0
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            jcfg = jax_get_config(arch)
            for _, port, ref in _plans():
                got = validate_plan(cfg, port, mesh)
                assert got == jax_validate_plan(jcfg, ref, ref_mesh)
                cases += bool(got)
        # degree 1 is always fine; the 3-wide model axis is not
        if shape == (1,):
            assert cases == 0
        if shape == (8, 3):
            assert cases > 0


# ---------------------------------------------------------------------------
# meshes and placements
# ---------------------------------------------------------------------------

def test_meshes_and_placements(fake_world):
    mesh = make_production_mesh(device_type="cpu")
    assert mesh.shape == (16, 16) and mesh.mesh_dim_names == ("data",
                                                              "model")
    assert pod_size(mesh) == 256
    pods = make_production_mesh(multi_pod=True, device_type="cpu")
    assert pods.shape == (2, 16, 16) and pod_size(pods) == 256
    # inside use_mesh, DTensor's functions take the mesh when given none
    import torch
    from torch.distributed.tensor import distribute_tensor

    def placed(placements):
        return distribute_tensor(torch.zeros(32, 32), placements=placements,
                                 src_data_rank=None)
    with use_mesh(mesh):
        assert placed([Shard(0), Replicate()]).device_mesh is mesh
        with use_mesh(pods):
            assert placed([Shard(0)] * 3).device_mesh is pods
        back = placed([Shard(1), Replicate()])
        assert back.device_mesh is mesh and back.to_local().shape == (32, 2)

    assert placements_for(("data", None, "model"), mesh) == (Shard(0),
                                                             Shard(2))
    assert placements_for((None, ("data", "model")), mesh) == (Shard(1),
                                                               Shard(1))
    assert placements_for((), mesh) == (Replicate(), Replicate())
    with pytest.raises(NotImplementedError):
        placements_for((("model", "data"),), mesh)   # minor axis first
    with pytest.raises(ValueError):
        placements_for(("pod",), mesh)

    plan = default_plan()
    tree = named_sharding_tree(plan, mesh, zoo.specs(
        get_config("olmo-1b", smoke=True)))
    assert tree["layers"]["wq"].placements == (Shard(1), Shard(2))
    assert tree["embed"]["table"].placements == (Replicate(), Shard(0))
    assert tree["final_norm"].placements == (Replicate(), Replicate())
    assert tree["layers"]["wq"].mesh is mesh
    assert batch_sharding(plan, mesh).placements == (Shard(0), Replicate())
    seq = dataclasses.replace(plan, seq_axes=("model",))
    assert batch_sharding(seq, mesh, seq_dim=1).placements == (Shard(0),
                                                               Shard(1))
    assert replicated(pods).placements == (Replicate(),) * 3


# ---------------------------------------------------------------------------
# the shard-degree autotuner
# ---------------------------------------------------------------------------

def _synthetic(cls, t_serial: float, comm_coef: float):
    """Convex roofline curve: compute shrinks 1/d, collectives grow with
    d (the reference test's measure)."""
    def fn(op_class, degree, variant):
        return cls(compute_s=t_serial / degree,
                   memory_s=t_serial / (2 * degree),
                   collective_s=comm_coef * (degree - 1)
                   + (0.01 if variant else 0.0))
    return fn


def _decisions(result) -> dict:
    return {c: (d.op_class, d.degree, d.variant, d.predicted.compute_s,
                d.predicted.memory_s, d.predicted.collective_s,
                d.predicted.time, d.predicted.bottleneck)
            for c, d in result.decisions.items()}


MEASURES = [(1.0, 0.02), (1.0, 0.0), (1.0, 0.5), (1.0, 0.001), (3.0, 0.05)]


@pytest.mark.parametrize("t_serial,comm", MEASURES)
@pytest.mark.parametrize("variants", [(False,), (False, True)])
def test_autotuner_equals_reference(t_serial, comm, variants):
    classes = ["mlp", "attention", "moe"]
    got = ShardDegreeAutotuner(_synthetic(RooflineMeasurement, t_serial,
                                          comm), max_degree=16,
                               variants=variants).tune(classes)
    want = JaxShardDegreeAutotuner(_synthetic(JaxRooflineMeasurement,
                                              t_serial, comm),
                                   max_degree=16,
                                   variants=variants).tune(classes)
    assert _decisions(got) == _decisions(want)
    assert got.probes == want.probes
    for c in classes:
        assert got.degree(c) == want.degree(c)
        for d in (1, 2, 3, 4, 6, 8, 12, 16):
            for v in variants:
                assert got.curves[c].predict(d, v) == \
                    want.curves[c].predict(d, v)
    groups = corun_groups(got, [["mlp", "attention"], ["moe"],
                                ["mlp", "attention", "moe"], ["absent"]],
                          axis_size=16)
    jgroups = jax_corun_groups(want, [["mlp", "attention"], ["moe"],
                                      ["mlp", "attention", "moe"],
                                      ["absent"]], axis_size=16)
    assert [dataclasses.astuple(g) for g in groups] == \
        [dataclasses.astuple(g) for g in jgroups]


class TestShardDegreeAutotuner:
    def test_finds_knee(self):
        tuner = ShardDegreeAutotuner(_synthetic(RooflineMeasurement, 1.0,
                                                0.02), max_degree=16)
        assert tuner.tune(["mlp"]).decisions["mlp"].degree == 8

    def test_monotone_curve_picks_max(self):
        tuner = ShardDegreeAutotuner(_synthetic(RooflineMeasurement, 1.0,
                                                0.0), max_degree=16)
        assert tuner.tune(["attention"]).decisions["attention"].degree == 16

    def test_probe_count_bounded(self):
        tuner = ShardDegreeAutotuner(_synthetic(RooflineMeasurement, 1.0,
                                                0.5), max_degree=16)
        assert tuner.tune(["a", "b"]).probes <= 2 * 5

    def test_measurements_cached(self):
        calls = []

        def spy(cls, d, v):
            calls.append((cls, d))
            return _synthetic(RooflineMeasurement, 1.0, 0.02)(cls, d, v)

        tuner = ShardDegreeAutotuner(spy, max_degree=8)
        tuner.tune(["x"])
        tuner.tune(["x"])
        assert len(calls) == len(set(calls))


class TestCorunGroups:
    def test_balances_independent_classes(self):
        tuner = ShardDegreeAutotuner(_synthetic(RooflineMeasurement, 1.0,
                                                0.001), max_degree=16)
        plan = tuner.tune(["attn", "mlp"])
        groups = corun_groups(plan, [["attn", "mlp"]], axis_size=16)
        assert groups
        g = groups[0]
        if len(g.members) == 2:
            assert sum(g.degrees) <= 16
            # co-run makespan beats sequential execution of tuned singles
            seq = sum(plan.decisions[m].predicted.time for m in g.members)
            assert g.makespan < seq


# ---------------------------------------------------------------------------
# the train step and the layers' constraints
# ---------------------------------------------------------------------------

def test_train_step_with_batch_axes_needs_a_placed_state():
    import torch
    from repro_torch.train import init_state, make_train_step
    cfg = get_config("olmo-1b", smoke=True)
    tcfg = TrainConfig()
    step = make_train_step(cfg, tcfg, batch_axes=("data",))
    state = init_state(cfg, tcfg, torch.Generator().manual_seed(0),
                       device="cpu")
    tokens = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="placed on a mesh"):
        step(state, {"tokens": tokens, "targets": tokens})


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "recurrentgemma-2b",
                                  "rwkv6-1.6b", "llama-3.2-vision-11b",
                                  "whisper-small"])
def test_other_families_refuse_a_sharded_batch(arch):
    """No family refuses a sharded batch any more (every family runs on
    DTensors, ``tests/test_torch_multidevice.py``); on plain tensors a
    config that names batch or sequence axes runs as the unsharded one,
    its constraints passing the activations through."""
    import torch
    base = get_config(arch, smoke=True)
    params = zoo.init(base, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, base.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens}
    if zoo.needs_frontend(base):
        batch["frontend"] = torch.randn(2, base.n_frontend_tokens,
                                        base.d_model)
    want, _ = zoo.forward(base, params, batch)
    for axes in ({"batch_axes": ("data",)}, {"seq_axes": ("model",)}):
        cfg = dataclasses.replace(base, **axes)
        got, _ = zoo.forward(cfg, params, batch)
        assert torch.equal(got, want), axes


def test_constraints_pass_plain_tensors_through():
    import torch
    from repro_torch.models import layers
    x = torch.ones(2, 3, 4)
    for axes in (((), ()), (("data",), ()), (("data",), ("model",))):
        assert layers.constrain_batch(x, *axes) is x
        assert layers.seq_boundary(x, *axes) is x
