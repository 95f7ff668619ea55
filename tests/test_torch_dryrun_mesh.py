"""The port's dry-run on meshes (``repro_torch.launch.dryrun`` with a
mesh, ``repro_torch.hw.comm``, the per-rank ``CostCounter``) against the
reference's (``repro.launch.dryrun``, ``repro.hw.hlo``), on the CPU.

Everything runs in this process over torch's fake process group of 512
ranks (no collective runs; this process is rank 0), on "cuda" meshes of
meta tensors, torn down after the module:

* ``CollectiveOp`` of every kind x group sizes {1, 2, 4, 16} x {f32,
  bf16} x block sizes equals, field by field, the reference's
  ``parse_collectives`` of the HLO line with the same result shape and
  group; the collectives are dispatched on groups built here; a
  Shard -> Shard redistribution on a "cuda" mesh counts as all-to-all.
* A hand count of one FSDP/TP linear layer's forward and backward on
  (2, 4): each collective's kind, group and bytes.
* Per-device GEMM flops x 8 on (2, 4) equal the unsharded count for
  olmo-1b and granite-3-8b smoke, train and prefill, with no GEMM run
  replicated; for mixtral-8x7b once the router's repeats are taken off;
  the unsharded train count is itself the reference's ``dot_general``
  flops.
* The vocab-parallel loss on 4 gloo ranks against the reference's
  ``loss_fn`` and its gradient, and the widest tensor it holds.
* The reference's ``test_tiny_dryrun_cell`` as a port test, and a
  (2, 2, 2) pod cell whose gradient reduction crosses the pod boundary.
* ``plan_for_shape`` and each decode cell's ``kv_strategy`` equal the
  reference's over all ten archs, four shapes and both production
  meshes; a mesh record has the reference's keys; ``collective_time``
  is bytes over the named link rates; rows go over the batch axes whose
  ranks divide them.
"""

import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import types

import jax
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCH_IDS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.hw.hlo import parse_collectives
from repro.serving.kvcache import kv_cache_pspec as ref_kv_cache_pspec
from repro_torch.configs import SHAPES, get_config
from repro_torch.hw import H100, H100Spec
from repro_torch.hw import spec as hw_spec
from repro_torch.hw.comm import CollectiveStats
from repro_torch.hw.cost import CostCounter
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (PRODUCTION_MESHES, count_mesh,
                                     dividing_axes)
from repro_torch.models import layers, zoo
from repro_torch.serving import cache_shardings

WORLD = 512
REPO = pathlib.Path(__file__).resolve().parents[1]
REF_DRYRUN = REPO / "src/repro/launch/dryrun.py"
# the reference's dot_general flops of the loss gradient at B=2, S=64,
# float32 smoke configs (held by tests/test_torch_dryrun.py)
REFERENCE_GRAD_FLOPS = {"olmo-1b": 138_674_176, "granite-3-8b": 104_071_168,
                        "mixtral-8x7b": 212_467_712}


@pytest.fixture(scope="module")
def world():
    """A fake process group of 512 ranks, torn down after the module."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ref_dryrun():
    """``repro.launch.dryrun``, whose import sets ``XLA_FLAGS`` to 512 host
    devices: jax's backend is up first and the variable is put back."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as module
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return module


def _mesh(shape, axes):
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh("cuda", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def test_count_mesh_brings_up_its_own_world_and_refuses_another():
    """Run first, before the module's world: ``count_mesh`` brings a fake
    group up and takes it down; inside a group of another size it
    refuses."""
    assert not dist.is_initialized()
    with count_mesh((2, 2), ("data", "model")) as mesh:
        assert dist.get_world_size() == 4 and mesh.size() == 4
        with pytest.raises(RuntimeError, match="needs 8"):
            with count_mesh((2, 4), ("data", "model")):
                pass
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# collectives, op by op, against the reference's HLO parse
# ---------------------------------------------------------------------------

def _dispatch(kind: str, group, n: int, dtype: torch.dtype) -> None:
    """One collective of ``kind`` on a meta (n, n) tensor."""
    import torch.distributed._functional_collectives as funcol
    x = torch.empty(n, n, dtype=dtype, device="meta")
    if kind == "all-gather":
        funcol.all_gather_tensor(x, 0, group)
    elif kind == "reduce-scatter":
        funcol.reduce_scatter_tensor(x, "sum", 0, group)
    elif kind == "all-reduce":
        funcol.all_reduce(x, "sum", group)
    elif kind == "all-to-all":
        funcol.all_to_all_single(x, None, None, group)
    else:                      # DTensor's Shard -> Shard redistribution
        torch.ops._dtensor.shard_dim_alltoall(x, 0, 1, group.group_name)


def _result_shape(kind: str, n: int, g: int) -> tuple[int, int]:
    return {"all-gather": (n * g, n), "reduce-scatter": (n // g, n),
            "shard-dim-alltoall": (n * g, n // g)}.get(kind, (n, n))


HLO_KIND = {"all-gather": "all-gather", "reduce-scatter": "reduce-scatter",
            "all-reduce": "all-reduce", "all-to-all": "all-to-all",
            "shard-dim-alltoall": "all-to-all"}


@pytest.mark.parametrize("kind", sorted(HLO_KIND))
def test_collective_ops_equal_the_reference_parse(world, kind):
    rows = 0
    for g in (1, 2, 4, 16):
        for stride in (1, 16, 32):
            ranks = [i * stride for i in range(g)]
            group = dist.new_group(ranks)
            for dtype, hlo_dt in ((torch.float32, "f32"),
                                  (torch.bfloat16, "bf16")):
                for pod in (None, 8, 256):
                    with CostCounter(pod_size=pod) as c:
                        _dispatch(kind, group, 32, dtype)
                    assert len(c.collectives) == 1, c.collectives
                    assert list(c.collective_groups[0]) == ranks
                    dims = ",".join(map(str, _result_shape(kind, 32, g)))
                    line = (f"  %op.1 = {hlo_dt}[{dims}]{{1,0}} "
                            f"{HLO_KIND[kind]}({hlo_dt}[32,32]{{1,0}} %p), "
                            "channel_id=1, replica_groups={{"
                            + ",".join(map(str, ranks)) + "}}")
                    ref = parse_collectives(line, pod_size=pod).ops
                    assert len(ref) == 1
                    assert dataclasses.asdict(c.collectives[0]) == \
                        dataclasses.asdict(ref[0]), (kind, g, stride, pod)
                    rows += 1
    assert rows == 4 * 3 * 2 * 3


def test_shard_to_shard_on_a_cuda_mesh_counts_as_all_to_all(world):
    """On a "cuda" mesh DTensor moves a Shard(0) -> Shard(1)
    redistribution by ``_dtensor.shard_dim_alltoall`` (a CPU mesh falls
    back to all-gather and chunk): one all-to-all over the data group."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = _mesh((2, 4), ("data", "model"))
    x = distribute_tensor(torch.empty(8, 16, device="meta"), mesh,
                          (Shard(0), Replicate()), src_data_rank=None)
    with CostCounter(pod_size=8) as c:
        y = x.redistribute(mesh, (Shard(1), Replicate()))
    assert [(op.kind, g) for op, g in zip(c.collectives,
                                          c.collective_groups)] == \
        [("all-to-all", (0, 4))]
    assert tuple(y.to_local().shape) == (8, 8)
    assert c.collectives[0].full_bytes == 8 * 8 * 4


def test_unmapped_collectives_raise(world):
    import torch.distributed._functional_collectives as funcol
    group = dist.new_group([0, 1])
    x = torch.empty(4, 4, device="meta")
    with pytest.raises(NotImplementedError, match="not mapped"):
        with CostCounter():
            funcol.all_gather_into_tensor_coalesced([x], group)


def test_stats_sum_as_the_reference(world):
    group = dist.new_group(list(range(16)))
    with CostCounter(pod_size=8) as c:
        for kind in ("all-gather", "reduce-scatter", "all-reduce"):
            _dispatch(kind, group, 32, torch.bfloat16)
    lines = "\n".join(
        f"  %op.{i} = bf16[{','.join(map(str, _result_shape(k, 32, 16)))}]"
        f"{{1,0}} {k}(bf16[32,32] %p), replica_groups={{{{"
        + ",".join(map(str, range(16))) + "}}"
        for i, k in enumerate(("all-gather", "reduce-scatter",
                               "all-reduce")))
    ref = parse_collectives(lines, pod_size=8)
    got = c.collective_stats()
    assert isinstance(got, CollectiveStats)
    assert (got.raw_operand_bytes, got.ici_link_bytes, got.dci_link_bytes,
            got.by_kind(), got.summary()) == \
        (ref.raw_operand_bytes, ref.ici_link_bytes, ref.dci_link_bytes,
         ref.by_kind(), ref.summary())


# ---------------------------------------------------------------------------
# a hand count: one FSDP/TP linear layer on (2, 4)
# ---------------------------------------------------------------------------

def test_linear_layer_collectives_by_hand(world):
    """y = x @ W, x (B, S, D) split over "data", W (D, F) split over
    "data" (FSDP) and "model" (TP), y's gradient split as y.  Forward:
    W's D gathered over the data group [0, 4], the rank's (D, F/4) fp32.
    Backward: W's gradient x^T dy is a partial sum over the data group;
    redistributed to W's placements, as the train step does
    (``trainer._like_param``), it is reduced and scattered to W's (D/2,
    F/4) slice.  Nothing runs on the model group [0, 1, 2, 3]; with
    blocks of 4 ranks the data group crosses them."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    b, s, d, f = 4, 16, 64, 32
    mesh = _mesh((2, 4), ("data", "model"))

    def place(shape, placements):
        return distribute_tensor(torch.empty(shape, device="meta"), mesh,
                                 placements, src_data_rank=None)

    x = place((b, s, d), (Shard(0), Replicate()))
    w = place((d, f), (Shard(0), Shard(1))).requires_grad_(True)
    dy = place((b, s, f), (Shard(0), Shard(2)))
    with CostCounter(pod_size=4) as c:
        y = x @ w
        y.backward(dy)
        grad = w.grad.redistribute(mesh, w.placements)
    got = [(op.kind, grp, op.full_bytes, op.crosses_pod)
           for op, grp in zip(c.collectives, c.collective_groups)]
    # the gathered (D, F/4) and the reduce-scatter's full (D, F/4): 4 B
    assert got == [("all-gather", (0, 4), d * f // 4 * 4, True),
                   ("reduce-scatter", (0, 4), d * f // 4 * 4, True)], got
    assert tuple(grad.to_local().shape) == (d // 2, f // 4)
    # one rank's GEMMs: (B/2 S, D) @ (D, F/4) forward, (D, B/2 S) @
    # (B/2 S, F/4) for the gradient
    rows = b // 2 * s
    assert sum(c.matmul_flops.values()) == 2 * (2 * rows * d * (f // 4))


# ---------------------------------------------------------------------------
# per-device GEMM flops x devices = the unsharded count
# ---------------------------------------------------------------------------

def _routing_flops(counter_flops: list):
    """Wrap ``layers._moe_routing`` so that the GEMM flops run inside it
    (the router, on each rank's rows) add to ``counter_flops``."""
    orig = layers._moe_routing

    def spy(*args, **kw):
        with CostCounter() as inner:
            out = orig(*args, **kw)
        counter_flops.append(sum(inner.matmul_flops.values()))
        return out
    return orig, spy


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["olmo-1b", "granite-3-8b", "mixtral-8x7b"])
def test_per_device_gemm_flops_times_devices_equal_unsharded(
        world, arch, kind, monkeypatch):
    """B=2, S=64, float32 smoke, one microbatch, no remat.  Every GEMM of
    a block, the unembedding and the loss runs with the plan's placements
    (``layers.tp_matmul``, the MoE block's expert products, the
    vocab-parallel loss), so no rank repeats one: ``CostCounter.replicated``
    is empty and each rank's GEMM flops x 8 equal the unsharded count
    exactly.  The one repeat left is mixtral-8x7b's router, which runs on
    each rank's rows inside the MoE routing (``layers._moe_routing``),
    whole on every "model" rank as GSPMD runs it, and in training its
    gradient's GEMMs; its repeats are taken off.  granite-3-8b's 2 kv
    heads on a model axis of 4 split its k and v projections by columns
    (half a head a rank), gathered before attention.

    A train cell's unsharded count is the reference's ``dot_general``
    flops of the loss gradient (flash's backward recomputes the dense
    attention's GEMMs), and no op on a ``FakeTensor`` (DTensor's
    sharding propagation on global shapes) is counted."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    shape = (SHAPES["train_4k"] if kind == "train"
             else SHAPES["prefill_32k"]).scaled(seq=64, batch=2)
    tcfg = dryrun.TrainConfig(microbatches=1, remat=False)
    one = dryrun.count_step(cfg, shape, tcfg=tcfg)[0]
    unsharded = sum(one.matmul_flops.values())
    if kind == "train":
        assert unsharded == REFERENCE_GRAD_FLOPS[arch]
    mesh = _mesh((2, 4), ("data", "model"))
    plan = dryrun.plan_for_shape(cfg, shape, mesh)
    scfg = dataclasses.replace(cfg, batch_axes=tuple(plan.batch_axes),
                               seq_axes=tuple(plan.seq_axes))
    routing: list = []
    _, spy = _routing_flops(routing)
    monkeypatch.setattr(layers, "_moe_routing", spy)
    counter = dryrun.count_step(scfg, shape, mesh, plan=plan, tcfg=tcfg)[0]
    per_device = sum(counter.matmul_flops.values())
    assert counter.replicated == []
    repeats = 0.0
    if arch == "mixtral-8x7b":
        # the router: every rank's rows, each "model" rank the same; in
        # training also its two gradient GEMMs (x's and the weight's),
        # each of the forward's flops
        assert routing and all(f > 0 for f in routing)
        passes = 3 if kind == "train" else 1
        repeats = 8 * passes * sum(routing) * (1 - 1 / 4)
    else:
        assert not routing
    assert per_device * 8 - repeats == unsharded
    # DTensor's propagation ran on global shapes and was not counted:
    # the rank's count is less than the unsharded one
    assert per_device < unsharded


# ---------------------------------------------------------------------------
# the reference's tiny dry-run cell, and a pod cell
# ---------------------------------------------------------------------------

def test_tiny_dryrun_cell(world):
    """The reference's ``test_tiny_dryrun_cell``: olmo-1b smoke in bf16,
    train_4k at S=128, B=8, on a (2, 4) mesh: it fits, counts flops and
    a step, and every group stays inside one 8-GPU node."""
    cfg = dataclasses.replace(get_config("olmo-1b", smoke=True),
                              dtype="bfloat16")
    shape = SHAPES["train_4k"].scaled(seq=128, batch=8)
    rec = dryrun.measure_cell(cfg, shape, _mesh((2, 4), ("data", "model")),
                              mesh_name="single")
    assert rec["fits_hbm"]
    assert rec["flops_per_device"] > 0
    r = rec["roofline"]
    assert r["step_s_overlapped"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")
    coll = rec["collectives"]
    assert coll["dci_link_bytes"] == coll["dci_link_bytes_step"] == 0
    assert coll["ici_link_bytes_step"] > coll["ici_link_bytes"] > 0
    assert r["collective_s"] == H100.collective_time(
        coll["ici_link_bytes_step"], 0.0)
    assert rec["mesh"] == "2x4" and rec["devices"] == 8
    assert rec["hlo_flops_global"] == 8 * rec["flops_per_device"]


# the reference's tiny cell, counted by its ``measure_cell`` in a process
# with 8 forced host devices; its record's collectives and flops
REF_TINY_CELL = """
import dataclasses, json
from repro.configs import SHAPES, get_config
from repro.launch.dryrun import measure_cell
from repro.launch.mesh import make_mesh
cfg = dataclasses.replace(get_config("olmo-1b", smoke=True), dtype="bfloat16")
rec = measure_cell(cfg, SHAPES["train_4k"].scaled(seq=128, batch=8),
                   make_mesh((2, 4), ("data", "model")), mesh_name="single")
print(json.dumps({"collectives": rec["collectives"],
                  "flops_per_device": rec["flops_per_device"]}))
"""
# the port's count of the cell when DTensor chose each op's placement
# (PERF.md, the mesh dry-run's findings): link bytes a step and flops a
# device
TINY_CELL_BEFORE = (15_684_658, 3.870e8)


@pytest.fixture(scope="module")
def ref_tiny_cell():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REF_TINY_CELL)],
        capture_output=True, text=True, env=env, timeout=300,
        stdin=subprocess.DEVNULL)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


def test_tiny_cell_against_the_reference(world, ref_tiny_cell):
    """The reference's tiny cell beside the port's count of it: with
    every GEMM placed as the plan places it, the port moves at most half
    the link bytes a step it moved when DTensor chose (15,684,658) and
    does fewer flops a device (3.870e8); each collective kind it counts
    is one the reference's HLO has, or the reduce-scatter of the FSDP
    weight gradients (the reference all-reduces its partial sums).  Both
    records go to ``PERF.md``."""
    cfg = dataclasses.replace(get_config("olmo-1b", smoke=True),
                              dtype="bfloat16")
    rec = dryrun.measure_cell(cfg, SHAPES["train_4k"].scaled(seq=128, batch=8),
                              _mesh((2, 4), ("data", "model")),
                              mesh_name="single")
    mine, ref = rec["collectives"], ref_tiny_cell["collectives"]
    assert ref["ici_link_bytes_step"] == 2_712_566
    assert mine["ici_link_bytes_step"] <= TINY_CELL_BEFORE[0] / 2, mine
    assert rec["flops_per_device"] < TINY_CELL_BEFORE[1], rec
    assert set(mine["by_kind"]) <= set(ref["by_kind"]) | {"reduce-scatter"}
    # FSDP's weight gathers: as many as the reference's
    assert mine["by_kind"]["all-gather"]["count"] == \
        ref["by_kind"]["all-gather"]["count"]


def test_pod_cell_reduces_gradients_across_the_pod_axis(world):
    """(2, 2, 2) ("pod", "data", "model") counted against 4-GPU nodes:
    the pod groups ([0, 4]) cross nodes and carry the gradient
    reduction; the model and data groups stay inside a node."""
    cfg = dataclasses.replace(get_config("olmo-1b", smoke=True),
                              dtype="bfloat16")
    shape = SHAPES["train_4k"].scaled(seq=64, batch=8)
    mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
    plan = dryrun.plan_for_shape(cfg, shape, mesh)
    assert plan.batch_axes == ("pod", "data")
    scfg = dataclasses.replace(cfg, batch_axes=tuple(plan.batch_axes))
    counter = dryrun.count_step(
        scfg, shape, mesh, plan=plan,
        tcfg=dryrun.TrainConfig(microbatches=1),
        pod_size=H100Spec(gpus_per_node=4).gpus_per_node)[0]
    stats = counter.collective_stats()
    assert stats.dci_link_bytes > 0
    crossing = {g for op, g in zip(counter.collectives,
                                   counter.collective_groups)
                if op.crosses_pod}
    inside = {g for op, g in zip(counter.collectives,
                                 counter.collective_groups)
              if not op.crosses_pod}
    assert crossing == {(0, 4)}, crossing
    assert (0, 1) in inside            # the model axis
    assert {op.kind for op in counter.collectives if op.crosses_pod} \
        <= {"all-reduce", "reduce-scatter", "all-gather"}
    assert any(op.kind in ("all-reduce", "reduce-scatter")
               for op in counter.collectives if op.crosses_pod)


# ---------------------------------------------------------------------------
# plans, strategies, record keys, link rates
# ---------------------------------------------------------------------------

def _ref_mesh(name: str):
    shape, axes = PRODUCTION_MESHES[name]
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes)


def _plan_tuple(plan) -> tuple:
    return ({k: tuple(v) for k, v in plan.rules.items()},
            tuple(plan.batch_axes), tuple(plan.seq_axes))


def test_plans_and_kv_strategies_equal_the_reference(world, ref_dryrun):
    n = 0
    for name, (mshape, axes) in PRODUCTION_MESHES.items():
        mesh = _mesh(mshape, axes)
        for arch in ARCH_IDS:
            cfg, ref_cfg = get_config(arch), ref_get_config(arch)
            for sname, shape in SHAPES.items():
                plan = dryrun.plan_for_shape(cfg, shape, mesh)
                ref = ref_dryrun.plan_for_shape(ref_cfg, REF_SHAPES[sname],
                                                _ref_mesh(name))
                assert _plan_tuple(plan) == _plan_tuple(ref), \
                    (name, arch, sname)
                n += 1
                if shape.kind != "decode":
                    continue
                want = ref_kv_cache_pspec(
                    dataclasses.replace(
                        ref_cfg, batch_axes=tuple(ref.batch_axes)), ref,
                    model_degree=dict(zip(axes, mshape))["model"])[1]
                cache = zoo.abstract_cache(cfg, shape.global_batch,
                                           zoo.cache_max_len(cfg,
                                                             shape.seq_len))
                got = cache_shardings(
                    dataclasses.replace(cfg, batch_axes=tuple(
                        plan.batch_axes)), plan, mesh, cache,
                    model_degree=dict(zip(axes, mshape))["model"])[1]
                assert got == want, (name, arch, sname)
    assert n == 2 * 10 * 4


def _reference_record_keys() -> set[str]:
    """The keys ``lower_cell`` and ``measure_cell`` of the reference put in
    a record, read from its source."""
    tree = ast.parse(REF_DRYRUN.read_text())
    keys = set()
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name in ("lower_cell", "measure_cell")):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for target in node.targets:
                    if isinstance(target, ast.Name) and \
                            target.id == "record" and \
                            isinstance(node.value, ast.Dict):
                        keys |= {k.value for k in node.value.keys}
                    if isinstance(target, ast.Subscript) and \
                            isinstance(target.value, ast.Name) and \
                            target.value.id in ("record", "rec") and \
                            isinstance(target.slice, ast.Constant):
                        keys.add(target.slice.value)
    return keys


def test_mesh_record_has_the_reference_keys(world):
    ref_keys = _reference_record_keys()
    cfg = get_config("olmo-1b", smoke=True)
    mesh = _mesh((2, 4), ("data", "model"))
    decode = dryrun.measure_cell(cfg, SHAPES["decode_32k"].scaled(
        seq=64, batch=4), mesh, mesh_name="single")
    # set only for the text-size option and for extrapolation
    assert ref_keys - {"hlo_lines", "cost_extrapolated_from",
                       "optimizer_cost"} <= set(decode)
    assert decode["kv_strategy"] == "head-sharded"
    assert set(decode["collectives"]) == {
        "full_tensor_bytes", "ici_link_bytes", "dci_link_bytes", "by_kind",
        "ici_link_bytes_step", "dci_link_bytes_step"}
    train = dryrun.measure_cell(cfg, SHAPES["train_4k"].scaled(
        seq=64, batch=8), mesh, mesh_name="single")
    assert ref_keys - {"hlo_lines", "cost_extrapolated_from",
                       "kv_strategy"} <= set(train)
    assert set(train["optimizer_cost"]) == {"flops_by_dtype", "bytes",
                                            "ici", "dci"}


def test_rows_go_over_the_batch_axes_that_divide_them(world):
    """A llama3-405b microbatch of 16 rows on 2x16x16 goes over "data"
    alone (DTensor cannot reshape an uneven split): the train step, the
    layers' pins and the dry-run's placed batch take the same axes."""
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    mesh = _mesh((2, 16, 16), ("pod", "data", "model"))
    axes = ("pod", "data")
    assert dividing_axes(32, mesh, axes) == axes
    assert dividing_axes(16, mesh, axes) == ("data",)
    assert dividing_axes(8, mesh, axes) == ("pod",)
    assert dividing_axes(1, mesh, axes) == ()
    x = distribute_tensor(torch.empty(16, 8, device="meta"), mesh,
                          (Replicate(),) * 3, src_data_rank=None)
    assert layers.constrain_batch(x, axes).placements == (
        Replicate(), Shard(0), Replicate())


def test_collective_time_is_bytes_over_the_link_rates():
    assert hw_spec.H100_NVLINK_BYTES_PER_S == 450e9
    assert hw_spec.H100_NETWORK_BYTES_PER_S == 50e9
    assert H100.gpus_per_node == 8
    assert H100.collective_time(450e9, 0.0) == 1.0
    assert H100.collective_time(0.0, 50e9) == 1.0
    assert H100.collective_time(9e9, 1e9) == 9e9 / 450e9 + 1e9 / 50e9
    assert H100.collective_time(0.0, 0.0) == 0.0
