"""Dry-run of every (arch x shape) cell on one H100, counted on the
``meta`` device:

    python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --device cpu

The port's counterpart of ``repro.launch.dryrun``, with its surface and
record keys.  Where the reference lowers and compiles each cell with XLA
and reads ``cost_analysis`` and ``memory_analysis``, the port runs the
cell's step (a train step, a prefill or a decode step) on meta tensors
under ``hw.cost.CostCounter``: nothing is allocated or computed, and the
count follows the card's path (flash for self-attention, the recurrences'
kernels by their ``cost``, and in training the plain versions' backward
that ``KernelFn`` recomputes).  The record gives the step's flops by peak
class, its bytes, its peak of live memory and the three roofline terms
against ``hw.spec.H100Spec``.  Serving cells count the params as the card
serves them: matrices cast once to the activation dtype
(``cast_matrices``).

Train cells are counted as the reference costs them: one microbatch at
B/m, then ``reconstruct_train_cost`` (m x (one microbatch - optimizer) +
optimizer).  The peak of a step of m microbatches is that of one (each
microbatch's activations are freed before the next), plus the rest of
the batch.  ``--extrapolate`` counts at the two depths of ``depth_plan``
and extrapolates flops, bytes and the peak linearly to the full depth.

On a mesh (``--mesh single``: the reference's 16x16, ``multi``: 2x16x16,
``both``) the same step runs on DTensors over a fake process group of
the mesh's size (``launch.mesh.count_mesh``: a "cuda" mesh, so DTensor
makes the card's choices), this process being rank 0: the state, or the
params and the decode cache, are placed by ``plan_for_shape``'s plan
outside the count, as the reference's ``in_shardings``, and the counter
counts what one rank runs (its local ops, its kernels on local shapes,
its local storages) and every collective it dispatches
(``hw.comm``), ``ici`` inside an 8-GPU NVLink node and ``dci`` across
nodes (``H100Spec.gpus_per_node``), priced by ``H100Spec.collective_time``.
The default ``--mesh h100x1`` is one card: no mesh, every collective
term 0.

    python -m repro_torch.launch.dryrun --mesh single --arch olmo-1b --shape train_4k --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeSpec, get_config,
                                 skip_reason)
from repro_torch.hw import H100, H100Spec, dominant_term
from repro_torch.hw.cost import (CostCounter, addressed_bytes, local_tensor,
                                 tensor_leaves)
from repro_torch.launch.mesh import (PRODUCTION_MESHES, count_mesh,
                                     dividing_axes, mesh_sizes)
from repro_torch.models import zoo
from repro_torch.models.common import (ModelConfig, ShardingPlan,
                                       cast_matrices, default_plan,
                                       torch_dtype, tree_map)
from repro_torch.optim import AdamWConfig, abstract_opt_state, adamw_update
from repro_torch.serving.kvcache import cache_shardings
from repro_torch.sharding import (NamedSharding, distribute_tree,
                                  named_sharding_tree, place_cache,
                                  placements_for)
from repro_torch.train import (TrainConfig, abstract_state, make_prefill_step,
                               make_serve_step, make_train_step, state_specs)

MESH = "h100x1"

# own copy of the reference's per-arch train configs (the memory-term
# decisions of its perf pass), equal field by field
TRAIN_CFGS: dict[str, TrainConfig] = {
    "llama3-405b": TrainConfig(
        microbatches=16, remat=True, remat_policy="nothing",
        accum_dtype="bfloat16",
        optimizer=AdamWConfig(moment_dtype="bfloat16")),
    "llama4-scout-17b-a16e": TrainConfig(
        microbatches=8, remat=True, remat_policy="nothing",
        accum_dtype="bfloat16",
        optimizer=AdamWConfig(moment_dtype="bfloat16")),
    "mixtral-8x7b": TrainConfig(
        microbatches=8, remat=True, remat_policy="nothing",
        optimizer=AdamWConfig(moment_dtype="bfloat16")),
    "granite-3-8b": TrainConfig(microbatches=4, remat=True,
                                remat_policy="nothing"),
    "codeqwen1.5-7b": TrainConfig(microbatches=4, remat=True,
                                  remat_policy="nothing"),
    "llama-3.2-vision-11b": TrainConfig(microbatches=8, remat=True,
                                        remat_policy="nothing"),
    "olmo-1b": TrainConfig(microbatches=2, remat=True, remat_policy="dots"),
    "rwkv6-1.6b": TrainConfig(microbatches=2, remat=True,
                              remat_policy="nothing"),
    "recurrentgemma-2b": TrainConfig(microbatches=2, remat=True,
                                     remat_policy="nothing"),
    "whisper-small": TrainConfig(microbatches=2, remat=True,
                                 remat_policy="dots"),
}


def train_config_for(arch: str) -> TrainConfig:
    return TRAIN_CFGS.get(arch, TrainConfig(microbatches=4))


# ---------------------------------------------------------------------------
# input specs (meta tensors; no allocation)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta tensors of the global shape for every model input of this
    cell; int64 token ids, as the port's launchers feed them.  Decode's
    ``pos`` is the newest position, a Python int."""
    gb, s = shape.global_batch, shape.seq_len

    def ids(*dims):
        return torch.empty(dims, dtype=torch.int64, device="meta")

    if shape.kind == "train":
        out = {"tokens": ids(gb, s), "targets": ids(gb, s)}
    elif shape.kind == "prefill":
        out = {"tokens": ids(gb, s)}
    else:                                  # decode: one new token
        out = {"token": ids(gb), "pos": s - 1}
    if zoo.needs_frontend(cfg) and shape.kind != "decode":
        # decode reads the frontend through the prefilled cross-kv cache
        out["frontend"] = torch.empty(
            (gb, cfg.n_frontend_tokens, cfg.d_model),
            dtype=cfg.activation_dtype, device="meta")
    return out


def serving_params(cfg: ModelConfig) -> dict:
    """The params as the card serves them, on meta."""
    return cast_matrices(zoo.abstract(cfg), cfg.activation_dtype)


def plan_for_shape(cfg: ModelConfig, shape: ShapeSpec,
                   mesh) -> ShardingPlan:
    """The reference's plan for a cell on ``mesh``: ``default_plan``
    adapted to the cell's batch.  long_500k (batch 1) cannot batch-shard,
    so the data axis joins the kv/sequence sharding group instead of
    idling."""
    plan = default_plan()
    # sequence parallelism for deep*wide models (train): layer-boundary
    # carries otherwise exceed the memory
    if shape.kind == "train" and cfg.d_model >= 8192:
        plan.seq_axes = ("model",)
    # expert parallelism requires experts % axis == 0 (mixtral E=8 on a
    # 16-wide axis): fall back to TP inside the expert FFN
    sizes = mesh_sizes(mesh)
    model_size = sizes.get("model", 1)
    if cfg.moe_experts and cfg.moe_experts % model_size:
        plan.rules["expert"] = ()
    axes = set(sizes)
    if "pod" in axes:
        # pod axis extends data parallelism (gradient reduction crosses it)
        plan.batch_axes = ("pod", "data")
        plan.rules["embed"] = ("data",)     # FSDP stays in-pod
    if shape.global_batch < sizes.get("data", 1):
        plan.batch_axes = tuple(a for a in plan.batch_axes if a != "data"
                                and a != "pod")
        plan.rules["kv"] = tuple(
            a for a in ("pod", "data", "model") if a in axes)
    return plan


def _batch_shardings(cfg: ModelConfig, shape: ShapeSpec, plan: ShardingPlan,
                     mesh, specs: dict) -> dict:
    """A ``NamedSharding`` a batch tensor: its dim 0 over the plan's batch
    axes (those whose ranks divide its rows, ``launch.mesh.dividing_axes``,
    as the train step shards them), the rest whole (a non-tensor,
    decode's ``pos``, has none)."""
    def spec(v):
        batch = dividing_axes(v.shape[0], mesh, tuple(plan.batch_axes))
        return ((batch or None,) + (None,) * (v.ndim - 1))
    return {k: NamedSharding(mesh, placements_for(spec(v), mesh))
            for k, v in specs.items() if isinstance(v, torch.Tensor)}


def _place_batch(specs: dict, shardings: dict) -> dict:
    from torch.distributed.tensor import distribute_tensor
    return {k: distribute_tensor(v, shardings[k].mesh,
                                 shardings[k].placements, src_data_rank=None)
            if k in shardings else v for k, v in specs.items()}


# ---------------------------------------------------------------------------
# counting one cell
# ---------------------------------------------------------------------------

def _tree_bytes(tree) -> int:
    """The bytes of a tree's tensors on this rank (a DTensor's local
    tensor)."""
    return sum(addressed_bytes(local_tensor(t)) for t in tensor_leaves(tree))


def count_step(cfg: ModelConfig, shape: ShapeSpec, mesh=None, *,
               plan: ShardingPlan | None = None,
               tcfg: TrainConfig | None = None,
               pod_size: int | None = None
               ) -> tuple[CostCounter, int] | tuple[CostCounter, int, str]:
    """Run one step of the cell on meta under a counter.  Returns the
    counter and the bytes of the step's arguments (state or params and
    cache, and the batch), and on a mesh also the decode cache's
    strategy (None for other cells).

    On ``mesh`` the arguments are placed by ``plan`` (the state by
    ``state_specs``, serving params by ``zoo.specs``, the decode cache by
    ``cache_shardings``, the batch's rows over the plan's batch axes)
    before the count, and ``cfg`` should carry the plan's
    ``batch_axes``/``seq_axes`` (``lower_cell`` sets them).  A serving
    step's logits stay as placed (``placed_logits``): the reference's
    jitted steps leave their output sharding to the compiler, so its HLO
    gathers no logits."""
    specs = input_specs(cfg, shape)
    strategy = None
    if mesh is not None:
        specs = _place_batch(specs, _batch_shardings(cfg, shape, plan, mesh,
                                                     specs))
    if shape.kind == "train":
        tcfg = tcfg or train_config_for(cfg.arch_id)
        state = abstract_state(cfg, tcfg)
        if mesh is not None:
            state = distribute_tree(state, named_sharding_tree(
                plan, mesh, state_specs(cfg, tcfg)))
        step = make_train_step(cfg, tcfg, batch_axes=(
            tuple(plan.batch_axes) or None) if mesh is not None else None)
        args = (state, specs)
        with CostCounter(*args, pod_size=pod_size) as counter:
            step(state, specs)
    elif shape.kind == "prefill":
        max_len = zoo.cache_max_len(cfg, shape.seq_len)
        params = serving_params(cfg)
        if mesh is not None:
            params = distribute_tree(params, named_sharding_tree(
                plan, mesh, zoo.specs(cfg)))
        args = (params, specs)
        step = make_prefill_step(cfg, max_len, placed_logits=True)
        with CostCounter(*args, pod_size=pod_size) as counter:
            step(params, specs)
    else:
        max_len = zoo.cache_max_len(cfg, shape.seq_len)
        params = serving_params(cfg)
        cache = zoo.abstract_cache(cfg, shape.global_batch, max_len)
        cache["len"] = max_len - 1       # a full cache, the newest slot last
        if mesh is not None:
            params = distribute_tree(params, named_sharding_tree(
                plan, mesh, zoo.specs(cfg)))
            c_sh, strategy = cache_shardings(
                cfg, plan, mesh, cache,
                model_degree=mesh_sizes(mesh).get("model", 1))
            cache = place_cache(cache, c_sh)
        args = (params, cache, specs["token"])
        step = make_serve_step(cfg, placed_logits=True)
        with CostCounter(*args, pod_size=pod_size) as counter:
            step(params, cache, specs["token"], specs["pos"])
    if mesh is None:
        return counter, _tree_bytes(args)
    return counter, _tree_bytes(args), strategy


def _counts(counter: CostCounter, arg_bytes: int) -> dict:
    stats = counter.collective_stats()
    return {"flops_by_dtype": dict(counter.flops),
            "matmul_flops_by_dtype": dict(counter.matmul_flops),
            "kernels": {k: dict(v) for k, v in counter.kernels.items()},
            "bytes_per_device": float(counter.bytes),
            "peak_bytes": int(counter.peak), "argument_bytes": arg_bytes,
            "replicated_gemms": len(counter.replicated),
            "collectives": {
                "full_tensor_bytes": stats.raw_operand_bytes,
                "ici_link_bytes": stats.ici_link_bytes,
                "dci_link_bytes": stats.dci_link_bytes,
                "by_kind": {k: {"count": c, "link_bytes": b}
                            for k, (c, b) in stats.by_kind().items()}}}


def mesh_label(mesh) -> str:
    """"16x16", "2x16x16"; the one card's ``h100x1``."""
    return MESH if mesh is None else "x".join(str(n) for n in mesh.shape)


def lower_cell(cfg: ModelConfig, shape: ShapeSpec, mesh=None, *,
               plan: ShardingPlan | None = None,
               tcfg: TrainConfig | None = None,
               micro_override: int | None = None,
               spec: H100Spec = H100) -> dict:
    """Count one (arch x shape) cell on meta, on one card or on ``mesh``
    (one rank's share, under ``plan``, by default ``plan_for_shape``'s);
    return its record (the reference's keys).  ``micro_override`` forces
    the microbatch count (cost counts use 1 and reconstruct)."""
    t0 = time.time()
    tcfg = tcfg or train_config_for(cfg.arch_id)
    if micro_override is not None:
        tcfg = dataclasses.replace(tcfg, microbatches=micro_override)
    strategy = "single-device"
    if mesh is None:
        counter, arg_bytes = count_step(cfg, shape, tcfg=tcfg)
    else:
        plan = plan or plan_for_shape(cfg, shape, mesh)
        cfg = dataclasses.replace(cfg, batch_axes=tuple(plan.batch_axes),
                                  seq_axes=tuple(plan.seq_axes))
        counter, arg_bytes, strategy = count_step(
            cfg, shape, mesh, plan=plan, tcfg=tcfg,
            pod_size=spec.gpus_per_node)
    return _record(cfg, shape, tcfg.microbatches, _counts(counter, arg_bytes),
                   time.time() - t0, spec, mesh, strategy)


def _record(cfg: ModelConfig, shape: ShapeSpec, microbatches: int,
            counts: dict, seconds: float, spec: H100Spec, mesh=None,
            strategy: str | None = None) -> dict:
    record = {
        "arch": cfg.arch_id, "shape": shape.name, "kind": shape.kind,
        "unrolled": True,          # a Python loop: every layer is counted
        "microbatches": microbatches if shape.kind == "train" else 0,
        "mesh": mesh_label(mesh),
        "devices": 1 if mesh is None else mesh.size(), **counts,
        "compile_seconds": seconds,
    }
    _finish(record, cfg, shape, spec)
    if shape.kind == "decode":
        record["kv_strategy"] = strategy
    return record


def _finish(rec: dict, cfg: ModelConfig, shape: ShapeSpec,
            spec: H100Spec) -> None:
    """The totals, the memory analysis and the roofline of a record from
    its counts (the collective term from the step's link bytes once
    ``measure_cell`` has reconstructed them)."""
    flops = sum(rec["flops_by_dtype"].values())
    rec["flops_per_device"] = flops
    rec["memory_analysis"] = {
        "argument_size_in_bytes": rec["argument_bytes"],
        "temp_size_in_bytes": rec["peak_bytes"] - rec["argument_bytes"],
        "output_size_in_bytes": 0, "alias_size_in_bytes": 0}
    coll = rec["collectives"]
    compute_s = spec.compute_time(rec["flops_by_dtype"])
    memory_s = spec.memory_time(rec["bytes_per_device"])
    collective_s = spec.collective_time(
        coll.get("ici_link_bytes_step", coll["ici_link_bytes"]),
        coll.get("dci_link_bytes_step", coll["dci_link_bytes"]))
    rec["roofline"] = {
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant_term(compute_s, memory_s, collective_s),
        "step_s_overlapped": max(compute_s, memory_s, collective_s)}
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    model_flops = ((6 if shape.kind == "train" else 2)
                   * cfg.active_param_count() * tokens)
    rec["model_flops_global"] = model_flops
    rec["hlo_flops_global"] = flops * rec["devices"]
    rec["useful_flops_ratio"] = (model_flops / rec["hlo_flops_global"]
                                 if flops else None)


# ---------------------------------------------------------------------------
# cost reconstruction: COST = m * (C_m1 - C_opt) + C_opt
# ---------------------------------------------------------------------------

def optimizer_cost(cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                   plan: ShardingPlan | None = None,
                   spec: H100Spec = H100) -> dict:
    """Count the AdamW update alone, to separate the per-step optimizer
    cost from the per-microbatch cost; on ``mesh`` one rank's share,
    params, moments and gradients placed by ``plan``."""
    params = zoo.abstract(cfg)
    opt = abstract_opt_state(tcfg.optimizer, params)
    acc_dt = torch_dtype(tcfg.accum_dtype)
    grads = tree_map(lambda _, p: torch.empty(p.shape, dtype=acc_dt,
                                              device="meta"), params)
    ctx = contextlib.nullcontext()
    if mesh is not None:
        from torch.distributed.tensor.experimental import \
            implicit_replication
        p_sh = named_sharding_tree(plan, mesh, zoo.specs(cfg))
        params, grads = (distribute_tree(t, p_sh) for t in (params, grads))
        opt = distribute_tree(opt, named_sharding_tree(
            plan, mesh, state_specs(cfg, tcfg)["opt"]))
        ctx = implicit_replication()
    with CostCounter(params, opt, grads,
                     pod_size=spec.gpus_per_node) as counter, ctx:
        adamw_update(tcfg.optimizer, grads, opt, params)
    stats = counter.collective_stats()
    return {"flops_by_dtype": dict(counter.flops),
            "bytes": float(counter.bytes),
            "ici": stats.ici_link_bytes, "dci": stats.dci_link_bytes}


def _scaled(c1: dict, opt: dict, m: int) -> dict:
    return {c: m * max(c1.get(c, 0.0) - opt.get(c, 0.0), 0.0)
            + opt.get(c, 0.0) for c in {*c1, *opt}}


def reconstruct_train_cost(c1: dict, opt: dict, m: int) -> dict:
    """Combine the one-microbatch count with the optimizer-only count:
    per-step = m * (C_m1 - C_opt) + C_opt (clamped at C_m1), for the
    flops of each class, the bytes and the link bytes."""
    def line(x, o):
        return m * max(x - o, 0.0) + o
    return {"flops_by_dtype": _scaled(c1["flops_by_dtype"],
                                      opt["flops_by_dtype"], m),
            "bytes_per_device": line(c1["bytes_per_device"], opt["bytes"]),
            "ici_link_bytes": line(c1["ici_link_bytes"], opt["ici"]),
            "dci_link_bytes": line(c1["dci_link_bytes"], opt["dci"])}


def depth_plan(cfg: ModelConfig) -> tuple[int, int, float, float, float] | None:
    """(L_a, L_b, units_a, units_b, units_full) for cost extrapolation, or
    None for a direct count, in scan-unit space (layers, or super-blocks
    for patterned archs): the reference's plan."""
    if cfg.family == "hybrid":
        per = len(cfg.block_pattern)
        ns, tail = cfg.n_layers // per, cfg.n_layers % per
        # tail rglru layers counted as fractional super-blocks
        return (2 * per, 4 * per, 2.0, 4.0, ns + tail / per)
    if cfg.family == "vlm":
        per = cfg.cross_attn_every
        return (2 * per, 4 * per, 2.0, 4.0, cfg.n_layers / per)
    if cfg.family == "ssm":
        return (4, 8, 4.0, 8.0, float(cfg.n_layers))
    if cfg.n_layers > 16:
        return (8, 16, 8.0, 16.0, float(cfg.n_layers))
    return None


def _extract(rec: dict) -> dict:
    return {"flops_by_dtype": rec["flops_by_dtype"],
            "bytes_per_device": rec["bytes_per_device"],
            "peak_bytes": rec["peak_bytes"],
            "argument_bytes": rec["argument_bytes"],
            "ici_link_bytes": rec["collectives"]["ici_link_bytes"],
            "dci_link_bytes": rec["collectives"]["dci_link_bytes"]}


def extrapolated_cost(cfg: ModelConfig, shape: ShapeSpec,
                      tcfg: TrainConfig, mesh=None,
                      plan: ShardingPlan | None = None,
                      spec: H100Spec = H100) -> tuple[dict, dict, float]:
    """Counts at the two depths of ``depth_plan``, extrapolated linearly
    to the full depth (flops, bytes, link bytes and the peak are linear
    in depth).  Returns (metrics, the record at L_b, count seconds).  For train cells the counts use ONE microbatch at the
    per-microbatch batch (B/m); ``measure_cell`` multiplies back."""
    la, lb, ua, ub, uf = depth_plan(cfg)
    micro = 1 if shape.kind == "train" else None
    if shape.kind == "train":
        shape = shape.scaled(batch=shape.global_batch // tcfg.microbatches)
    ca, cb = (lower_cell(dataclasses.replace(cfg, n_layers=n), shape, mesh,
                         plan=plan, tcfg=tcfg, micro_override=micro,
                         spec=spec) for n in (la, lb))
    a, b = _extract(ca), _extract(cb)

    def line(x, y):
        return max(x + (y - x) / (ub - ua) * (uf - ua), 0.0)

    out = {"flops_by_dtype": {
        c: line(a["flops_by_dtype"].get(c, 0.0),
                b["flops_by_dtype"].get(c, 0.0))
        for c in {*a["flops_by_dtype"], *b["flops_by_dtype"]}}}
    for key in ("bytes_per_device", "peak_bytes", "argument_bytes",
                "ici_link_bytes", "dci_link_bytes"):
        out[key] = line(a[key], b[key])
    return out, cb, ca["compile_seconds"] + cb["compile_seconds"]


def measure_cell(cfg: ModelConfig, shape: ShapeSpec, mesh=None, *,
                 mesh_name: str | None = None,
                 plan: ShardingPlan | None = None,
                 tcfg: TrainConfig | None = None,
                 extrapolate: bool = False, spec: H100Spec = H100) -> dict:
    """The full count of a cell: a train cell as one microbatch at B/m
    reconstructed to the step (flops, bytes and link bytes), a serving
    cell directly; at full depth, or with ``extrapolate`` at
    ``depth_plan``'s two depths.  On ``mesh`` (named ``mesh_name``) one
    rank's share under ``plan`` (default ``plan_for_shape``'s).  Every
    cell is counted so on every mesh: the reference's ``with_cost``
    switch (a rolled compile on the second mesh) has nothing to select
    here."""
    tcfg = tcfg or train_config_for(cfg.arch_id)
    if mesh is not None:
        plan = plan or plan_for_shape(cfg, shape, mesh)
    m = tcfg.microbatches if shape.kind == "train" else 1
    one = shape.scaled(batch=shape.global_batch // m)
    dp = depth_plan(cfg) if extrapolate else None
    if dp is not None:
        c1, deeper, seconds = extrapolated_cost(cfg, shape, tcfg, mesh, plan,
                                                spec)
        counts = {"matmul_flops_by_dtype": None, "kernels": None,
                  "collectives": deeper["collectives"],
                  "replicated_gemms": deeper["replicated_gemms"], **c1}
        for key in ("ici_link_bytes", "dci_link_bytes"):
            counts.pop(key)
        rec = _record(cfg, shape, m, counts, seconds, spec, mesh,
                      deeper.get("kv_strategy"))
        rec["cost_extrapolated_from"] = rec["memory_extrapolated_from"] = \
            dp[:2]
    else:
        rec = lower_cell(cfg, one, mesh, plan=plan, tcfg=tcfg,
                         micro_override=1 if m > 1 else None, spec=spec)
        rec["shape"] = shape.name
        c1 = _extract(rec)
    rec["microbatches"] = m if shape.kind == "train" else 0
    rec["mesh_name"] = mesh_name or mesh_label(mesh)
    rec["cost_compile_seconds"] = 0.0
    fixed = {"ici_link_bytes": c1["ici_link_bytes"],
             "dci_link_bytes": c1["dci_link_bytes"]}
    if shape.kind == "train":
        opt = optimizer_cost(cfg, tcfg, mesh, plan, spec)
        rec["optimizer_cost"] = opt
        fixed = reconstruct_train_cost(c1, opt, m)
        rec["flops_by_dtype"] = fixed["flops_by_dtype"]
        rec["bytes_per_device"] = fixed["bytes_per_device"]
        # the peak of m microbatches is one's, with the whole batch held
        batch = _tree_bytes(_local_specs(cfg, shape, mesh, plan))
        micro_batch = batch // m
        rec["peak_bytes"] = int(c1["peak_bytes"] + batch - micro_batch)
        rec["argument_bytes"] = int(c1["argument_bytes"] + batch
                                    - micro_batch)
    rec["collectives"]["ici_link_bytes_step"] = fixed["ici_link_bytes"]
    rec["collectives"]["dci_link_bytes_step"] = fixed["dci_link_bytes"]
    _finish(rec, cfg, shape, spec)
    per_dev, fits = hbm_check(rec, spec)
    rec["hbm_bytes_per_device_est"] = per_dev
    rec["fits_hbm"] = fits
    return rec


def _local_specs(cfg: ModelConfig, shape: ShapeSpec, mesh, plan) -> dict:
    """The cell's batch as one rank holds it."""
    specs = input_specs(cfg, shape)
    if mesh is None:
        return specs
    return _place_batch(specs, _batch_shardings(cfg, shape, plan, mesh,
                                                specs))


# ---------------------------------------------------------------------------

def hbm_check(record: dict, spec: H100Spec = H100) -> tuple[float, bool]:
    """The peak of live memory the count found on one rank, against the
    card's."""
    ma = record.get("memory_analysis", {})
    per_dev = (ma.get("argument_size_in_bytes", 0)
               + ma.get("temp_size_in_bytes", 0)
               + ma.get("output_size_in_bytes", 0)
               - ma.get("alias_size_in_bytes", 0))
    return per_dev, per_dev <= spec.hbm_bytes


def _cell_line(rec: dict) -> str:
    r = rec["roofline"]
    return (f"count={rec['compile_seconds']:6.1f}s "
            f"dom={r['dominant']:10s} "
            f"step={r['step_s_overlapped'] * 1e3:12.3f}ms "
            f"hbm={rec['hbm_bytes_per_device_est'] / 2**30:9.2f}GiB "
            f"fits={rec['fits_hbm']}")


def run_cells(archs, shapes, out_path, meshes=(MESH,), *,
              spec: H100Spec = H100, extrapolate: bool = False,
              verbose: bool = True, raise_errors: bool = False,
              on_record=None) -> list[dict]:
    """Every (arch x shape) cell on each of ``meshes`` (``h100x1``, the
    one card, or the reference's ``single`` and ``multi``, each counted
    over a fake world of its own): a record, a skip with the reference's
    reason, or an error with its traceback (raised with
    ``raise_errors``).  ``on_record(rec)`` sees each as it comes."""
    results = []

    def add(rec: dict) -> None:
        results.append(rec)
        if on_record is not None:
            on_record(rec)

    for mesh_name in meshes:
        with (contextlib.nullcontext() if mesh_name == MESH
              else count_mesh(*PRODUCTION_MESHES[mesh_name])) as mesh:
            for arch in archs:
                cfg = get_config(arch)
                for shape_name in shapes:
                    shape = SHAPES[shape_name]
                    reason = skip_reason(cfg, shape)
                    if reason:
                        add({"arch": arch, "shape": shape_name,
                             "mesh": mesh_name, "skipped": reason})
                        if verbose:
                            print(f"[skip] {mesh_name:6s} {arch:24s} "
                                  f"{shape_name:12s} {reason}", flush=True)
                        continue
                    try:
                        rec = measure_cell(cfg, shape, mesh,
                                           mesh_name=mesh_name, spec=spec,
                                           extrapolate=extrapolate)
                    except Exception as e:  # noqa: BLE001 — record, go on
                        if raise_errors:
                            raise
                        add({"arch": arch, "shape": shape_name,
                             "mesh": mesh_name, "error": str(e),
                             "traceback": traceback.format_exc()})
                        if verbose:
                            print(f"[FAIL] {mesh_name:6s} {arch:24s} "
                                  f"{shape_name:12s} {e}", flush=True)
                        continue
                    add(rec)
                    if verbose:
                        print(f"[ok]   {mesh_name:6s} {arch:24s} "
                              f"{shape_name:12s} {_cell_line(rec)}",
                              flush=True)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
        if verbose:
            print(f"wrote {out_path} ({len(results)} records)")
    return results


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description="H100 dry-run on meta")
    ap.add_argument("--arch", default="all",
                    help=f"arch id or 'all' ({', '.join(ARCH_IDS)})")
    ap.add_argument("--shape", default="all",
                    help=f"shape or 'all' ({', '.join(SHAPES)})")
    ap.add_argument("--mesh", default=MESH,
                    choices=[MESH, "single", "multi", "both"],
                    help="h100x1: one card; single: 16x16, multi: "
                         "2x16x16 (one rank's share, over a fake world)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the card's name, memory and SMs "
                         "(H100Spec.from_device); cpu: the data sheet's")
    ap.add_argument("--extrapolate", action="store_true",
                    help="count at depth_plan's two depths, extrapolate")
    ap.add_argument("--out", default=None,
                    help="default experiments/dryrun_<mesh>.json")
    args = ap.parse_args(argv)

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA card here; pass "
                             "--device cpu for the data sheet's H100")
        spec = H100Spec.from_device(0)
    else:
        spec = H100
    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    out = args.out or ("experiments/dryrun_h100.json" if args.mesh == MESH
                       else f"experiments/dryrun_{args.mesh}.json")
    return run_cells(archs, shapes, out, meshes, spec=spec,
                     extrapolate=args.extrapolate)


if __name__ == "__main__":
    main()
