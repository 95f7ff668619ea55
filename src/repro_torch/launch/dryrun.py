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
One card has no mesh and moves nothing between cards: ``plan_for_shape``
and the sharding trees wait for the multi-device slice, and every
collective term is 0.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeSpec, get_config,
                                 skip_reason)
from repro_torch.hw import H100, H100Spec, dominant_term
from repro_torch.hw.cost import CostCounter, addressed_bytes, tensor_leaves
from repro_torch.models import zoo
from repro_torch.models.common import (ModelConfig, cast_matrices,
                                       torch_dtype, tree_map)
from repro_torch.optim import AdamWConfig, abstract_opt_state, adamw_update
from repro_torch.train import TrainConfig, abstract_state, make_train_step

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


# ---------------------------------------------------------------------------
# counting one cell
# ---------------------------------------------------------------------------

def _tree_bytes(tree) -> int:
    return sum(addressed_bytes(t) for t in tensor_leaves(tree))


def count_step(cfg: ModelConfig, shape: ShapeSpec, *,
               tcfg: TrainConfig | None = None) -> tuple[CostCounter, int]:
    """Run one step of the cell on meta under a counter.  Returns the
    counter and the bytes of the step's arguments (state or params and
    cache, and the batch)."""
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        tcfg = tcfg or train_config_for(cfg.arch_id)
        state = abstract_state(cfg, tcfg)
        step = make_train_step(cfg, tcfg)
        args = (state, specs)
        with CostCounter(*args) as counter:
            step(state, specs)
    elif shape.kind == "prefill":
        max_len = zoo.cache_max_len(cfg, shape.seq_len)
        params = serving_params(cfg)
        args = (params, specs)
        with CostCounter(*args) as counter, torch.no_grad():
            zoo.prefill(cfg, params, specs, max_len)
    else:
        max_len = zoo.cache_max_len(cfg, shape.seq_len)
        params = serving_params(cfg)
        cache = zoo.abstract_cache(cfg, shape.global_batch, max_len)
        cache["len"] = max_len - 1       # a full cache, the newest slot last
        args = (params, cache, specs["token"])
        with CostCounter(*args) as counter, torch.no_grad():
            zoo.decode_step(cfg, params, cache, specs["token"],
                            specs["pos"])
    return counter, _tree_bytes(args)


def _counts(counter: CostCounter, arg_bytes: int) -> dict:
    return {"flops_by_dtype": dict(counter.flops),
            "matmul_flops_by_dtype": dict(counter.matmul_flops),
            "kernels": {k: dict(v) for k, v in counter.kernels.items()},
            "bytes_per_device": float(counter.bytes),
            "peak_bytes": int(counter.peak), "argument_bytes": arg_bytes}


def lower_cell(cfg: ModelConfig, shape: ShapeSpec, *,
               tcfg: TrainConfig | None = None,
               micro_override: int | None = None,
               spec: H100Spec = H100) -> dict:
    """Count one (arch x shape) cell on meta; return its record (the
    reference's keys; ``mesh`` is the one card).  ``micro_override``
    forces the microbatch count (cost counts use 1 and reconstruct)."""
    t0 = time.time()
    tcfg = tcfg or train_config_for(cfg.arch_id)
    if micro_override is not None:
        tcfg = dataclasses.replace(tcfg, microbatches=micro_override)
    counter, arg_bytes = count_step(cfg, shape, tcfg=tcfg)
    return _record(cfg, shape, tcfg.microbatches, _counts(counter, arg_bytes),
                   time.time() - t0, spec)


def _record(cfg: ModelConfig, shape: ShapeSpec, microbatches: int,
            counts: dict, seconds: float, spec: H100Spec) -> dict:
    record = {
        "arch": cfg.arch_id, "shape": shape.name, "kind": shape.kind,
        "unrolled": True,          # a Python loop: every layer is counted
        "microbatches": microbatches if shape.kind == "train" else 0,
        "mesh": MESH, "devices": 1, **counts,
        "collectives": {"full_tensor_bytes": 0, "ici_link_bytes": 0,
                        "dci_link_bytes": 0, "by_kind": {}},
        "compile_seconds": seconds,
    }
    _finish(record, cfg, shape, spec)
    if shape.kind == "decode":
        record["kv_strategy"] = "single-device"
    return record


def _finish(rec: dict, cfg: ModelConfig, shape: ShapeSpec,
            spec: H100Spec) -> None:
    """The totals, the memory analysis and the roofline of a record from
    its counts."""
    flops = sum(rec["flops_by_dtype"].values())
    rec["flops_per_device"] = flops
    rec["memory_analysis"] = {
        "argument_size_in_bytes": rec["argument_bytes"],
        "temp_size_in_bytes": rec["peak_bytes"] - rec["argument_bytes"],
        "output_size_in_bytes": 0, "alias_size_in_bytes": 0}
    compute_s = spec.compute_time(rec["flops_by_dtype"])
    memory_s = spec.memory_time(rec["bytes_per_device"])
    collective_s = spec.collective_time(0.0, 0.0)
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
    rec["hlo_flops_global"] = flops
    rec["useful_flops_ratio"] = model_flops / flops if flops else None


# ---------------------------------------------------------------------------
# cost reconstruction: COST = m * (C_m1 - C_opt) + C_opt
# ---------------------------------------------------------------------------

def optimizer_cost(cfg: ModelConfig, tcfg: TrainConfig) -> dict:
    """Count the AdamW update alone, to separate the per-step optimizer
    cost from the per-microbatch cost."""
    params = zoo.abstract(cfg)
    opt = abstract_opt_state(tcfg.optimizer, params)
    acc_dt = torch_dtype(tcfg.accum_dtype)
    grads = tree_map(lambda _, p: torch.empty(p.shape, dtype=acc_dt,
                                              device="meta"), params)
    with CostCounter(params, opt, grads) as counter:
        adamw_update(tcfg.optimizer, grads, opt, params)
    return {"flops_by_dtype": dict(counter.flops),
            "bytes": float(counter.bytes)}


def _scaled(c1: dict, opt: dict, m: int) -> dict:
    return {c: m * max(c1.get(c, 0.0) - opt.get(c, 0.0), 0.0)
            + opt.get(c, 0.0) for c in {*c1, *opt}}


def reconstruct_train_cost(c1: dict, opt: dict, m: int) -> dict:
    """Combine the one-microbatch count with the optimizer-only count:
    per-step = m * (C_m1 - C_opt) + C_opt (clamped at C_m1), for the
    flops of each class and the bytes."""
    return {"flops_by_dtype": _scaled(c1["flops_by_dtype"],
                                      opt["flops_by_dtype"], m),
            "bytes_per_device": m * max(c1["bytes_per_device"]
                                        - opt["bytes"], 0.0) + opt["bytes"]}


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
            "argument_bytes": rec["argument_bytes"]}


def extrapolated_cost(cfg: ModelConfig, shape: ShapeSpec,
                      tcfg: TrainConfig) -> tuple[dict, float]:
    """Counts at the two depths of ``depth_plan``, extrapolated linearly
    to the full depth (flops, bytes and the peak are linear in depth).
    Returns (metrics, count seconds).  For train cells the counts use ONE
    microbatch at the per-microbatch batch (B/m); ``measure_cell``
    multiplies back."""
    la, lb, ua, ub, uf = depth_plan(cfg)
    micro = 1 if shape.kind == "train" else None
    if shape.kind == "train":
        shape = shape.scaled(batch=shape.global_batch // tcfg.microbatches)
    ca = lower_cell(dataclasses.replace(cfg, n_layers=la), shape, tcfg=tcfg,
                    micro_override=micro)
    cb = lower_cell(dataclasses.replace(cfg, n_layers=lb), shape, tcfg=tcfg,
                    micro_override=micro)
    a, b = _extract(ca), _extract(cb)

    def line(x, y):
        return max(x + (y - x) / (ub - ua) * (uf - ua), 0.0)

    out = {"flops_by_dtype": {
        c: line(a["flops_by_dtype"].get(c, 0.0),
                b["flops_by_dtype"].get(c, 0.0))
        for c in {*a["flops_by_dtype"], *b["flops_by_dtype"]}}}
    for key in ("bytes_per_device", "peak_bytes", "argument_bytes"):
        out[key] = line(a[key], b[key])
    return out, ca["compile_seconds"] + cb["compile_seconds"]


def measure_cell(cfg: ModelConfig, shape: ShapeSpec, *,
                 tcfg: TrainConfig | None = None, extrapolate: bool = False,
                 spec: H100Spec = H100) -> dict:
    """The full count of a cell: a train cell as one microbatch at B/m
    reconstructed to the step, a serving cell directly; at full depth, or
    with ``extrapolate`` at ``depth_plan``'s two depths."""
    tcfg = tcfg or train_config_for(cfg.arch_id)
    m = tcfg.microbatches if shape.kind == "train" else 1
    one = shape.scaled(batch=shape.global_batch // m)
    dp = depth_plan(cfg) if extrapolate else None
    if dp is not None:
        c1, seconds = extrapolated_cost(cfg, shape, tcfg)
        rec = _record(cfg, shape, m, {"matmul_flops_by_dtype": None,
                                      "kernels": None, **c1}, seconds, spec)
        rec["cost_extrapolated_from"] = rec["memory_extrapolated_from"] = \
            dp[:2]
    else:
        rec = lower_cell(cfg, one, tcfg=tcfg,
                         micro_override=1 if m > 1 else None, spec=spec)
        rec["shape"] = shape.name
        c1 = _extract(rec)
    rec["microbatches"] = m if shape.kind == "train" else 0
    rec["mesh_name"] = MESH
    rec["cost_compile_seconds"] = 0.0
    if shape.kind == "train":
        opt = optimizer_cost(cfg, tcfg)
        rec["optimizer_cost"] = opt
        rec.update(reconstruct_train_cost(c1, opt, m))
        # the peak of m microbatches is one's, with the whole batch held
        batch = _tree_bytes(input_specs(cfg, shape))
        micro_batch = batch // m
        rec["peak_bytes"] = int(c1["peak_bytes"] + batch - micro_batch)
        rec["argument_bytes"] = int(c1["argument_bytes"] + batch
                                    - micro_batch)
    rec["collectives"]["ici_link_bytes_step"] = 0.0
    rec["collectives"]["dci_link_bytes_step"] = 0.0
    _finish(rec, cfg, shape, spec)
    per_dev, fits = hbm_check(rec, spec)
    rec["hbm_bytes_per_device_est"] = per_dev
    rec["fits_hbm"] = fits
    return rec


# ---------------------------------------------------------------------------

def hbm_check(record: dict, spec: H100Spec = H100) -> tuple[float, bool]:
    """The peak of live memory the count found, against the card's."""
    ma = record.get("memory_analysis", {})
    per_dev = (ma.get("argument_size_in_bytes", 0)
               + ma.get("temp_size_in_bytes", 0)
               + ma.get("output_size_in_bytes", 0)
               - ma.get("alias_size_in_bytes", 0))
    return per_dev, per_dev <= spec.hbm_bytes


def run_cells(archs, shapes, out_path, *, spec: H100Spec = H100,
              extrapolate: bool = False, verbose: bool = True,
              raise_errors: bool = False) -> list[dict]:
    """Every (arch x shape) cell: a record, a skip with the reference's
    reason, or an error with its traceback (raised with
    ``raise_errors``)."""
    results = []
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            shape = SHAPES[shape_name]
            reason = skip_reason(cfg, shape)
            if reason:
                results.append({"arch": arch, "shape": shape_name,
                                "mesh": MESH, "skipped": reason})
                if verbose:
                    print(f"[skip] {MESH} {arch:24s} {shape_name:12s} "
                          f"{reason}", flush=True)
                continue
            try:
                rec = measure_cell(cfg, shape, spec=spec,
                                   extrapolate=extrapolate)
            except Exception as e:  # noqa: BLE001 — record and continue
                if raise_errors:
                    raise
                results.append({"arch": arch, "shape": shape_name,
                                "mesh": MESH, "error": str(e),
                                "traceback": traceback.format_exc()})
                if verbose:
                    print(f"[FAIL] {MESH} {arch:24s} {shape_name:12s} {e}",
                          flush=True)
                continue
            results.append(rec)
            if verbose:
                r = rec["roofline"]
                print(f"[ok]   {MESH} {arch:24s} {shape_name:12s} "
                      f"count={rec['compile_seconds']:6.1f}s "
                      f"dom={r['dominant']:10s} "
                      f"step={r['step_s_overlapped'] * 1e3:12.3f}ms "
                      f"hbm={rec['hbm_bytes_per_device_est'] / 2**30:9.2f}GiB "
                      f"fits={rec['fits_hbm']}", flush=True)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
        if verbose:
            print(f"wrote {out_path} ({len(results)} records)")
    return results


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description="one-H100 dry-run on meta")
    ap.add_argument("--arch", default="all",
                    help=f"arch id or 'all' ({', '.join(ARCH_IDS)})")
    ap.add_argument("--shape", default="all",
                    help=f"shape or 'all' ({', '.join(SHAPES)})")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the card's name, memory and SMs "
                         "(H100Spec.from_device); cpu: the data sheet's")
    ap.add_argument("--extrapolate", action="store_true",
                    help="count at depth_plan's two depths, extrapolate")
    ap.add_argument("--out", default="experiments/dryrun_h100.json")
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
    return run_cells(archs, shapes, args.out, spec=spec,
                     extrapolate=args.extrapolate)


if __name__ == "__main__":
    main()
