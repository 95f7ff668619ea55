"""The port's dry-run (``repro_torch.launch.dryrun``, ``repro_torch.hw``)
against the reference's (``repro.launch.dryrun``, ``repro.hw``), on the
CPU.

* Matmul flops, exact: for the olmo-1b, mixtral-8x7b,
  llama-3.2-vision-11b and whisper-small smoke configs in float32 (B=2,
  S=64), the forward and the loss gradient counted on meta by
  ``CostCounter`` (with ``self_attn=attention_plain``) equal the
  reference's ``dot_general`` flops: every ``dot_general`` of the jaxpr
  from ``jax.make_jaxpr`` (no compile) at 2·M·N·K, scan bodies counted
  ``length`` times.
* The recurrent families: recurrentgemma-2b's associative scan has no
  dot, so its GEMM flops are equal with nothing taken off; rwkv6-1.6b's
  are equal once the dots of the reference's chunked WKV
  (``rwkv6_linear_attention``, found by each equation's traceback) are
  taken off, and in the gradient the dots of ``wkv6_plain``'s VJP that
  the port recomputes in ``KernelFn``'s backward.  Each kernel's counted
  share is its ``cost`` times its calls.
* Bytes and the peak of live memory equal a hand count on a short chain
  of ops, on CPU tensors and on meta alike; the once-a-shape count of
  the recurrences' backward equals counting every call.
* The wrappers on meta: outputs and ``cost`` only under a counter; a
  meta tensor outside one raises.
* Copies: ``SHAPES``, ``skip_reason`` over all 40 (arch, shape) pairs,
  ``TRAIN_CFGS``, ``depth_plan`` and ``dominant_term`` equal the
  reference's; ``zoo.abstract_cache`` and ``zoo.abstract`` on meta have
  the reference's paths, shapes and dtypes for all ten archs; ``measure_cell`` at a smoke cell gives the reference's
  record keys (read from its source).
"""

import ast
import dataclasses
import math
import os
import pathlib

import jax
import jax.extend as jex
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import skip_reason as ref_skip_reason
from repro.hw import dominant_term as ref_dominant_term
from repro.models import zoo as ref_zoo
from repro_torch.configs import SHAPES, get_config, skip_reason
from repro_torch.hw import H100, H100Spec, dominant_term, matmul_class
from repro_torch.hw.cost import CostCounter
from repro_torch.kernels import _grad
from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.kernels.rglru import rglru
from repro_torch.kernels.rwkv6 import ops as wkv6_ops
from repro_torch.kernels.rwkv6 import wkv6, wkv6_plain
from repro_torch.launch import dryrun
from repro_torch.models import zoo
from repro_torch.models.common import tree_leaves

B, S = 2, 64
# the reference's dot_general flops at B=2, S=64, float32 smoke configs
REFERENCE_FLOPS = {
    ("olmo-1b", "forward"): 46_137_344,
    ("olmo-1b", "loss gradient"): 138_674_176,
    ("granite-3-8b", "forward"): 34_603_008,
    ("granite-3-8b", "loss gradient"): 104_071_168,
    ("mixtral-8x7b", "forward"): 73_531_392,
    ("mixtral-8x7b", "loss gradient"): 212_467_712,
    ("llama-3.2-vision-11b", "forward"): 49_020_928,
    ("llama-3.2-vision-11b", "loss gradient"): 147_062_784,
    ("whisper-small", "forward"): 38_420_480,
    ("whisper-small", "loss gradient"): 115_523_584,
}
PASSES = ("forward", "loss gradient")
REF_DRYRUN = pathlib.Path(__file__).resolve().parents[1] / \
    "src/repro/launch/dryrun.py"


@pytest.fixture(scope="module")
def ref_dryrun():
    """``repro.launch.dryrun``, whose import sets ``XLA_FLAGS`` to 512 host
    devices: jax's backend is up first (so this process keeps its
    devices) and the variable is put back after."""
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


# ---------------------------------------------------------------------------
# the reference's dot flops, from its jaxpr
# ---------------------------------------------------------------------------

def _sub_jaxprs(eqn):
    for value in eqn.params.values():
        for x in value if isinstance(value, (tuple, list)) else (value,):
            if isinstance(x, jex.core.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jex.core.Jaxpr):
                yield x


def dot_flops(jaxpr, skip_function: str | None = None) -> int:
    """2·M·N·K of every ``dot_general`` (a scan's body ``length`` times),
    leaving out those traced inside ``skip_function``."""
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            frames = eqn.source_info.traceback.frames
            if not (skip_function and any(f.function_name == skip_function
                                          for f in frames)):
                (contract, _), _ = eqn.params["dimension_numbers"]
                lhs = eqn.invars[0].aval.shape
                total += 2 * math.prod(eqn.outvars[0].aval.shape) * \
                    math.prod(lhs[i] for i in contract)
        trips = eqn.params["length"] if eqn.primitive.name == "scan" else 1
        for sub in _sub_jaxprs(eqn):
            total += trips * dot_flops(sub, skip_function)
    return total


def reference_flops(arch: str, pass_: str,
                    skip_function: str | None = None) -> int:
    cfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                              dtype="float32")
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "targets": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    if ref_zoo.needs_frontend(cfg):
        batch["frontend"] = jax.ShapeDtypeStruct(
            (B, cfg.n_frontend_tokens, cfg.d_model), jnp.float32)
    if pass_ == "forward":
        fn = lambda p, b: ref_zoo.forward(cfg, p, b)  # noqa: E731
    else:
        fn = jax.grad(lambda p, b: ref_zoo.loss_fn(cfg, p, b)[0])
    jaxpr = jax.make_jaxpr(fn)(ref_zoo.abstract(cfg), batch).jaxpr
    return dot_flops(jaxpr, skip_function)


# ---------------------------------------------------------------------------
# the port's count, on meta
# ---------------------------------------------------------------------------

def port_count(arch: str, pass_: str, **kw) -> CostCounter:
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    params = zoo.abstract(cfg)
    batch = {k: torch.empty((B, S), dtype=torch.int64, device="meta")
             for k in ("tokens", "targets")}
    if zoo.needs_frontend(cfg):
        batch["frontend"] = torch.empty(
            (B, cfg.n_frontend_tokens, cfg.d_model), device="meta")
    with CostCounter(params, batch) as counter:
        if pass_ == "forward":
            zoo.forward(cfg, params, batch, **kw)
        else:
            leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
            loss, _ = zoo.loss_fn(cfg, params, batch, **kw)
            torch.autograd.grad(loss, leaves, allow_unused=True)
    return counter


@pytest.mark.parametrize("pass_", PASSES)
@pytest.mark.parametrize("arch", ["olmo-1b", "granite-3-8b",
                                  "mixtral-8x7b", "llama-3.2-vision-11b",
                                  "whisper-small"])
def test_matmul_flops_equal_the_reference_dots(arch, pass_):
    counter = port_count(arch, pass_, self_attn=attention_plain)
    want = reference_flops(arch, pass_)
    assert want == REFERENCE_FLOPS[arch, pass_]
    assert counter.matmul_flops == {"float32": want}
    assert dict(counter.flops) == {"float32": want}
    assert not counter.kernels


def _wkv6_vjp_flops(cfg) -> float:
    """The GEMM flops of one time-mix block's ``wkv6_plain`` VJP as
    ``KernelFn``'s backward recomputes it (the final state unused)."""
    h, d = cfg.n_heads, cfg.d_model // cfg.n_heads
    ins = [torch.empty((B, S, h, d), device="meta").transpose(1, 2)
           for _ in range(4)] + [torch.empty((h, d), device="meta")]
    with CostCounter() as counter:
        _grad.vjp(wkv6_plain, ins, [True] * 5,
                  [torch.empty((B, h, S, d), device="meta"), None],
                  floor=1e-8)
    return sum(counter.matmul_flops.values())


@pytest.mark.parametrize("pass_", PASSES)
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-1.6b"])
def test_recurrent_families_count_their_kernels_by_cost(arch, pass_):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    kw = {} if cfg.family == "ssm" else {"self_attn": attention_plain}
    counter = port_count(arch, pass_, **kw)
    if arch == "rwkv6-1.6b":
        want = reference_flops(arch, pass_, "rwkv6_linear_attention")
        assert want < reference_flops(arch, pass_)
        if pass_ == "loss gradient":
            want += cfg.n_layers * _wkv6_vjp_flops(cfg)
        name, calls = "wkv6", cfg.n_layers
        h = cfg.n_heads
        one = wkv6_ops.cost(B, h, S, cfg.d_model // h, torch.float32)
    else:
        want = reference_flops(arch, pass_)
        name = "rglru"
        calls = sum(k == "rglru" for k in cfg.block_pattern) * (
            cfg.n_layers // len(cfg.block_pattern)) + sum(
            k == "rglru" for k in cfg.block_pattern[:cfg.n_layers
                                                    % len(cfg.block_pattern)])
        one = rglru_ops.cost(B, S, cfg.rglru_dim or cfg.d_model,
                             torch.float32)
    assert sum(counter.matmul_flops.values()) == want
    kernel = counter.kernels[name]
    assert kernel["calls"] == calls
    assert kernel["flops"] == calls * one["flops"]
    assert kernel["bytes"] == calls * one["bytes"]
    assert counter.flops["float32"] == want + kernel["flops"]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_bytes_and_peak_equal_a_hand_count(device):
    x = torch.ones((256, 128), device=device)           # 131,072 bytes
    w = torch.ones((128, 64), device=device)            # 32,768 bytes
    with CostCounter(x, w) as counter:
        y = x @ w                  # reads x and w, writes 65,536 bytes
        z = torch.relu(y)          # reads and writes 65,536
        del y
        v = z.view(-1)             # a view: nothing
        v.sum()                    # reads 65,536, writes 4
        z.fill_(0.0)               # writes 65,536 without reading
    assert dict(counter.flops) == {"float32": 2 * 256 * 128 * 64}
    assert counter.bytes == (131_072 + 32_768 + 65_536) + 2 * 65_536 \
        + (65_536 + 4) + 65_536
    # x, w, y and z live at once; the sum's 4 bytes freed at once
    assert counter.peak == 131_072 + 32_768 + 2 * 65_536
    assert counter.live == 131_072 + 32_768 + 65_536


def test_broadcast_inputs_count_once():
    a = torch.empty((1, 64), device="meta").expand(32, 64)
    with CostCounter() as counter:
        a + 1.0
    assert counter.bytes == 64 * 4 + 32 * 64 * 4


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b"])
def test_once_a_shape_backward_count_equals_counting_every_call(
        arch, monkeypatch):
    cfg = dataclasses.replace(get_config(arch), n_layers=3)
    shape = SHAPES["train_4k"].scaled(seq=32, batch=2)
    once = dryrun.lower_cell(cfg, shape, micro_override=1)
    monkeypatch.setattr(CostCounter, "repeat", lambda self, key, fn: fn())
    every = dryrun.lower_cell(cfg, shape, micro_override=1)
    for key in ("flops_by_dtype", "bytes_per_device", "peak_bytes"):
        assert once[key] == every[key], key


def _kernel_case(name):
    if name == "flash_attention":
        q, k = (torch.empty((2, 40, h, 64), dtype=torch.bfloat16,
                            device="meta") for h in (8, 2))
        return (lambda: flash_attention(q, k, k, causal=True, window=16),
                [q.shape],
                flash_ops.cost(2, 40, 8, 2, 64, causal=True, window=16,
                               dtype=torch.bfloat16))
    if name == "rglru":
        a = torch.empty((2, 40, 96), dtype=torch.bfloat16, device="meta")
        return (lambda: rglru(a, a), [a.shape, (2, 96)],
                rglru_ops.cost(2, 40, 96, torch.bfloat16))
    r = torch.empty((2, 40, 4, 32), dtype=torch.bfloat16,
                    device="meta").transpose(1, 2)
    u = torch.empty((4, 32), device="meta")
    return (lambda: wkv6(r, r, r, r, u, floor=1e-8), [r.shape, (2, 4, 32, 32)],
            wkv6_ops.cost(2, 4, 40, 32, torch.bfloat16))


@pytest.mark.parametrize("name", ["flash_attention", "rglru", "wkv6"])
def test_wrappers_count_on_meta_only_under_a_counter(name):
    call, shapes, cost = _kernel_case(name)
    before = {"flash_attention": flash_attention, "rglru": rglru,
              "wkv6": wkv6}[name].launches
    with pytest.raises(ValueError, match="no kernel for device meta"):
        call()
    with CostCounter() as counter:
        out = call()
    outs = out if isinstance(out, tuple) else (out,)
    assert [tuple(o.shape) for o in outs] == [tuple(s) for s in shapes]
    assert all(o.device.type == "meta" for o in outs)
    assert counter.kernels[name] == {"calls": 1, **cost}
    assert counter.flops[cost["peak_class"]] == cost["flops"]
    # nothing launched
    assert {"flash_attention": flash_attention, "rglru": rglru,
            "wkv6": wkv6}[name].launches == before


def test_meta_self_attention_takes_the_flash_route():
    """Under a counter, meta self-attention goes to flash as on CUDA (with
    the dense fp32 backward ``KernelFn`` recomputes); cross-attention
    stays dense."""
    cfg = get_config("olmo-1b", smoke=True)
    counter = port_count("olmo-1b", "loss gradient")
    one = flash_ops.cost(B, S, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         causal=True, window=None, dtype=torch.float32)
    assert counter.kernels["flash_attention"] == {
        "calls": cfg.n_layers, **{k: cfg.n_layers * v if k != "peak_class"
                                  else v for k, v in one.items()}}
    plain = port_count("olmo-1b", "loss gradient", self_attn=attention_plain)
    # the recomputed dense backward holds the forward's QKᵀ and PV too
    assert counter.matmul_flops["float32"] == plain.matmul_flops["float32"]


def test_flash_cost_counts_the_pairs_each_query_sees():
    for s, window in ((1, None), (37, None), (300, 64), (64, 64), (10, 200)):
        want = sum(min(i + 1, window or s) for i in range(s))
        assert flash_ops.causal_pairs(s, window) == want
    assert flash_ops.cost(4, 512, 16, 16, 128)["bytes"] == 4 * (
        4 * 512 * 16 * 128 * 2)
    non_causal = flash_ops.cost(1, 100, 2, 1, 64, causal=False)
    assert non_causal["flops"] == 4.0 * 2 * 64 * 100 * 100


def test_h100_spec_prices_each_class_at_its_peak(monkeypatch):
    assert H100.compute_time({"bfloat16": 989e12, "float32": 67e12}) == 2.0
    assert H100.memory_time(3.35e12) == 1.0
    assert H100.collective_time(0.0, 0.0) == 0.0
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    assert matmul_class(torch.float32) == "float32"
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert matmul_class(torch.float32) == "tfloat32"
    assert matmul_class(torch.bfloat16) == "bfloat16"
    assert H100.compute_time({"tfloat32": 494.7e12}) == 1.0
    assert H100Spec().hbm_bytes == 80 * 10**9


# ---------------------------------------------------------------------------
# the copies
# ---------------------------------------------------------------------------

def test_shapes_and_skips_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    pairs = [(a, s) for a in ARCH_IDS for s in SHAPES]
    assert len(pairs) == 40
    for arch, shape in pairs:
        assert skip_reason(get_config(arch), SHAPES[shape]) == \
            ref_skip_reason(ref_get_config(arch), REF_SHAPES[shape])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_cache_and_params_equal_the_reference(arch):
    """``zoo.abstract_cache`` and ``zoo.abstract`` on meta have the
    reference's paths, shapes and dtypes; the port's "len" is a Python
    int, 0 as ``init_cache`` makes it (the reference's an int32 scalar)."""
    ref_cfg, cfg = ref_get_config(arch, smoke=True), get_config(arch,
                                                                smoke=True)
    for ref_tree, tree in (
            (ref_zoo.abstract_cache(ref_cfg, 2, 16),
             zoo.abstract_cache(cfg, 2, 16)),
            (ref_zoo.abstract(ref_cfg), zoo.abstract(cfg))):
        ref_leaves, leaves = dict(_flat(ref_tree)), dict(_flat(tree))
        assert set(leaves) == set(ref_leaves)
        for path, t in leaves.items():
            if path == "/len":
                assert t == 0
                continue
            assert t.device.type == "meta", path
            assert (tuple(t.shape), str(t.dtype).removeprefix("torch.")) == \
                (tuple(ref_leaves[path].shape), str(ref_leaves[path].dtype)), \
                path
    cache = zoo.init_cache(cfg, 2, 16, device="cpu")
    for path, t in _flat(cache):
        if path != "/len":
            assert not t.any(), path


def test_train_configs_depth_plans_and_dominance_equal_the_reference(
        ref_dryrun):
    assert set(dryrun.TRAIN_CFGS) == set(ref_dryrun.TRAIN_CFGS)
    for arch in ARCH_IDS:
        assert dataclasses.asdict(dryrun.train_config_for(arch)) == \
            dataclasses.asdict(ref_dryrun.train_config_for(arch))
        assert dryrun.depth_plan(get_config(arch)) == \
            ref_dryrun.depth_plan(ref_get_config(arch))
    assert dryrun.train_config_for("unknown") == dryrun.TrainConfig(
        microbatches=4)
    for terms in ((1.0, 2.0, 0.0), (3.0, 2.0, 0.0), (0.0, 0.0, 1.0),
                  (1.0, 1.0, 1.0)):
        assert dominant_term(*terms) == ref_dominant_term(*terms)


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


def test_measure_cell_gives_the_reference_record_keys():
    ref_keys = _reference_record_keys()
    assert {"flops_per_device", "roofline", "fits_hbm",
            "useful_flops_ratio", "kv_strategy"} <= ref_keys
    cfg = get_config("olmo-1b", smoke=True)
    shape = SHAPES["train_4k"].scaled(seq=128, batch=8)
    rec = dryrun.measure_cell(cfg, shape)
    # set only for decode, for the text-size option and for extrapolation
    assert ref_keys - {"kv_strategy", "hlo_lines",
                       "cost_extrapolated_from"} <= set(rec)
    assert rec["mesh"] == rec["mesh_name"] == "h100x1"
    # a smoke arch id has no entry: the default of 4 microbatches
    assert rec["microbatches"] == 4 and rec["fits_hbm"]
    assert rec["flops_per_device"] == sum(rec["flops_by_dtype"].values()) > 0
    r = rec["roofline"]
    assert r["step_s_overlapped"] == max(r["compute_s"], r["memory_s"]) > 0
    assert r["dominant"] in ("compute", "memory")
    decode = dryrun.measure_cell(cfg, SHAPES["decode_32k"].scaled(
        seq=256, batch=4))
    assert ref_keys - {"hlo_lines", "cost_extrapolated_from",
                       "optimizer_cost"} <= set(decode)
    deep = dataclasses.replace(get_config("llama3-405b", smoke=True),
                               n_layers=20)
    extrapolated = dryrun.measure_cell(deep, SHAPES["prefill_32k"].scaled(
        seq=64, batch=2), extrapolate=True)
    full = dryrun.measure_cell(deep, SHAPES["prefill_32k"].scaled(
        seq=64, batch=2))
    assert extrapolated["memory_extrapolated_from"] == (8, 16)
    # flops and bytes are linear in depth
    assert extrapolated["flops_per_device"] == pytest.approx(
        full["flops_per_device"], rel=1e-12)
    assert extrapolated["bytes_per_device"] == pytest.approx(
        full["bytes_per_device"], rel=1e-12)


def test_train_cell_reconstructs_the_microbatches():
    """One microbatch at B/m, reconstructed as the reference does (m x
    (one microbatch - optimizer) + optimizer), counts the flops and the
    peak of a step of m microbatches; its bytes count the step's other
    once-a-step work m times: the zeroed fp32 accumulators (P bytes
    written), their division by m (P read, P written) and the loss's
    two scalars (12 bytes)."""
    cfg = get_config("olmo-1b", smoke=True)
    shape = SHAPES["train_4k"].scaled(seq=32, batch=4)
    rec = dryrun.measure_cell(cfg, shape)
    m = rec["microbatches"]
    counter, args = dryrun.count_step(cfg, shape)
    assert rec["flops_by_dtype"] == pytest.approx(dict(counter.flops),
                                                  rel=1e-12)
    p = 4 * sum(t.numel() for t in tree_leaves(zoo.abstract(cfg)))
    assert rec["bytes_per_device"] - counter.bytes == (m - 1) * (3 * p + 12)
    assert rec["peak_bytes"] == counter.peak
    assert rec["argument_bytes"] == args
