#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, one JSON line each:
  1. card    the device name and ``nvidia-smi`` name and power limit;
  2. build   nvcc builds every CUDA kernel from the checkout's sources;
  3. kernel  each kernel against its plain version on the card, bf16 and
             fp32: flash attention (``attention_plain``) at the olmo-1b
             prefill shape, a GQA shape, a ragged length, a window, D=16,
             S=1 and the recurrentgemma-2b prefill shape (D=256, MQA 10/1,
             window 2048, S=2600); RG-LRU (``rglru_plain``) at the
             recurrentgemma-2b prefill shape, a ragged S=300, S=1 and
             a=1e-6;
  4. kernel_time  each kernel's time, its plain version's, a PyTorch call
             that computes the same function where one exists (a yardstick
             the port never calls) and the least time the card could take
             (bound), at the main paths' shapes;
  5. slice   olmo-1b at full width (random weights from seed 0, bf16
             activations) served by ``ServeEngine``: 8 requests of 64-512
             prompt tokens on 4 slots, 16 new tokens each;
  6. slice   recurrentgemma-2b at full width, the same way: 8 requests on
             4 slots, 16 new tokens each, ``max_len`` 4096, a first wave
             of 64-512 prompt tokens and a second of 1500-2600 (one above
             the 2048 window, one not a multiple of 64).
Each slice zeroes every kernel's launch counter just before it serves and
reads them just after, and holds a wave's prefill logits against the same
prefill through the kernels' plain versions, in fp32 and in bf16.  Then
the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises: the script
exits non-zero with its traceback.  Without CUDA it exits 2 and prints no
result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

PEAK_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
PEAK_BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core rate
PEAK_F32_OPS_PER_S = 67e12    # fp32 outside the tensor cores
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
RGLRU_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# prefill logits, kernel path vs plain path, relative to the largest logit.
# In fp32 the two paths differ only by the kernels' fp32 errors (at most
# about 1e-6 a call on the checked shapes): 1e-3 holds them to the same
# function at full width.  In bf16 both compute attention and the
# recurrence in fp32 and round their outputs to bf16, so they differ where
# that rounding flips, and the bf16 layers carry the flips on: after 26
# layers of recurrentgemma-2b with random weights that reaches a few bf16
# ulps of the largest logit whatever the kernels do (a different summation
# order alone does it).  So the bf16 gap must be within the kernel tests'
# bf16 tolerance relative to the largest logit, or else no larger than the
# bf16 plain path's own error against the fp32 plain path; and the greedy
# token must agree wherever the plain path's top-2 margin is above twice
# that tolerance.
LOGIT_RTOL = {"float32": 1e-3, "bfloat16": TOL["bfloat16"]}

# (name, B, S, H, K, D, window)
KERNEL_SHAPES = [
    ("olmo-1b prefill", 4, 512, 16, 16, 128, None),
    ("granite GQA", 2, 512, 32, 8, 128, None),
    ("ragged S=300", 2, 300, 16, 16, 128, None),
    ("window 64", 2, 512, 16, 16, 128, 64),
    ("D=16", 2, 128, 4, 4, 16, None),
    ("S=1", 4, 1, 16, 16, 128, None),
    ("recurrentgemma-2b prefill", 4, 2600, 10, 1, 256, 2048),
]
# (name, B, S, R, constant a or None for a ~ U(0.001, 0.9995))
RGLRU_SHAPES = [
    ("recurrentgemma-2b prefill", 4, 2048, 2560, None),
    ("ragged S=300", 4, 300, 2560, None),
    ("S=1", 4, 1, 2560, None),
    ("a=1e-6", 1, 64, 2560, 1e-6),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean device time of ``fn`` from CUDA events, after a warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, peak_ops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over their peak rate and the bytes over the memory rate."""
    op_ms = flops / peak_ops * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" if op_ms > byte_ms else "bytes",
            "flops": flops, "bytes": nbytes}


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def within(out, ref, tol: float) -> bool:
    """|out - ref| <= tol + tol * |ref| everywhere, and finite."""
    import torch
    err = (out.float() - ref.float()).abs()
    return bool((err <= tol + tol * ref.float().abs()).all()
                and torch.isfinite(out.float()).all())


def check_flash(gen, dev) -> dict:
    import torch

    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention)
    max_err = {}
    for name, b, s, h, kh, d, window in KERNEL_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dn = dtype_name(dtype)
            q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
            k = torch.randn((b, s, kh, d), generator=gen, device=dev).to(dtype)
            v = torch.randn((b, s, kh, d), generator=gen, device=dev).to(dtype)
            out = flash_attention(q, k, v, causal=True, window=window)
            ref = attention_plain(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            check = {"phase": "kernel", "kernel": "flash_attention",
                     "shape": name, "B": b, "S": s, "H": h, "K": kh, "D": d,
                     "window": window, "dtype": dn,
                     "max_abs_err": float((out.float() - ref.float())
                                          .abs().max()),
                     "tol": TOL[dn], "ok": within(out, ref, TOL[dn])}
            emit(check)
            assert check["ok"], check
            max_err[(name, dn)] = check["max_abs_err"]
    return max_err


def rglru_inputs(gen, dev, b, s, r, a_const, dtype):
    import torch
    if a_const is None:
        a = 0.001 + 0.9985 * torch.rand((b, s, r), generator=gen, device=dev)
    else:
        a = torch.full((b, s, r), a_const, device=dev)
    x = torch.randn((b, s, r), generator=gen, device=dev)
    return a.to(dtype), x.to(dtype)


def check_rglru(gen, dev) -> dict:
    import torch

    from repro_torch.kernels.rglru import rglru, rglru_plain
    max_err = {}
    for name, b, s, r, a_const in RGLRU_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dn = dtype_name(dtype)
            a, x = rglru_inputs(gen, dev, b, s, r, a_const, dtype)
            h, h_last = rglru(a, x)
            ref, ref_last = rglru_plain(a, x)
            torch.cuda.synchronize()
            tol = RGLRU_TOL[dn]
            err = max(float((h.float() - ref.float()).abs().max()),
                      float((h_last - ref_last).abs().max()))
            check = {"phase": "kernel", "kernel": "rglru", "shape": name,
                     "B": b, "S": s, "R": r, "a": a_const or "U(0.001,0.9995)",
                     "dtype": dn, "max_abs_err": err, "tol": tol,
                     "ok": (h.dtype == dtype and h_last.dtype == torch.float32
                            and within(h, ref, tol)
                            and within(h_last, ref_last, tol))}
            emit(check)
            assert check["ok"], check
            max_err[(name, dn)] = err
    return max_err


def time_flash(gen, dev, shape, max_err) -> dict:
    """Times at one of ``KERNEL_SHAPES`` in the main path's dtype (bf16);
    the yardstick is ``scaled_dot_product_attention`` on the same inputs
    (GQA through ``enable_gqa``; a window through a boolean mask)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention)
    name, b, s, h, kh, d, window = shape
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device=dev)
               .to(torch.bfloat16) for n in (h, kh, kh))
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True, window=window))
    q32, k32, v32 = (t.float() for t in (q, k, v))
    fp32_ms = cuda_ms(lambda: flash_attention(q32, k32, v32, causal=True,
                                              window=window), iters=5)
    del q32, k32, v32
    plain_ms = cuda_ms(lambda: attention_plain(q, k, v, causal=True,
                                               window=window), iters=5)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if window is None:
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=kh != h))
    else:
        pos = torch.arange(s, device=dev)
        mask = (pos[None, :] <= pos[:, None]) & \
            (pos[None, :] > pos[:, None] - window)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=kh != h))
    # causal (and window) pairs each query sees
    pairs = sum(min(i + 1, window or s) for i in range(s))
    flops = 4.0 * b * h * d * pairs
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    return {"ms": ms, "fp32_ms": fp32_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            **bound(flops, PEAK_BF16_OPS_PER_S, nbytes),
            "max_abs_err": max_err[(name, "bfloat16")],
            "tol": TOL["bfloat16"],
            "at": f"{name} B={b} S={s} H={h} K={kh} D={d} window={window} "
                  "bf16 causal"}


def time_rglru(gen, dev, max_err) -> dict:
    """Times at the recurrentgemma-2b prefill shape in bf16.  No single
    PyTorch call computes this recurrence, so there is no yardstick."""
    import torch

    from repro_torch.kernels.rglru import rglru, rglru_plain
    name, b, s, r, a_const = RGLRU_SHAPES[0]
    a, x = rglru_inputs(gen, dev, b, s, r, a_const, torch.bfloat16)
    ms = cuda_ms(lambda: rglru(a, x))
    a32, x32 = a.float(), x.float()
    fp32_ms = cuda_ms(lambda: rglru(a32, x32))
    plain_ms = cuda_ms(lambda: rglru_plain(a, x), iters=3, warmup=1)
    n = b * s * r
    # per element: a*a, 1-, max, sqrt, *x, a*h, + (fp32, no tensor cores);
    # bytes: a and x read once, h written once (bf16), h_last (fp32)
    nbytes = 3 * n * 2 + b * r * 4
    return {"ms": ms, "fp32_ms": fp32_ms, "plain_ms": plain_ms,
            "library_ms": None,
            **bound(7.0 * n, PEAK_F32_OPS_PER_S, nbytes),
            "max_abs_err": max_err[(name, "bfloat16")],
            "tol": RGLRU_TOL["bfloat16"],
            "at": f"{name} B={b} S={s} R={r} bf16"}


def serve_slice(cfg, dev, prompts, *, max_len: int, counters: dict,
                compare_wave: int, plain_kw: dict) -> dict:
    """Serve ``prompts`` (16 new tokens each) on 4 slots through the
    kernels, counting each kernel's launches; then hold wave
    ``compare_wave``'s prefill logits against the same prefill with
    ``plain_kw`` (the kernels' plain versions), in fp32 and in bf16."""
    import numpy as np
    import torch

    from repro_torch.models import zoo
    from repro_torch.models.common import cast_matrices, tree_leaves
    from repro_torch.serving import Request, ServeEngine

    t0 = time.perf_counter()
    params = cast_matrices(
        zoo.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev),
        cfg.activation_dtype)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    assert all(t.device.type == dev.type for t in tree_leaves(params))

    # warm-up (cuBLAS handles, kernel libraries), not counted
    warm = ServeEngine(cfg, params, n_slots=4, max_len=max_len)
    for i in range(2):
        warm.submit(Request(rid=i, prompt=prompts[i][:64 - 7 * i],
                            max_new_tokens=2))
    warm.run()

    engine = ServeEngine(cfg, params, n_slots=4, max_len=max_len)
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=16))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kernel in counters:
        kernel.launches = 0
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {kernel.__name__: kernel.launches for kernel in counters}
    peak = torch.cuda.max_memory_allocated()

    assert len(done) == len(prompts)
    assert all(len(r.output) == 16 for r in done), [len(r.output)
                                                   for r in done]
    assert engine.prefill_calls > len(engine.stats), "no exact re-prefill ran"
    # every launch belongs to a prefill: decode launches neither kernel
    for kernel, per_prefill in counters.items():
        assert launches[kernel.__name__] == \
            per_prefill * engine.prefill_calls > 0, (
                kernel.__name__, launches, engine.prefill_calls)
    tokens = sum(len(r.output) for r in done)

    # one wave's prompts, left-padded as the engine pads them: kernel path
    # against the plain path (launches here are not counted)
    wave = prompts[4 * compare_wave:4 * compare_wave + 4]
    plen = max(len(p) for p in wave)
    padded = np.zeros((4, plen), np.int32)
    for i, p in enumerate(wave):
        padded[i, plen - len(p):] = p
    batch = {"tokens": torch.as_tensor(padded, dtype=torch.int64, device=dev)}
    cache_len = zoo.cache_max_len(cfg, min(max_len, plen + 16))
    lg, cache = zoo.prefill(cfg, params, batch, cache_len)
    lg_plain, _ = zoo.prefill(cfg, params, batch, cache_len, **plain_kw)
    # the same weights with fp32 activations (the bf16 matrices upcast
    # where they are used)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    lg32, _ = zoo.prefill(cfg32, params, batch, cache_len)
    lg32_plain, _ = zoo.prefill(cfg32, params, batch, cache_len, **plain_kw)
    torch.cuda.synchronize()
    assert cache["k"].device.type == dev.type
    assert cache["k"].shape[1] == cache_len
    assert tuple(lg.shape) == (4, cfg.padded_vocab)
    assert lg.dtype == torch.bfloat16 and lg32.dtype == torch.float32
    for t in (lg, lg_plain, lg32, lg32_plain):
        assert torch.isfinite(t).all()
    lg, lg_plain = lg.float(), lg_plain.float()
    err32 = float((lg32 - lg32_plain).abs().max())
    tol32 = LOGIT_RTOL["float32"] * float(lg32_plain.abs().max())
    logit_err = float((lg - lg_plain).abs().max())
    logit_tol = LOGIT_RTOL["bfloat16"] * float(lg_plain.abs().max())
    own_bf16_err = float((lg_plain - lg32_plain).abs().max())
    top2 = lg_plain.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * logit_tol
    same_argmax = bool(torch.equal(lg.argmax(-1)[clear],
                                   lg_plain.argmax(-1)[clear]))
    result = {
        "phase": "slice", "arch": cfg.arch_id, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model,
        "params": sum(t.numel() for t in tree_leaves(params)),
        "init_s": init_s, "requests": len(done),
        "prompt_lens": [len(p) for p in prompts], "generated_tokens": tokens,
        "waves": len(engine.stats), "prefill_calls": engine.prefill_calls,
        "launches": launches, "wall_s": wall, "tokens_per_s": tokens / wall,
        "prefill_s": engine.prefill_s, "decode_s": engine.decode_s,
        "peak_mem_bytes": peak,
        "mean_slot_utilization": engine.mean_slot_utilization,
        "compared_wave": compare_wave, "compared_prompt_len": plen,
        "compared_cache_len": cache_len,
        "fp32_logits_max_abs_err_vs_plain": err32, "fp32_logits_tol": tol32,
        "logits_max_abs_err_vs_plain": logit_err, "logits_tol": logit_tol,
        "plain_bf16_err_vs_fp32": own_bf16_err,
        "logits_abs_max": float(lg_plain.abs().max()),
        "rows_with_clear_argmax": int(clear.sum()),
        "same_argmax_vs_plain": same_argmax}
    emit(result)
    assert err32 <= tol32, (err32, tol32)
    assert logit_err <= max(logit_tol, own_bf16_err), (
        logit_err, logit_tol, own_bf16_err)
    assert same_argmax
    del params, cache, lg, lg_plain, lg32, lg32_plain
    torch.cuda.empty_cache()
    return result


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention)
    from repro_torch.kernels.rglru import rglru, rglru_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. card ---------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "card", "device": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": built, "sources": sorted(_build.sources())})

    # 3. kernel checks ------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    fa_err = check_flash(gen, dev)
    rg_err = check_rglru(gen, dev)

    # 4. kernel times -------------------------------------------------------
    fa = {"name": "flash_attention", "route": "cuda",
          "source": "src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention.cu",
          "replaces": "src/repro/kernels/flash_attention/kernel.py:96",
          **time_flash(gen, dev, KERNEL_SHAPES[0], fa_err)}
    fa_d256 = time_flash(gen, dev, KERNEL_SHAPES[-1], fa_err)
    rg = {"name": "rglru", "route": "cuda",
          "source": "src/repro_torch/kernels/rglru/csrc/rglru.cu",
          "replaces": "src/repro/kernels/rglru/kernel.py:56",
          **time_rglru(gen, dev, rg_err)}
    for name, t in (("flash_attention", fa), ("flash_attention", fa_d256),
                    ("rglru", rg)):
        emit({"phase": "kernel_time", "kernel": name, **{k_: t[k_] for k_ in (
            "ms", "fp32_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "at")}})

    # 5. slice: olmo-1b at full width ----------------------------------------
    rng = np.random.default_rng(0)
    cfg = get_config("olmo-1b")
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(64, 513, size=8)]
    assert any(len(p) % 64 for p in prompts), "no ragged prompt length"
    olmo = serve_slice(cfg, dev, prompts, max_len=1024,
                       counters={flash_attention: cfg.n_layers},
                       compare_wave=0,
                       plain_kw={"self_attn": attention_plain})

    # 6. slice: recurrentgemma-2b at full width ------------------------------
    cfg = get_config("recurrentgemma-2b")
    lens = [*rng.integers(64, 513, size=4), *rng.integers(1500, 2601, size=4)]
    if max(lens[4:]) <= cfg.window:           # one prompt past the window
        lens[4] = 2600
    if not any(n % 64 for n in lens[4:]):      # one ragged long prompt
        lens[5] += 1
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in lens]
    # per prefill: 18 recurrent blocks, 8 local-attention blocks
    rgemma = serve_slice(
        cfg, dev, prompts, max_len=4096,
        counters={rglru: 18, flash_attention: 8}, compare_wave=1,
        plain_kw={"self_attn": attention_plain, "rglru_fn": rglru_plain})
    assert rgemma["compared_prompt_len"] > cfg.window == \
        rgemma["compared_cache_len"]

    # 7. kernels line, card line, result --------------------------------------
    by_path = {"olmo-1b": olmo["launches"]["flash_attention"],
               "recurrentgemma-2b": rgemma["launches"]["flash_attention"]}
    fa["launches"] = sum(by_path.values())
    rg["launches"] = rgemma["launches"]["rglru"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "tol", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "at")
    emit({"kernels": [
        {**{k_: fa[k_] for k_ in keys}, "launches_by_path": by_path,
         "at_d256": {k_: fa_d256[k_] for k_ in keys if k_ in fa_d256}},
        {k_: rg[k_] for k_ in keys}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
