#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, one JSON line each:
  1. card    the device name and ``nvidia-smi`` name and power limit;
  2. build   nvcc builds every CUDA kernel from the checkout's sources;
  3. kernel  flash attention against its plain version (``attention_plain``)
             on the card, bf16 and fp32, at the olmo-1b prefill shape, a
             GQA shape, a ragged length, a window, D=16 and S=1; times of
             the kernel, the plain version and PyTorch's
             ``scaled_dot_product_attention`` (a yardstick the port never
             calls), and the least time the card could take (bound);
  4. slice   olmo-1b at full width (random weights from seed 0, bf16
             activations) served by ``ServeEngine``: 8 requests of 64-512
             prompt tokens on 4 slots, 16 new tokens each.  Every flash
             launch counter is zeroed just before and read just after;
             the prefill logits are held against the same prefill with
             attention through the plain version.
Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises: the script
exits non-zero with its traceback.  Without CUDA it exits 2 and prints
no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core rate
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# prefill logits, kernel path vs plain-attention path, olmo-1b bf16: both
# compute attention in fp32 and round its output to bf16, so they differ
# where that rounding flips, and 16 bf16 layers carry the flips on.  The
# tolerance is the kernel tests' bf16 one relative to the largest logit
# (bf16 logits are only that exact); the greedy token must also agree
# wherever the plain path's top-2 margin is above twice the tolerance.
LOGIT_RTOL = TOL["bfloat16"]

# (name, B, S, H, K, D, window)
KERNEL_SHAPES = [
    ("olmo-1b prefill", 4, 512, 16, 16, 128, None),
    ("granite GQA", 2, 512, 32, 8, 128, None),
    ("ragged S=300", 2, 300, 16, 16, 128, None),
    ("window 64", 2, 512, 16, 16, 128, 64),
    ("D=16", 2, 128, 4, 4, 16, None),
    ("S=1", 4, 1, 16, 16, 128, None),
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention)
    from repro_torch.models import zoo
    from repro_torch.models.common import cast_matrices, tree_leaves
    from repro_torch.serving import Request, ServeEngine

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

    # 3. kernel check -------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = {}
    fa = {"name": "flash_attention", "route": "cuda",
          "source": "src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention.cu",
          "replaces": "src/repro/kernels/flash_attention/kernel.py:96"}
    for name, b, s, h, kh, d, window in KERNEL_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).removeprefix("torch.")
            q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
            k = torch.randn((b, s, kh, d), generator=gen, device=dev).to(dtype)
            v = torch.randn((b, s, kh, d), generator=gen, device=dev).to(dtype)
            out = flash_attention(q, k, v, causal=True, window=window)
            ref = attention_plain(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            worst = float((err - TOL[dn] * ref.float().abs()).max())
            check = {"phase": "kernel", "kernel": "flash_attention",
                     "shape": name, "B": b, "S": s, "H": h, "K": kh, "D": d,
                     "window": window, "dtype": dn,
                     "max_abs_err": float(err.max()), "tol": TOL[dn],
                     "ok": bool(worst <= TOL[dn]
                                and torch.isfinite(out).all())}
            emit(check)
            assert check["ok"], check
            max_err[(name, dn)] = check["max_abs_err"]

    # timing at the olmo-1b prefill shape in the main path's dtype (bf16)
    name, b, s, h, kh, d, window = KERNEL_SHAPES[0]
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device=dev)
               .to(torch.bfloat16) for n in (h, kh, kh))
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True))
    q32, k32, v32 = (t.float() for t in (q, k, v))
    fp32_ms = cuda_ms(lambda: flash_attention(q32, k32, v32, causal=True))
    del q32, k32, v32
    plain_ms = cuda_ms(lambda: attention_plain(q, k, v, causal=True))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    pairs = s * (s + 1) // 2
    flops = 4.0 * b * h * d * pairs
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    op_ms = flops / PEAK_BF16_OPS_PER_S * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    fa.update({"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": max(op_ms, byte_ms),
               "bound_by": "operations" if op_ms > byte_ms else "bytes",
               "max_abs_err": max_err[(name, "bfloat16")],
               "tol": TOL["bfloat16"], "at": f"{name} B={b} S={s} H={h} "
                                             f"K={kh} D={d} bf16 causal",
               "flops": flops, "bytes": nbytes})
    emit({"phase": "kernel_time", "fp32_ms": fp32_ms, **{k_: fa[k_] for k_ in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "at")}})
    del q, k, v, qt, kt, vt

    # 4. slice: olmo-1b at full width served on the card ---------------------
    cfg = get_config("olmo-1b")
    t0 = time.perf_counter()
    params = cast_matrices(
        zoo.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev),
        cfg.activation_dtype)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    assert all(t.is_cuda for t in tree_leaves(params))
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, size=8)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in lens]

    # warm-up (cuBLAS handles, kernel library load), not counted
    warm = ServeEngine(cfg, params, n_slots=4, max_len=1024)
    for i in range(2):
        warm.submit(Request(rid=i, prompt=prompts[i][:64 - 7 * i],
                            max_new_tokens=2))
    warm.run()

    engine = ServeEngine(cfg, params, n_slots=4, max_len=1024)
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=16))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    fa["launches"] = launches
    peak = torch.cuda.max_memory_allocated()

    assert len(done) == len(prompts)
    assert all(len(r.output) == 16 for r in done), [len(r.output)
                                                   for r in done]
    assert engine.prefill_calls > len(engine.stats), "no exact re-prefill ran"
    assert any(int(n) % 64 for n in lens), "no ragged prompt length"
    assert launches == cfg.n_layers * engine.prefill_calls > 0, (
        launches, engine.prefill_calls)
    tokens = sum(len(r.output) for r in done)

    # the first wave's prompts, left-padded as the engine pads them: kernel
    # path against the plain attention path (launches here are not counted)
    wave = prompts[:4]
    plen = max(len(p) for p in wave)
    padded = np.zeros((4, plen), np.int32)
    for i, p in enumerate(wave):
        padded[i, plen - len(p):] = p
    batch = {"tokens": torch.as_tensor(padded, dtype=torch.int64, device=dev)}
    cache_len = zoo.cache_max_len(cfg, plen + 16)
    lg, cache = zoo.prefill(cfg, params, batch, cache_len)
    lg_plain, _ = zoo.prefill(cfg, params, batch, cache_len,
                              self_attn=attention_plain)
    torch.cuda.synchronize()
    assert cache["k"].is_cuda and cache["v"].is_cuda
    assert tuple(lg.shape) == (4, cfg.padded_vocab)
    assert torch.isfinite(lg).all() and torch.isfinite(lg_plain).all()
    logit_err = float((lg.float() - lg_plain.float()).abs().max())
    logit_tol = LOGIT_RTOL * float(lg_plain.float().abs().max())
    top2 = lg_plain.float().topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * logit_tol
    same_argmax = bool(torch.equal(lg.argmax(-1)[clear],
                                   lg_plain.argmax(-1)[clear]))
    emit({"phase": "slice", "arch": cfg.arch_id, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": sum(
              t.numel() for t in tree_leaves(params)),
          "init_s": init_s, "requests": len(done),
          "prompt_lens": [int(n) for n in lens], "generated_tokens": tokens,
          "waves": len(engine.stats), "prefill_calls": engine.prefill_calls,
          "flash_launches": launches, "wall_s": wall,
          "tokens_per_s": tokens / wall, "prefill_s": engine.prefill_s,
          "decode_s": engine.decode_s, "peak_mem_bytes": peak,
          "mean_slot_utilization": engine.mean_slot_utilization,
          "logits_max_abs_err_vs_plain": logit_err,
          "logits_tol": logit_tol, "logits_abs_max": float(
              lg_plain.float().abs().max()),
          "rows_with_clear_argmax": int(clear.sum()),
          "same_argmax_vs_plain": same_argmax})
    assert logit_err <= logit_tol, (logit_err, logit_tol)
    assert same_argmax

    # 5. kernels line, card line, result --------------------------------------
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "tol", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k_: fa[k_] for k_ in keys}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
