"""The port on a CUDA card: the flash attention (causal and not), RG-LRU
and WKV6 kernels against their plain versions, the serving paths through
the kernels (the vlm and audio smoke configs too), the
gradients through the kernels' autograd Functions against the CPU plain
path, one olmo-1b and one mixtral-8x7b smoke train step on the card
against the same step on the CPU, the mixtral-8x7b smoke forward, loss,
prefill and decode on the card against the CPU, and a smoke run on the
card through ``run_with_recovery`` with a failure after a save, which
must restore onto the card and end in the uninterrupted run's state.

Every test here is marked ``cuda`` and skips without a card; the file
imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import attention_plain, flash_attention
from repro_torch.kernels.rglru import rglru, rglru_plain
from repro_torch.kernels.rwkv6 import wkv6, wkv6_plain
from repro_torch.models import layers, zoo
from repro_torch.models.common import tree_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.serving import Request, ServeEngine
from repro_torch.data import DataConfig, make_source
from repro_torch.train import (CheckpointManager, TrainConfig, init_state,
                               make_train_step, run_with_recovery)

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
RGLRU_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# (atol, rtol): test_kernels.py's WKV6 tolerances in float32 (5e-4 and 5e-3
# under strong decay), the kernel tests' 2e-2 in bfloat16
WKV6_TOL = {torch.float32: (3e-4, 1e-3), torch.bfloat16: (2e-2, 2e-2)}
WKV6_STRONG_TOL = {torch.float32: (5e-4, 5e-3), torch.bfloat16: (2e-2, 2e-2)}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("b,s,h,kh,d,window", [
    (2, 512, 16, 16, 128, None),     # olmo-1b prefill heads
    (1, 300, 32, 8, 128, None),      # GQA, ragged length
    (1, 512, 8, 8, 128, 64),         # sliding window
    (2, 100, 4, 4, 16, None),        # smoke head dim
    (2, 77, 4, 2, 32, 16),
    (1, 200, 8, 1, 64, None),        # MQA
    (3, 1, 4, 2, 64, None),          # one token
    (1, 300, 10, 1, 256, 128),       # recurrentgemma heads, window
    (2, 64, 4, 1, 256, None),        # head dim 256, GQA 4/1
    # tile classes of the bf16 TMA/wgmma kernel (128 query rows, 64 keys)
    (2, 192, 16, 16, 128, None),     # S not a multiple of 128
    (2, 37, 16, 16, 128, None),      # S under one k-tile
    (2, 512, 16, 16, 128, 40),       # window under one k-tile
    (2, 640, 8, 1, 256, None),       # D=256 causal, no window
    (4, 2600, 10, 1, 256, 2048),     # recurrentgemma-2b prefill
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda_device, b, s, h, kh, d, window, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device=cuda_device)
               .to(dtype) for n in (h, kh, kh))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = attention_plain(q, k, v, causal=True, window=window)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("b,s,h,kh,d", [
    (4, 1500, 12, 12, 64),           # whisper-small encoder
    (2, 37, 16, 16, 128),            # S under one k-tile
    (2, 192, 32, 8, 128),            # GQA, S not a multiple of 128
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_non_causal_kernel_matches_plain(cuda_device, b, s, h, kh, d, dtype):
    """Every key is visible to every query: the ragged edges of the last
    q-tile and k-tile run with the causal clause off."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device=cuda_device)
               .to(dtype) for n in (h, kh, kh))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = attention_plain(q, k, v, causal=False)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_non_contiguous_heads_are_read_through_strides(cuda_device, d,
                                                       dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn((2, 96, 3, 4, d), generator=gen,
                      device=cuda_device).to(dtype)
    q, k, v = qkv.unbind(2)                  # (B,S,H,D) views, stride 3*H*D
    out = flash_attention(q, k, v)
    torch.testing.assert_close(out.float(), attention_plain(q, k, v).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_serving_goes_through_the_kernel(cuda_device):
    cfg = get_config("olmo-1b", smoke=True)
    params = zoo.init(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                      device=cuda_device)
    eng = ServeEngine(cfg, params, n_slots=2, max_len=32)
    rng = np.random.default_rng(0)
    for i, n in enumerate((9, 5, 7)):
        eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, n)
                           .astype(np.int32), max_new_tokens=3))
    before = flash_attention.launches
    done = eng.run()
    assert all(len(r.output) == 3 for r in done)
    # waves (9,5) and (7): one wave prefill each + one re-prefill for 5
    assert eng.prefill_calls == 3
    assert flash_attention.launches - before == cfg.n_layers * 3


@pytest.mark.parametrize("b,s,r,a_const", [
    (2, 128, 64, None),
    (1, 37, 130, None),      # ragged S, R not a multiple of the block
    (3, 1, 32, None),        # one step
    (1, 64, 32, 1e-6),       # extreme decay
    (1, 2382, 2560, None),   # recurrentgemma-2b's B=1 exact re-prefill
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_kernel_matches_plain(cuda_device, b, s, r, a_const, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    if a_const is None:       # a ~ U(0.001, 0.9995)
        a = 0.001 + 0.9985 * torch.rand((b, s, r), generator=gen,
                                        device=cuda_device)
    else:
        a = torch.full((b, s, r), a_const, device=cuda_device)
    a = a.to(dtype)
    x = torch.randn((b, s, r), generator=gen, device=cuda_device).to(dtype)
    before = rglru.launches
    h, h_last = rglru(a, x)
    torch.cuda.synchronize()
    assert rglru.launches == before + 1
    assert h.dtype == dtype and h_last.dtype == torch.float32
    ref, ref_last = rglru_plain(a, x)
    tol = RGLRU_TOL[dtype]
    torch.testing.assert_close(h.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h_last, ref_last, atol=tol, rtol=tol)
    # rounded as the plain version rounds: equal, not only close
    assert torch.equal(h, ref) and torch.equal(h_last, ref_last)


def test_recurrentgemma_serving_goes_through_both_kernels(cuda_device):
    cfg = get_config("recurrentgemma-2b", smoke=True)
    params = zoo.init(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                      device=cuda_device)
    eng = ServeEngine(cfg, params, n_slots=2, max_len=32)
    rng = np.random.default_rng(0)
    for i, n in enumerate((11, 6, 9)):
        eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, n)
                           .astype(np.int32), max_new_tokens=3))
    before = (rglru.launches, flash_attention.launches)
    done = eng.run()
    assert all(len(r.output) == 3 for r in done)
    # waves (11,6) and (9): one wave prefill each + one re-prefill for 6;
    # per prefill 4 recurrent blocks and 1 attention block, none in decode
    assert eng.prefill_calls == 3
    assert rglru.launches - before[0] == 4 * 3
    assert flash_attention.launches - before[1] == 1 * 3


@pytest.mark.parametrize("b,h,s,d,w_range,floor", [
    (2, 4, 128, 64, (0.5, 0.999), 1e-38),     # rwkv6-1.6b heads
    (1, 3, 300, 32, (0.5, 0.999), 1e-8),      # ragged S
    (2, 2, 37, 16, (0.5, 0.999), 1e-8),       # prime S, smoke head dim
    (3, 2, 1, 64, (0.5, 0.999), 1e-8),        # one step
    (1, 2, 128, 64, (1e-4, 0.2), 1e-38),      # strong decay
    (1, 2, 96, 64, (0.0, 1e-7), 1e-8),        # decays at and below the floor
    (1, 32, 3318, 64, (0.5, 0.999), 1e-8),    # rwkv6-1.6b's B=1 re-prefill
    (4, 32, 100, 64, (0.5, 0.999), 1e-8),     # B*H >= 128: 8 x 4 a thread
    (4, 32, 37, 32, (0.5, 0.999), 1e-8),      # the same at D=32, ragged
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_matches_plain(cuda_device, b, h, s, d, w_range, floor,
                                   dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    # (B,S,H,D) activations viewed as (B,H,S,D), as the model passes them
    r, k, v = (torch.randn((b, s, h, d), generator=gen, device=cuda_device)
               .to(dtype).transpose(1, 2) for _ in range(3))
    lo, hi = w_range
    w = lo + (hi - lo) * torch.rand((b, s, h, d), generator=gen,
                                    device=cuda_device)
    if lo == 0.0:
        w[..., ::3] = 0.0
    w = w.to(dtype).transpose(1, 2)
    u = 0.5 * torch.randn((h, d), generator=gen, device=cuda_device)
    before = wkv6.launches
    out, state = wkv6(r, k, v, w, u, floor=floor)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    assert out.dtype == dtype and state.dtype == torch.float32
    assert torch.isfinite(out.float()).all() and torch.isfinite(state).all()
    ref, ref_state = wkv6_plain(r, k, v, w, u, floor=floor)
    atol, rtol = (WKV6_STRONG_TOL if hi <= 0.2 else WKV6_TOL)[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(state, ref_state, atol=atol, rtol=rtol)
    # the state is rounded as the plain version rounds it: equal
    assert torch.equal(state, ref_state)


def test_rwkv6_serving_goes_through_the_kernel(cuda_device):
    # smoke widths at the full model's 24 layers: 24 launches per prefill
    cfg = dataclasses.replace(get_config("rwkv6-1.6b", smoke=True),
                              n_layers=24)
    params = zoo.init(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                      device=cuda_device)
    eng = ServeEngine(cfg, params, n_slots=2, max_len=32)
    rng = np.random.default_rng(0)
    for i, n in enumerate((67, 6, 9)):
        eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, n)
                           .astype(np.int32), max_new_tokens=3))
    before = wkv6.launches
    done = eng.run()
    assert all(len(r.output) == 3 for r in done)
    # waves (67,6) and (9): one wave prefill each + one re-prefill for 6;
    # one launch per layer and prefill, none in decode
    assert eng.prefill_calls == 3
    assert wkv6.launches - before == 24 * 3


# gradients through the kernel paths (float32), each input's largest gap
# over its largest |g| on the CPU plain path: the kernels' forward errors
# (at most 2e-5, see TOL) and the card's other summation orders in the
# recomputed backward
GRAD_RTOL = 1e-4


def _rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.cpu() - want).abs().max() / want.abs().max())


def _kernel_inputs(kernel, gen):
    if kernel == "flash_attention":     # olmo-1b heads, a window
        shapes = [(2, 96, 16, 128), (2, 96, 16, 128), (2, 96, 16, 128)]
        ins = [torch.randn(sh, generator=gen) for sh in shapes]
    elif kernel == "rglru":
        a = 0.001 + 0.9985 * torch.rand((2, 64, 256), generator=gen)
        ins = [a, torch.randn((2, 64, 256), generator=gen)]
    else:                                # (B,H,S,D), decays near the floor
        ins = [torch.randn((2, 4, 64, 64), generator=gen) for _ in range(3)]
        ins.append(torch.exp(-torch.exp(-8.0 + 11.5 * torch.rand(
            (2, 4, 64, 64), generator=gen))))
        ins.append(0.5 * torch.randn((4, 64), generator=gen))
    return ins


def _kernel_call(kernel, ins):
    if kernel == "flash_attention":
        return (layers.attention(*ins, causal=True, window=48),)
    if kernel == "rglru":
        return rglru(*ins)
    return wkv6(*ins, floor=1e-8)


def _plain_call(kernel, ins):
    if kernel == "flash_attention":
        return (attention_plain(*ins, causal=True, window=48),)
    if kernel == "rglru":
        return rglru_plain(*ins)
    return wkv6_plain(*ins, floor=1e-8)


@pytest.mark.parametrize("kernel", [flash_attention, rglru, wkv6],
                         ids=lambda k: k.__name__)
def test_kernel_gradients_match_cpu_plain(cuda_device, kernel):
    name = kernel.__name__
    gen = torch.Generator().manual_seed(0)
    ins = _kernel_inputs(name, gen)
    # copies taken as each is made: a failure says which changed since
    made = {"ins": [t.clone() for t in ins]}
    # the plain RG-LRU's elementwise stages, computed first and kept: a
    # failure names the first stage that a repeat does not reproduce
    stages = _rglru_stages(*ins) if name == "rglru" else None
    outs = _kernel_call(name, [t.requires_grad_(True) for t in ins])
    cots = [torch.randn(o.shape, generator=gen) for o in outs]
    made["cots"] = [c.clone() for c in cots]
    want = torch.autograd.grad(outs, ins, cots)
    made["want"] = [w.clone() for w in want]
    # the same CPU computation once more, before the card is touched
    repeat_outs, repeat = _cpu_grads(name, made["ins"], made["cots"])
    if stages is not None:
        differs = _first_stage_differing(stages, _rglru_stages(*made["ins"]))
        assert differs is None, differs
    dev_ins = [t.detach().to(cuda_device).requires_grad_(True) for t in ins]
    before = kernel.launches
    dev_outs = _kernel_call(name, dev_ins)
    assert kernel.launches == before + 1
    got = torch.autograd.grad(dev_outs, dev_ins,
                              [c.to(cuda_device) for c in cots])
    # every input gets a gradient, and it is the plain path's; a failure
    # also prints what changed since it was made, the CPU repeat's gaps
    # and where it differs, and the same gradients computed once more on
    # each side
    for i, (g, w) in enumerate(zip(got, want)):
        assert g is not None and g.device.type == "cuda", (name, i)
        if _rel_gap(g, w) > GRAD_RTOL:
            print(json.dumps({
                "changed_since_made": {
                    key: [_changed(now, then) for now, then in
                          zip({"ins": ins, "cots": cots, "want": want}[key],
                              copies)]
                    for key, copies in made.items()},
                "cpu_repeat": [_rel_gap(r, w) for r, w in zip(repeat, want)],
                "cpu_repeat_differs_at": [_changed(r, w) for r, w in
                                          zip(repeat, want)],
                "cpu_repeat_outputs_differ_at": [
                    _changed(r, o.detach()) for r, o in zip(repeat_outs,
                                                            outs)],
                "again": _gradients_again(name, ins, cots, want,
                                          cuda_device)}))
        assert _rel_gap(g, w) <= GRAD_RTOL, (name, i, _rel_gap(g, w))


def _rglru_stages(a, x):
    """``rglru_plain``'s elementwise stages before its scan, in its order:
    a², 1 - a², the clamp at 1e-12, the sqrt and the product with x."""
    af = a.detach().float()
    aa = af * af
    one_minus = 1.0 - aa
    clamped = torch.clamp(one_minus, min=1e-12)
    root = torch.sqrt(clamped)
    return {"a*a": aa, "1-a*a": one_minus, "clamp": clamped, "sqrt": root,
            "sqrt*x": root * x.detach().float()}


def _first_stage_differing(first: dict, again: dict):
    """None if every stage equals its repeat bit for bit; else the first
    stage that does not, where it differs, and whether its input did."""
    names = list(first)
    for i, stage in enumerate(names):
        where = _changed(first[stage], again[stage])
        if where is not None:
            return {"stage": stage, "differs_at": where,
                    "input_differs_at": (_changed(first[names[i - 1]],
                                                  again[names[i - 1]])
                                         if i else None)}
    return None


def _cpu_grads(name, ins, cots):
    """The outputs and the gradients of ``_kernel_call`` on copies of
    ``ins``."""
    leaves = [t.detach().clone().requires_grad_(True) for t in ins]
    outs = _kernel_call(name, leaves)
    return ([o.detach() for o in outs],
            torch.autograd.grad(outs, leaves, cots))


def _changed(now: torch.Tensor, then: torch.Tensor):
    """None if ``now`` equals ``then`` bit for bit; else how many elements
    differ, the first of them and its two values."""
    now = now.detach()
    diff = now.view(torch.int32) != then.view(torch.int32)
    if not diff.any():
        return None
    idx = diff.nonzero()
    first, last = tuple(idx[0].tolist()), tuple(idx[-1].tolist())
    return {"n": int(diff.sum()), "first": first, "last": last,
            "then": float(then[first]), "now": float(now[first])}


@pytest.mark.parametrize("between", ["nothing", "card work", "card busy"])
def test_rglru_cpu_gradients_repeat_bit_for_bit(cuda_device, between):
    """The CPU part of the rglru case above, 100 times in this process
    that uses the card, with nothing, a card matmul and a sync, or the
    card kept busy between: every repeat equals the first bit for bit
    (ROADMAP Faults item 6: in whole-file runs that case's first CPU
    computation is sometimes off in one aligned eighth of its forward)."""
    big = torch.randn((4096, 4096), device=cuda_device)
    work = {"nothing": lambda: None,
            "card work": lambda: (big @ big).sum().item(),
            "card busy": lambda: (torch.cuda._sleep(20_000_000),
                                  big @ big)}[between]

    def once():
        gen = torch.Generator().manual_seed(0)
        ins = _kernel_inputs("rglru", gen)
        outs = _kernel_call("rglru", [t.requires_grad_(True) for t in ins])
        cots = [torch.randn(o.shape, generator=gen) for o in outs]
        return [o.detach() for o in outs] + list(
            torch.autograd.grad(outs, ins, cots))

    first = once()
    for i in range(100):
        work()
        again = once()
        assert all(torch.equal(a, f) for a, f in zip(again, first)), (
            i, [_changed(a, f) for a, f in zip(again, first)])
    torch.cuda.synchronize()


def _gradients_again(name, ins, cots, want, device) -> dict:
    """The relative gaps to ``want`` of the CPU gradients and the CUDA
    gradients computed again, and of the plain version's VJP on CUDA."""
    def grads(dev, plain=False):
        leaves = [t.detach().to(dev).requires_grad_(True) for t in ins]
        outs = (_plain_call(name, leaves) if plain
                else _kernel_call(name, leaves))
        return torch.autograd.grad(outs, leaves, [c.to(dev) for c in cots])
    return {side: [_rel_gap(g, w) for g, w in zip(grads(dev, plain), want)]
            for side, dev, plain in (("cpu", "cpu", False),
                                     ("cuda", device, False),
                                     ("cuda_plain", device, True))}


def _train_step_on_cuda_matches_cpu(arch, device):
    """One smoke ``make_train_step`` step (2 microbatches, remat) on the
    card against the same step on the CPU; returns flash's launches."""
    cfg = get_config(arch, smoke=True)
    tcfg = TrainConfig(microbatches=2, remat=True, optimizer=AdamWConfig(
        lr=5e-3, total_steps=10, warmup_steps=1))
    cpu_state = init_state(cfg, tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    dev_state = _to(cpu_state, device)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 32)))
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, dims=1)}
    step = make_train_step(cfg, tcfg)
    cpu_new, cpu_m = step(cpu_state, batch)
    before = flash_attention.launches
    dev_new, dev_m = step(dev_state, _to(batch, device))
    launched = flash_attention.launches - before
    for name in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(dev_m[name]), float(cpu_m[name]),
                                   rtol=GRAD_RTOL, err_msg=name)
    for part in ("mu", "nu"):
        for got, want in zip(tree_leaves(dev_new["opt"][part]),
                             tree_leaves(cpu_new["opt"][part])):
            if want.abs().max() > 0:
                assert _rel_gap(got, want) <= GRAD_RTOL, part
    # Adam's first step is about lr * sign(g): compare the params where g
    # is far above the two devices' gradient gap, or zero on both
    for mu_d, mu_c, p_d, p_c in zip(
            tree_leaves(dev_new["opt"]["mu"]),
            tree_leaves(cpu_new["opt"]["mu"]),
            tree_leaves(dev_new["params"]), tree_leaves(cpu_new["params"])):
        mu_d = mu_d.cpu()
        gap = (mu_d - mu_c).abs().max()
        stable = (mu_c.abs() >= 100 * gap) | ((mu_c == 0) & (mu_d == 0))
        assert stable.float().mean() >= 0.9
        err = (p_d.cpu() - p_c).abs()[stable].max()
        assert err <= 1e-6 * p_c.abs().max(), float(err)
    return launched


def test_smoke_train_step_on_cuda_matches_cpu(cuda_device):
    # 2 layers x 2 microbatches x (forward + remat recompute)
    assert _train_step_on_cuda_matches_cpu("olmo-1b", cuda_device) == 8


def test_mixtral_smoke_train_step_on_cuda_matches_cpu(cuda_device):
    """The MoE family's step: routing, aux loss and expert gradients."""
    assert _train_step_on_cuda_matches_cpu("mixtral-8x7b", cuda_device) == 8


def test_mixtral_smoke_serving_on_cuda_matches_cpu(cuda_device):
    """mixtral-8x7b smoke (top-2 MoE, window 8) on the card through the
    flash kernel: forward logits and aux, loss, prefill and 2 decode steps
    (the cache keeps the window's last 8 tokens, so both steps wrap its
    ring buffer) against the CPU plain path on the same params, within
    1e-4."""
    cfg = get_config("mixtral-8x7b", smoke=True)
    params = zoo.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 13)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    dec = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 2)))
    max_len = zoo.cache_max_len(cfg, 16)

    def run(device):
        p, b = _to(params, device), _to(batch, device)
        with torch.no_grad():
            logits, aux = zoo.forward(cfg, p, b)
            loss, parts = zoo.loss_fn(cfg, p, b)
            out = [logits, aux, loss, parts["ce"]]
            lg, cache = zoo.prefill(cfg, p, b, max_len)
            out.append(lg)
            for i, pos in enumerate((12, 13)):
                lg, cache = zoo.decode_step(cfg, p, cache, dec[:, i].to(
                    device), pos)
                out += [lg, cache["k"].clone(), cache["v"].clone()]
        return out

    want = run("cpu")
    before = flash_attention.launches
    got = run(cuda_device)
    # forward, loss and prefill each run both layers through the kernel
    assert flash_attention.launches - before == 3 * cfg.n_layers
    assert float(want[1]) > 0.0
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-4)


def _frontend_params(arch):
    """Smoke params of ``arch`` on the CPU (the vlm's cross gates drawn from
    U(-1, 1)) and a seeded N(0, 1) * 0.02 frontend of one row."""
    cfg = get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(0)
    params = zoo.init(cfg, gen, device="cpu")
    if cfg.family == "vlm":
        for name in ("gate_attn", "gate_mlp"):
            params["supers"]["cross"][name].uniform_(-1.0, 1.0, generator=gen)
    frontend = 0.02 * torch.randn((1, cfg.n_frontend_tokens, cfg.d_model),
                                  generator=gen)
    return cfg, params, frontend


# flash launches a forward or prefill makes: the vlm's self layers, or
# whisper's encoder and decoder self-attention (cross-attention has
# Sq != Sk, so it runs the dense math)
FRONTEND_FLASH = {"llama-3.2-vision-11b": 2, "whisper-small": 4}


@pytest.mark.parametrize("arch", list(FRONTEND_FLASH))
def test_frontend_family_on_cuda_matches_cpu(cuda_device, arch):
    """The vlm and audio smoke configs on the card through the flash
    kernel (whisper's encoder non-causal): forward logits, loss, prefill
    and 2 decode steps (every cache entry) against the CPU plain path on
    the same params, within 1e-4, with flash's exact launch count."""
    cfg, params, frontend = _frontend_params(arch)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 11)))            # 10 prompt tokens: Sq != Sk
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "frontend": frontend.expand(2, -1, -1)}
    dec = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 2)))

    def run(device):
        p, b = _to(params, device), _to(batch, device)
        with torch.no_grad():
            logits, _ = zoo.forward(cfg, p, b)
            loss, _ = zoo.loss_fn(cfg, p, b)
            out = [logits, loss]
            lg, cache = zoo.prefill(cfg, p, b, 16)
            out.append(lg)
            for i, pos in enumerate((10, 11)):
                lg, cache = zoo.decode_step(cfg, p, cache, dec[:, i].to(
                    device), pos)
                out += [lg, *(cache[n].clone() for n in ("k", "v", "xk",
                                                         "xv"))]
        return out

    want = run("cpu")
    before = flash_attention.launches
    got = run(cuda_device)
    assert flash_attention.launches - before == 3 * FRONTEND_FLASH[arch]
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-4)


class _FrontendEngine(ServeEngine):
    """Every prefill gets ``frontend`` (one row, broadcast)."""

    frontend = None

    def _batch_for(self, prompts):
        batch = super()._batch_for(prompts)
        batch["frontend"] = self.frontend.to(self.device).expand(
            batch["frontend"].shape)
        return batch


@pytest.mark.parametrize("arch", list(FRONTEND_FLASH))
def test_frontend_family_serving_on_cuda(cuda_device, arch):
    """``ServeEngine`` on the card: every prefill (the wave prefills and
    the exact re-prefills) launches flash FRONTEND_FLASH times and decode
    none; the tokens are the CPU engine's."""
    cfg, params, frontend = _frontend_params(arch)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (9, 5, 7)]
    outs = {}
    for device in ("cpu", cuda_device):
        eng = _FrontendEngine(cfg, _to(params, device), n_slots=2,
                              max_len=32)
        eng.frontend = frontend
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=3))
        before = flash_attention.launches
        outs[str(device)] = [r.output for r in eng.run()]
        launched = flash_attention.launches - before
    # waves (9,5) and (7): one wave prefill each + one re-prefill for 5
    assert eng.prefill_calls == 3
    assert launched == FRONTEND_FLASH[arch] * 3
    assert outs["cpu"] == outs[str(cuda_device)]


def test_recovery_on_cuda_ends_in_the_uninterrupted_state(cuda_device,
                                                         tmp_path):
    cfg = get_config("olmo-1b", smoke=True)
    tcfg = TrainConfig(microbatches=2, remat=True, optimizer=AdamWConfig(
        lr=5e-3, total_steps=10, warmup_steps=1))
    step_fn = make_train_step(cfg, tcfg)
    source = make_source(DataConfig(seq_len=32, global_batch=4,
                                    vocab=cfg.vocab))
    fails = {"left": 0}

    class Prefetch:           # what run_with_recovery reads of a prefetcher
        pass

    prefetch = Prefetch()
    prefetch.source = source

    def wrapped(state, batch, step):
        if step == 3 and fails["left"]:
            fails["left"] -= 1
            raise RuntimeError("injected failure")
        return step_fn(state, {k: torch.as_tensor(v, device=cuda_device)
                               for k, v in batch.items()})

    finals = []
    for n in range(2):
        fails["left"] = n          # first run uninterrupted, then one failure
        state = init_state(cfg, tcfg, torch.Generator(
            device=cuda_device).manual_seed(0), device=cuda_device)
        manager = CheckpointManager(str(tmp_path / str(n)),
                                    device=cuda_device)
        state, stats = run_with_recovery(
            step_fn=wrapped, state=state, n_steps=4, save_every=2,
            manager=manager, data_prefetch=prefetch)
        assert (stats.failures, stats.restores, stats.steps_replayed) == (
            (0, 0, 0) if n == 0 else (1, 1, 1))
        finals.append(_flat(state))
    for path, t in finals[0].items():
        assert finals[1][path].device.type == cuda_device.type, path
        assert torch.equal(finals[1][path], t), path


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
