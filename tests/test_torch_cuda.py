"""The port on a CUDA card: the flash attention, RG-LRU and WKV6 kernels
against their plain versions, and the serving paths through the kernels.

Every test here is marked ``cuda`` and skips without a card; the file
imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import attention_plain, flash_attention
from repro_torch.kernels.rglru import rglru, rglru_plain
from repro_torch.kernels.rwkv6 import wkv6, wkv6_plain
from repro_torch.models import zoo
from repro_torch.serving import Request, ServeEngine

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
