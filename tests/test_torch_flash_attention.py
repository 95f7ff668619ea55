"""Port's flash attention wrapper against the reference's Pallas kernel
(interpret mode) and its oracle, on the sweep of tests/test_kernels.py.

On the CPU the wrapper runs the plain version (``attention_plain``), so
these tests hold the algorithm and the wrapper's CPU path to the
reference.  The CUDA kernel itself runs only where a card is present
(``tests/test_torch_cuda.py``; ``python3 chip_smoke.py`` covers it too).  The
interpreted Pallas kernel runs with one block per sequence, which keeps
its CPU time down; its block tiling is not what is under test here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as _attention_ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ops import _check

# one compile per shape instead of one per primitive and shape
attention_ref = jax.jit(_attention_ref, static_argnames=("causal", "window"))
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SWEEP = [
    (2, 128, 4, 2, 64),      # GQA
    (1, 256, 4, 4, 32),      # MHA
    (1, 64, 8, 1, 64),       # MQA
    (2, 128, 2, 2, 128),     # head dim 128
]


def _inputs(b, s, h, kh, d, dtype="float32", seed=0):
    """The same numpy draws as jax arrays and as torch tensors."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, np.float32)
            for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d))]
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _assert_close(out, ref, dtype):
    np.testing.assert_allclose(_np(out), _np(ref), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("b,s,h,kh,d", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_matches_reference(b, s, h, kh, d, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(b, s, h, kh, d, dtype)
    out = flash_attention(tq, tk, tv, causal=True)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _assert_close(out, jax_flash(jq, jk, jv, causal=True, block_q=s,
                                 block_k=s, interpret=True), dtype)
    _assert_close(out, attention_ref(jq, jk, jv, causal=True), dtype)


@pytest.mark.parametrize("window", [32, 64])
def test_sliding_window(window):
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 128, 4, 2, 64)
    out = flash_attention(tq, tk, tv, causal=True, window=window)
    _assert_close(out, jax_flash(jq, jk, jv, causal=True, window=window,
                                 block_q=128, block_k=128, interpret=True),
                  "float32")
    _assert_close(out, attention_ref(jq, jk, jv, causal=True, window=window),
                  "float32")


def test_non_causal():
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 64, 2, 2, 32)
    out = flash_attention(tq, tk, tv, causal=False)
    _assert_close(out, jax_flash(jq, jk, jv, causal=False, block_q=64,
                                 block_k=64, interpret=True), "float32")
    _assert_close(out, attention_ref(jq, jk, jv, causal=False), "float32")


@pytest.mark.parametrize("s,window", [(100, None), (100, 32), (1, None)])
def test_ragged_length_matches_oracle(s, window):
    """Lengths the Pallas kernel refuses (S % block != 0) but the serving
    path prefills: only the oracle can be compared."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, s, 4, 2, 16)
    out = flash_attention(tq, tk, tv, causal=True, window=window)
    _assert_close(out, attention_ref(jq, jk, jv, causal=True, window=window),
                  "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_256_gqa_matches_oracle(dtype):
    """recurrentgemma's head dim, GQA 4/1, a window shorter than S."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 64, 4, 1, 256, dtype)
    out = flash_attention(tq, tk, tv, causal=True, window=24)
    _assert_close(out, attention_ref(jq, jk, jv, causal=True, window=24),
                  dtype)


def test_cpu_path_does_not_count_launches():
    _, (tq, tk, tv) = _inputs(1, 64, 2, 2, 32)
    before = flash_attention.launches
    flash_attention(tq, tk, tv)
    assert flash_attention.launches == before


@pytest.mark.parametrize("shape_q,shape_kv,dtype,match", [
    ((1, 8, 4, 48), (1, 8, 4, 48), torch.float32, "head dim"),
    ((1, 8, 4, 16), (1, 8, 3, 16), torch.float32, "multiple"),
    ((1, 8, 4, 16), (1, 8, 4, 16), torch.float16, "float32 or bfloat16"),
    ((1, 8, 4, 16), (1, 9, 4, 16), torch.float32, "disagree"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(shape_q, shape_kv,
                                                       dtype, match):
    q = torch.zeros(shape_q, dtype=dtype)
    kv = torch.zeros(shape_kv, dtype=dtype)
    with pytest.raises((ValueError, TypeError), match=match):
        _check(q, kv, kv)


def _bf16_misaligned(case):
    """A bf16 (1, 8, 4, 16) tensor that breaks TMA's rule for a tensor map
    (``case`` "stride": a stride that is not a multiple of 8 elements, 16
    bytes; "base": a base that is not 16-byte aligned), and an aligned one
    of the same shape."""
    if case == "stride":
        base = torch.zeros((1, 8, 4, 20), dtype=torch.bfloat16)
        t = base[..., :16]                    # head stride 20
    else:
        flat = torch.zeros(1 + 8 * 4 * 16, dtype=torch.bfloat16)
        t = flat[1:].view(1, 8, 4, 16)        # base 2 bytes past aligned
    ok = torch.zeros((1, 8, 4, 16), dtype=torch.bfloat16)
    return t, ok


@pytest.mark.parametrize("case", ["stride", "base"])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_wrapper_refuses_what_tma_cannot_map(case, which):
    t, ok = _bf16_misaligned(case)
    assert t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
    args = [ok, ok, ok]
    args[which] = t
    with pytest.raises(ValueError, match="16-byte"):
        _check(*args)
    _check(ok, ok, ok)      # the aligned tensors themselves pass


def test_other_devices_never_take_the_plain_version():
    q = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q, q, q)
