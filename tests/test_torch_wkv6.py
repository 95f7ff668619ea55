"""Port's WKV6 (plain scan, wrapper, the model's decode step) against the
reference's interpreted Pallas kernel
``repro.kernels.rwkv6.ops.wkv6(interpret=True)``, its oracle ``wkv6_ref``
and the reference model's own recurrence, ``layers.rwkv6_linear_attention``
(chunked, w clipped at 1e-8) and ``rwkv6_step``, on the sweeps of
tests/test_kernels.py (``TestWkv6``).

On the CPU the wrapper runs the plain version (``wkv6_plain``), an exact
per-step scan like the oracle: float32 agrees with it to 1e-5 (only the
order of each step's D-term sums differs).  The model's decode step agrees
with the reference's chunked form at chunk 1 to 1e-4: the reference takes
exp(log(w)) of each decay, which moves it by ulps.  Between the reference's
chunked forms (the Pallas kernel's or the model's) and an exact scan the
tolerances are test_kernels.py's: atol 3e-4 and rtol 1e-3, and 5e-4 /
5e-3 under strong decay.  The CUDA kernel runs only where a card is
present (``tests/test_torch_cuda.py``, ``python3 chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6.ops import wkv6 as pallas_wkv6
from repro.kernels.rwkv6.ref import wkv6_ref as _wkv6_ref
from repro.models import layers as jax_layers
from repro_torch.kernels.rwkv6 import wkv6, wkv6_plain
from repro_torch.kernels.rwkv6.ops import _check
from repro_torch.models import layers, rwkv6

wkv6_ref = jax.jit(_wkv6_ref)
jax_chunked = jax.jit(jax_layers.rwkv6_linear_attention,
                      static_argnames=("chunk",))
EXACT = 1e-5                 # plain scan vs the oracle, float32
CHUNK1 = 1e-4                # decode step vs the reference's chunk 1
PALLAS = (3e-4, 1e-3)        # chunked forms vs the exact scan (atol, rtol)
STRONG = (5e-4, 5e-3)        # the same under w in [1e-4, 0.2]
PALLAS_FLOOR = 1e-38         # the Pallas kernel's clip of w
MODEL_FLOOR = 1e-8           # the reference model's clip of w


def _inputs(b, h, s, d, *, seed=0, w_range=(0.5, 0.999), u_scale=0.5,
            dtype="float32"):
    """The same numpy draws as jax arrays and as torch tensors:
    (r, k, v, w, u) with u float32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, h, s, d), np.float32)
               for _ in range(3))
    w = rng.uniform(*w_range, (b, h, s, d)).astype(np.float32)
    u = (rng.standard_normal((h, d)) * u_scale).astype(np.float32)
    arrs = (r, k, v, w)
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return (*jx, jnp.asarray(u)), (*tx, torch.from_numpy(u))


def _close(out, ref, atol, rtol=None):
    out = out.float().numpy() if torch.is_tensor(out) else out
    np.testing.assert_allclose(out, np.asarray(ref, np.float32), atol=atol,
                               rtol=atol if rtol is None else rtol)


# test_kernels.py's sweep: (b, h, s, d, the Pallas kernel's chunk)
SWEEP = [
    (2, 2, 128, 64, 64),
    (1, 4, 256, 32, 64),
    (2, 1, 64, 64, 32),
    (1, 2, 128, 64, 128),
]


@pytest.mark.parametrize("b,h,s,d,chunk", SWEEP)
def test_plain_and_wrapper_match_pallas_and_oracle(b, h, s, d, chunk):
    jx, tx = _inputs(b, h, s, d)
    out, st = wkv6(*tx, floor=PALLAS_FLOOR)            # CPU: the plain scan
    assert out.dtype == torch.float32 and st.dtype == torch.float32
    assert tuple(out.shape) == (b, h, s, d)
    assert tuple(st.shape) == (b, h, d, d)
    oref, sref = wkv6_ref(*jx)
    _close(out, oref, EXACT)
    _close(st, sref, EXACT)
    opal, spal = pallas_wkv6(*jx, chunk=chunk, interpret=True)
    _close(out, opal, *PALLAS)
    _close(st, spal, *PALLAS)
    pout, pst = wkv6_plain(*tx, floor=PALLAS_FLOOR)
    assert torch.equal(pout, out) and torch.equal(pst, st)


def test_strong_decay_matches_pallas():
    jx, tx = _inputs(1, 1, 128, 32, seed=1, w_range=(1e-4, 0.2), u_scale=0.0)
    out, st = wkv6_plain(*tx, floor=PALLAS_FLOOR)
    assert torch.isfinite(out).all() and torch.isfinite(st).all()
    opal, _ = pallas_wkv6(*jx, chunk=64, interpret=True)
    _close(out, opal, *STRONG)
    oref, sref = wkv6_ref(*jx)
    _close(out, oref, EXACT)
    _close(st, sref, EXACT)


def test_bfloat16_in_float32_state_out():
    jx, tx = _inputs(2, 2, 64, 16, seed=2, dtype="bfloat16")
    out, st = wkv6(*tx, floor=MODEL_FLOOR)
    assert out.dtype == torch.bfloat16 and st.dtype == torch.float32
    oref, sref = wkv6_ref(*jx)
    _close(out, oref.astype(jnp.float32), 2e-2)
    _close(st, sref, 2e-2)


def test_floor_keeps_zero_decay_finite():
    """w holding exact zeros and values below the floor: the plain scan
    and the wrapper clip at 1e-8 and stay finite, and they equal the
    oracle run on w clipped by hand."""
    jx, tx = _inputs(1, 2, 96, 16, seed=3, w_range=(0.0, 1.0))
    r, k, v, w, u = tx
    w = w.clone()
    w[..., ::3] = 0.0
    w[..., 1::7] = 1e-12
    out, st = wkv6(r, k, v, w, u, floor=MODEL_FLOOR)
    assert torch.isfinite(out).all() and torch.isfinite(st).all()
    wc = jnp.asarray(np.maximum(w.numpy(), MODEL_FLOOR))
    oref, sref = wkv6_ref(*jx[:3], wc, jx[4])
    _close(out, oref, EXACT)
    _close(st, sref, EXACT)


def _state0(b, h, d, seed=5):
    return np.random.default_rng(seed).standard_normal(
        (b, h, d, d)).astype(np.float32)


@pytest.mark.parametrize("s,chunk,with_state", [
    (128, 32, False),      # test_kernels.py's model-path case
    (128, 32, True),
    (7, 1, True),          # chunk 1, as the reference decodes (a prime S)
])
def test_plain_matches_reference_chunked_form(s, chunk, with_state):
    """The model's prefill recurrence on the CPU (the plain scan at the
    1e-8 floor) against the reference model's, and against the oracle."""
    jx, tx = _inputs(1, 2, s, 32, seed=4, w_range=(0.6, 0.999))
    state0 = _state0(1, 2, 32) if with_state else None
    out, st = wkv6_plain(*tx, floor=MODEL_FLOOR, state0=None if
                         state0 is None else torch.from_numpy(state0))
    ref, sref = jax_chunked(*jx, None if state0 is None
                            else jnp.asarray(state0), chunk=chunk)
    _close(out, ref, *PALLAS)
    _close(st, sref, *PALLAS)
    oref, soref = wkv6_ref(*jx, None if state0 is None
                           else jnp.asarray(state0))
    _close(out, oref, EXACT)
    _close(st, soref, EXACT)


def test_decode_steps_match_reference_chunk_1():
    """The model's decode recurrence (``rwkv6._wkv`` from a carried state,
    one token at a time) against the reference's chunked form at chunk 1,
    with decays at 0 and below the 1e-8 floor."""
    jx, tx = _inputs(2, 2, 5, 16, seed=7, w_range=(0.0, 1.0))
    r, k, v, w, u = tx
    w = w.clone()
    w[..., ::3] = 0.0
    w[..., 1::7] = 1e-12
    state = torch.from_numpy(_state0(2, 2, 16, seed=8))
    ref, sref = jax_chunked(*jx[:3], jnp.asarray(w.numpy()), jx[4],
                            jnp.asarray(state.numpy()), chunk=1)
    outs = []
    for t in range(r.shape[2]):
        sl = slice(t, t + 1)
        out, state = rwkv6._wkv(r[:, :, sl], k[:, :, sl], v[:, :, sl],
                                w[:, :, sl], u, state, None)
        outs.append(out)
    _close(torch.cat(outs, dim=2), ref, CHUNK1)
    _close(state, sref, CHUNK1)


def test_step_matches_reference():
    rng = np.random.default_rng(6)
    r, k, v = (rng.standard_normal((3, 2, 16), np.float32) for _ in range(3))
    w = rng.uniform(0.5, 0.999, (3, 2, 16)).astype(np.float32)
    u = rng.standard_normal((2, 16)).astype(np.float32)
    state = rng.standard_normal((3, 2, 16, 16)).astype(np.float32)
    arrs = (r, k, v, w, u, state)
    out, new = layers.rwkv6_step(*(torch.from_numpy(a) for a in arrs))
    ref, ref_new = jax.jit(jax_layers.rwkv6_step)(
        *(jnp.asarray(a) for a in arrs))
    _close(out, ref, EXACT)
    _close(new, ref_new, EXACT)


def test_cpu_path_does_not_count_launches():
    _, tx = _inputs(1, 1, 8, 16)
    before = wkv6.launches
    wkv6(*tx, floor=MODEL_FLOOR)
    assert wkv6.launches == before


def _t(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("args,error,match", [
    ((_t((1, 2, 8, 16)), _t((1, 2, 8, 16)), _t((1, 2, 8, 16)),
      _t((1, 2, 9, 16)), _t((2, 16))), ValueError, "same"),
    ((_t((1, 2, 8, 128)),) * 4 + (_t((2, 128)),), ValueError, "D in"),
    ((_t((1, 2, 8, 16), torch.float16),) * 4 + (_t((2, 16)),), TypeError,
     "float32 or bfloat16"),
    ((_t((1, 2, 8, 16)),) * 4 + (_t((2, 16), torch.bfloat16),), ValueError,
     "u must be"),
    ((_t((1, 2, 8, 16)),) * 3 + (_t((1, 8, 2, 16)).transpose(1, 2),
                                 _t((2, 16))), ValueError, "strides"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(args, error, match):
    with pytest.raises(error, match=match):
        _check(*args)


def test_other_devices_never_take_the_plain_version():
    t = torch.empty((1, 1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        wkv6(t, t, t, t, torch.empty((1, 16), device="meta"),
             floor=MODEL_FLOOR)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_model_inputs_pass_the_kernel_checks(dtype):
    """The rwkv6 smoke model's WKV6 inputs, caught through ``wkv_fn`` in a
    wave prefill (B=2) and a re-prefill (B=1), pass the wrapper's
    ``_check``, the 16-byte alignment of the kernel's copies included:
    on a card they would go to the kernel, not to an exception."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    from repro_torch.models.common import cast_matrices
    cfg = dataclasses.replace(get_config("rwkv6-1.6b", smoke=True),
                              dtype=dtype)
    params = cast_matrices(zoo.init(cfg, torch.Generator().manual_seed(0),
                                    device=torch.device("cpu")),
                           cfg.activation_dtype)
    calls = []

    def wkv_fn(r, k, v, w, u, *, floor):
        _check(r, k, v, w, u)
        calls.append((tuple(r.shape), r.dtype))
        return wkv6_plain(r, k, v, w, u, floor=floor)

    rng = np.random.default_rng(8)
    for b, s in ((2, 12), (1, 7)):
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)))
        zoo.prefill(cfg, params, {"tokens": tokens},
                    zoo.cache_max_len(cfg, s + 4), wkv_fn=wkv_fn)
    assert len(calls) == 2 * cfg.n_layers
    assert all(dt == cfg.activation_dtype for _, dt in calls)


def _misaligned(kind, dtype):
    """(B,H,S,D) = (1,2,8,16) views that share their strides, with the
    head dim contiguous, that the kernel's 16-byte copies cannot take."""
    if kind == "pointer":        # starts 4 bytes into its storage
        return [torch.zeros(1 * 2 * 8 * 16 + 2, dtype=dtype)[2:]
                .view(1, 2, 8, 16) for _ in range(4)]
    # step stride of 17 (float32: 68 bytes) or 20 (bfloat16: 40 bytes)
    pad = 17 if dtype == torch.float32 else 20
    return [torch.zeros((1, 2, 8, pad), dtype=dtype)[..., :16]
            for _ in range(4)]


@pytest.mark.parametrize("kind,dtype", [
    ("pointer", torch.float32),
    ("pointer", torch.bfloat16),
    ("step stride", torch.float32),
    ("step stride", torch.bfloat16),
])
def test_wrapper_refuses_misaligned_views(kind, dtype):
    r, k, v, w = _misaligned(kind, dtype)
    with pytest.raises(ValueError, match="16 bytes"):
        _check(r, k, v, w, _t((2, 16)))
