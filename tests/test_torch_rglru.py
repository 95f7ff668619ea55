"""Port's RG-LRU (plain scan, wrapper, model layers) against the
reference's oracle ``rglru_ref`` and its model functions
``layers.rglru_scan`` / ``rglru_block`` / ``rglru_step``, on the sweep of
tests/test_kernels.py (``TestRglru``).

On the CPU the wrapper runs the plain version (``rglru_plain``), an exact
sequential scan like the oracle: they agree at 1e-5 in float32.  The
model's ``rglru_scan`` is an associative scan that sums in another order,
which also agrees at 1e-5 here.  The reference's Pallas kernel is not
run: it fails on this jax (``pl.store``), and the oracle is what it is
held to.  The CUDA kernel runs only where a card is present
(``tests/test_torch_cuda.py``, ``python3 chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru.ref import rglru_ref as _rglru_ref
from repro.models import layers as jax_layers
from repro_torch.kernels.rglru import rglru, rglru_plain
from repro_torch.kernels.rglru.ops import _check
from repro_torch.models import layers

rglru_ref = jax.jit(_rglru_ref)
jax_scan = jax.jit(jax_layers.rglru_scan)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(b, s, r, dtype="float32", seed=0, a_range=(0.001, 0.9995)):
    """The same numpy draws as jax arrays and as torch tensors."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(*a_range, (b, s, r)).astype(np.float32)
    x = rng.standard_normal((b, s, r), np.float32)
    jx = [jnp.asarray(t).astype(getattr(jnp, dtype)) for t in (a, x)]
    tx = [torch.from_numpy(t).to(getattr(torch, dtype)) for t in (a, x)]
    return jx, tx


def _close(out, ref, tol):
    out = out.float().numpy() if torch.is_tensor(out) else out
    np.testing.assert_allclose(out, np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("b,s,r", [
    (2, 128, 64),
    (1, 256, 128),
    (3, 64, 32),
    (2, 37, 16),       # ragged: no chunk of the Pallas kernel divides it
])
def test_plain_matches_oracle_and_model_scan(b, s, r):
    (ja, jx), (ta, tx) = _inputs(b, s, r)
    h, h_last = rglru(ta, tx)                  # CPU: the plain version
    assert h.dtype == torch.float32 and h_last.dtype == torch.float32
    assert tuple(h.shape) == (b, s, r) and tuple(h_last.shape) == (b, r)
    href, hlref = rglru_ref(ja, jx)
    _close(h, href, TOL["float32"])
    _close(h_last, hlref, TOL["float32"])
    hm, hlm = jax_scan(ja, jx)
    _close(h, hm, TOL["float32"])
    _close(h_last, hlm, TOL["float32"])


def test_extreme_decay():
    """a = 1e-6: h_t is x_t up to 1e-6, no log-space overflow."""
    a = np.full((1, 64, 32), 1e-6, np.float32)
    x = np.ones((1, 64, 32), np.float32)
    h, _ = rglru_plain(torch.from_numpy(a), torch.from_numpy(x))
    href, _ = rglru_ref(jnp.asarray(a), jnp.asarray(x))
    np.testing.assert_allclose(h.numpy(), np.asarray(href), atol=1e-6)


def test_carried_state_matches_reference_fold():
    (ja, jx), (ta, tx) = _inputs(2, 5, 16, seed=1)
    h0 = np.random.default_rng(2).standard_normal((2, 16), np.float32)
    h, h_last = layers.rglru_scan(ta, tx, torch.from_numpy(h0))
    hm, hlm = jax_scan(ja, jx, jnp.asarray(h0))
    _close(h, hm, TOL["float32"])
    _close(h_last, hlm, TOL["float32"])
    href, _ = rglru_ref(ja, jx, jnp.asarray(h0))
    _close(h, href, TOL["float32"])


def test_bfloat16_in_and_out():
    (ja, jx), (ta, tx) = _inputs(2, 64, 32, "bfloat16", seed=3)
    h, h_last = rglru(ta, tx)
    assert h.dtype == torch.bfloat16 and h_last.dtype == torch.float32
    href, hlref = rglru_ref(ja, jx)
    _close(h, href.astype(jnp.float32), TOL["bfloat16"])
    _close(h_last, hlref, TOL["bfloat16"])


@pytest.fixture(scope="module")
def block_params():
    rng = np.random.default_rng(4)
    r = 16
    p = {"log_a": rng.standard_normal(r, np.float32),
         "w_gx": rng.standard_normal((r, r), np.float32) / 4,
         "w_ga": rng.standard_normal((r, r), np.float32) / 4}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("with_h0", [False, True])
def test_block_matches_reference(block_params, with_h0):
    jp, tp = block_params
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 16), np.float32)
    h0 = rng.standard_normal((2, 16), np.float32) if with_h0 else None
    out, h_last = layers.rglru_block(
        tp, torch.from_numpy(x), None if h0 is None else torch.from_numpy(h0))
    ref, hl_ref = jax.jit(jax_layers.rglru_block)(
        jp, jnp.asarray(x), None if h0 is None else jnp.asarray(h0))
    _close(out, ref, TOL["float32"])
    _close(h_last, hl_ref, TOL["float32"])


def test_step_matches_reference(block_params):
    jp, tp = block_params
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 16), np.float32)
    h = rng.standard_normal((3, 16), np.float32)
    out, h_new = layers.rglru_step(tp, torch.from_numpy(x),
                                   torch.from_numpy(h))
    ref, h_ref = jax.jit(jax_layers.rglru_step)(jp, jnp.asarray(x),
                                                jnp.asarray(h))
    _close(out, ref, TOL["float32"])
    _close(h_new, h_ref, TOL["float32"])


def test_scan_override_is_used_from_zero_state():
    calls = []

    def scan(a, x):
        calls.append(a.shape)
        return rglru_plain(a, x)

    _, (ta, tx) = _inputs(1, 4, 8)
    layers.rglru_scan(ta, tx, scan=scan)
    layers.rglru_scan(ta, tx, torch.zeros(1, 8), scan=scan)   # decode form
    assert calls == [(1, 4, 8)]


def test_cpu_path_does_not_count_launches():
    _, (ta, tx) = _inputs(1, 8, 8)
    before = rglru.launches
    rglru(ta, tx)
    assert rglru.launches == before


@pytest.mark.parametrize("shape_a,shape_x,dtype,match", [
    ((1, 8, 4), (1, 8, 5), torch.float32, "same"),
    ((8, 4), (8, 4), torch.float32, "same"),
    ((1, 8, 4), (1, 8, 4), torch.float16, "float32 or bfloat16"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(shape_a, shape_x,
                                                       dtype, match):
    a = torch.zeros(shape_a, dtype=dtype)
    x = torch.zeros(shape_x, dtype=dtype)
    with pytest.raises((ValueError, TypeError), match=match):
        _check(a, x)


def test_other_devices_never_take_the_plain_version():
    a = torch.empty((1, 8, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        rglru(a, a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_model_inputs_pass_the_kernel_checks(dtype):
    """The recurrentgemma smoke model's RG-LRU inputs, caught through
    ``rglru_fn`` in a wave prefill (B=2) and a re-prefill (B=1), pass the
    wrapper's ``_check``: on a card they would go to the kernel."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    from repro_torch.models.common import cast_matrices
    cfg = dataclasses.replace(get_config("recurrentgemma-2b", smoke=True),
                              dtype=dtype)
    params = cast_matrices(zoo.init(cfg, torch.Generator().manual_seed(0),
                                    device=torch.device("cpu")),
                           cfg.activation_dtype)
    calls = []

    def rglru_fn(a, x):
        _check(a, x)
        calls.append((tuple(a.shape), a.dtype))
        return rglru_plain(a, x)

    rng = np.random.default_rng(9)
    for b, s in ((2, 12), (1, 7)):
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)))
        zoo.prefill(cfg, params, {"tokens": tokens},
                    zoo.cache_max_len(cfg, s + 4), rglru_fn=rglru_fn)
    assert len(calls) == 2 * 4        # 4 recurrent blocks of 5 layers
    assert all(dt == cfg.activation_dtype for _, dt in calls)
