"""Port's optimizer against ``repro.optim``: ``adamw_update`` and
``compress`` on identical trees bridged from numpy.

AdamW is compared for every schedule, at steps 0, ``warmup_steps`` and
past ``total_steps``, with the global-norm clip active and inactive, with
float32 and bfloat16 moments.  The moments come in non-zero (drawn with
numpy), so both bias corrections and the decay act.  Tolerances, relative
to each array's largest value: 1e-6 in float32 (the two frameworks may
take ``pow``, ``sqrt`` and the norm's sum in another order, a few ulps);
the kernel tests' 2e-2 with bfloat16 moments (one bf16 rounding of the
stored moment may fall either way).  The reference runs op by op (not
jitted), so no XLA fusion moves a bf16 rounding.

Compression (top-k and int8, with and without error feedback) is exact
arithmetic on float32 (a threshold that is one of the values, a division
and a round half to even), so wire values and new error must be equal.
"""

import itertools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import adamw as jax_adamw
from repro.optim import compression as jax_comp
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.optim import (AdamWConfig, CompressionConfig, adamw_update,
                               compress, global_norm, schedule_lr, wire_bytes)

SHAPES = {"w": (8, 16), "blocks": {"a": (3, 5, 7), "norm": (16,)}}
WARMUP, TOTAL = 5, 20
RTOL = {"float32": 1e-6, "bfloat16": 2e-2}


def _draw(rng, shapes, scale, positive=False):
    def one(shape):
        a = rng.standard_normal(shape) * scale
        return (np.abs(a) if positive else a).astype(np.float32)
    return {k: _draw(rng, v, scale, positive) if isinstance(v, dict)
            else one(v) for k, v in shapes.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


def _np(tree):
    """A tree of tensors or jax arrays as a flat dict of numpy arrays."""
    if any(isinstance(v, torch.Tensor) for _, v in _leaves(tree)):
        tree = params_to_numpy(tree)
    return {p: np.asarray(v) for p, v in _leaves(tree)}


def _rel_err(got, want):
    """Largest |got - want| over the largest |want|, leaf by leaf."""
    got, want = _np(got), _np(want)
    return {p: float(np.max(np.abs(got[p].astype(np.float32)
                                   - w.astype(np.float32)))
                     / max(np.max(np.abs(w.astype(np.float32))), 1e-30))
            for p, w in want.items()}


def jnp_tree(t):
    return {k: jnp_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in t.items()}


def _cast(tree, dtype):
    return {k: _cast(v, dtype) if isinstance(v, dict) else v.astype(dtype)
            for k, v in tree.items()}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [0.5, 1e3], ids=["clip", "noclip"])
@pytest.mark.parametrize("step", [0, WARMUP, TOTAL + 7])
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_adamw_update_matches_reference(schedule, step, clip, moments):
    kw = dict(lr=3e-3, schedule=schedule, warmup_steps=WARMUP,
              total_steps=TOTAL, grad_clip_norm=clip, moment_dtype=moments)
    rng = np.random.default_rng([step, int(clip), len(schedule)])
    params = _draw(rng, SHAPES, 1.0)
    grads = _draw(rng, SHAPES, 0.1)
    mdt = ml_dtypes.bfloat16 if moments == "bfloat16" else np.float32
    mu = _cast(_draw(rng, SHAPES, 0.01), mdt)
    nu = _cast(_draw(rng, SHAPES, 1e-3, positive=True), mdt)

    jp, jopt, jm = jax_adamw.adamw_update(
        jax_adamw.AdamWConfig(**kw), jnp_tree(grads),
        {"mu": jnp_tree(mu), "nu": jnp_tree(nu),
         "step": jnp.asarray(step, jnp.int32)}, jnp_tree(params))
    tp, topt, tm = adamw_update(
        AdamWConfig(**kw), params_from_jax(grads),
        {"mu": params_from_jax(mu), "nu": params_from_jax(nu),
         "step": torch.tensor(step, dtype=torch.int32)},
        params_from_jax(params))

    assert int(topt["step"]) == int(jopt["step"]) == step + 1
    assert topt["step"].dtype == torch.int32
    for name in ("lr", "grad_norm"):
        assert tm[name].dtype == torch.float32
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-6, err_msg=name)
    assert (float(tm["grad_norm"]) > clip) == (clip == 0.5)
    for name, got, want, rtol in (
            ("params", tp, jp, RTOL["float32"]),
            ("mu", topt["mu"], jopt["mu"], RTOL[moments]),
            ("nu", topt["nu"], jopt["nu"], RTOL[moments])):
        errs = _rel_err(got, want)
        assert max(errs.values()) <= rtol, (name, errs)
    for path, t in _leaves(topt["mu"]):
        assert t.dtype == getattr(torch, moments), path
    for path, t in _leaves(tp):
        assert t.dtype == torch.float32, path


def test_schedule_and_norm_on_their_own():
    cfg = AdamWConfig(warmup_steps=WARMUP, total_steps=TOTAL)
    jcfg = jax_adamw.AdamWConfig(warmup_steps=WARMUP, total_steps=TOTAL)
    steps = np.arange(0, TOTAL + 5, dtype=np.int32)
    got = schedule_lr(cfg, torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_adamw.schedule_lr(
        jcfg, jnp.asarray(steps))), rtol=1e-6)
    g = _draw(np.random.default_rng(3), SHAPES, 0.1)
    np.testing.assert_allclose(
        float(global_norm(params_from_jax(g))),
        float(jax_adamw.global_norm(jnp_tree(g))), rtol=1e-6)


@pytest.mark.parametrize("scheme,ef", list(itertools.product(
    ["topk", "int8"], [True, False])))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_matches_reference_exactly(scheme, ef, dtype):
    rng = np.random.default_rng(7)
    mdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    grads = _cast(_draw(rng, SHAPES, 0.1), mdt)
    error = _draw(rng, SHAPES, 0.01)
    kw = dict(scheme=scheme, topk_ratio=0.1, ef=ef)
    jw, je, jm = jax_comp.compress(jax_comp.CompressionConfig(**kw),
                                   jnp_tree(grads), jnp_tree(error))
    tw, te, tm = compress(CompressionConfig(**kw), params_from_jax(grads),
                          params_from_jax(error))
    assert tm == {k: float(v) for k, v in jm.items()}
    for got, want in ((tw, jw), (te, je)):
        got, want = _np(got), _np(want)
        for path, w in want.items():
            assert got[path].dtype == w.dtype, path
            assert got[path].tobytes() == w.tobytes(), path
    # the kept share of each leaf is the ratio (no ties among float32
    # draws; bf16 grads without error feedback do tie)
    if scheme == "topk" and dtype == "float32":
        for path, w in _np(jw).items():
            assert np.count_nonzero(w.astype(np.float32)) == max(
                1, int(w.size * 0.1)), path
    jg = jnp_tree(grads)
    for s in ("none", "topk", "int8"):
        assert wire_bytes(CompressionConfig(scheme=s),
                          params_from_jax(grads)) == jax_comp.wire_bytes(
            jax_comp.CompressionConfig(scheme=s), jg)


def test_compress_none_passes_through():
    g = params_from_jax(_draw(np.random.default_rng(1), SHAPES, 0.1))
    e = params_from_jax(_draw(np.random.default_rng(2), SHAPES, 0.1))
    w, e2, m = compress(CompressionConfig(), g, e)
    assert w is g and e2 is e and m == {"compression_ratio": 1.0}
