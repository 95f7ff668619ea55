"""Port's vlm family (``models/vlm.py``) against ``repro.models.zoo`` with
bridged params on the llama-3.2-vision smoke config: forward logits and
aux, loss, prefill logits and every cache entry (self k/v, cross xk/xv,
len), two decode steps.

At init both cross gates are zero (tanh 0 = 0), so the cross layers add
nothing and a port without them would pass; the params here draw both
gates from U(-1, 1), and the frontend is N(0, 1) * 0.02 as
``data/pipeline.py`` draws it.  ``test_cross_path_is_live`` shows that the
frontend moves the logits by more than ten times the tolerance.

Float32 at atol 1e-4 and one bfloat16 case at the kernel tests' 2e-2; the
reference runs as one function compiled once per case with XLA's
``xla_allow_excess_precision`` off (see tests/test_torch_transformer.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import vlm as jax_vlm
from repro.models import zoo as jax_zoo
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import vlm, zoo

ARCH = "llama-3.2-vision-11b"
B, S, MAX_NEW = 2, 12, 4
CASES = {"float32": 1e-4, "bfloat16": 2e-2}
_XLA_OPTS = {"xla_allow_excess_precision": False}


def draw_gates(params: dict, seed: int = 0) -> dict:
    """The params with both cross gates drawn from U(-1, 1) (new dicts;
    the other leaves are shared)."""
    rng = np.random.default_rng(seed)
    cross = dict(params["supers"]["cross"])
    for name in ("gate_attn", "gate_mlp"):
        cross[name] = rng.uniform(-1.0, 1.0, cross[name].shape).astype(
            np.float32)
    return {**params, "supers": {**params["supers"], "cross": cross}}


def frontend_np(cfg, b: int = B, seed: int = 1) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(
        (b, cfg.n_frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)


@pytest.fixture(scope="module")
def ref_params():
    jcfg = jax_get_config(ARCH, smoke=True)
    return draw_gates(jax.tree.map(np.asarray,
                                   jax_zoo.init(jcfg, jax.random.PRNGKey(0))))


def _inputs(cfg):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    dec = rng.integers(0, cfg.vocab, (2, B)).astype(np.int32)
    return tokens[:, :-1], tokens[:, 1:], dec, frontend_np(cfg)


def _run_reference(jcfg, params, tokens, targets, dec, frontend, max_len):
    p = jax.tree.map(jnp.asarray, params)

    @jax.jit
    def run(p, tok, tgt, d1, d2, fr):
        batch = {"tokens": tok, "frontend": fr}
        logits, aux = jax_zoo.forward(jcfg, p, batch)
        loss, _ = jax_zoo.loss_fn(jcfg, p, {**batch, "targets": tgt})
        l0, c0 = jax_zoo.prefill(jcfg, p, batch, max_len)
        l1, c1 = jax_zoo.decode_step(jcfg, p, c0, d1, S)
        l2, c2 = jax_zoo.decode_step(jcfg, p, c1, d2, S + 1)
        return {"logits": logits, "aux": aux, "loss": loss,
                "steps": ((l0, c0), (l1, c1), (l2, c2))}

    args = (p, tokens, targets, dec[0], dec[1], frontend)
    return run.lower(*args).compile(compiler_options=_XLA_OPTS)(*args)


def _run_port(cfg, params, tokens, targets, dec, frontend, max_len):
    tp = params_from_jax(params)
    batch = {"tokens": torch.from_numpy(tokens).long(),
             "frontend": torch.from_numpy(frontend)}
    logits, aux = zoo.forward(cfg, tp, batch)
    loss, _ = zoo.loss_fn(cfg, tp, {**batch,
                                    "targets": torch.from_numpy(targets)})
    lg, cache = zoo.prefill(cfg, tp, batch, max_len)
    # decode_step writes the cache in place: keep a copy of each state
    steps = [(lg, _copy(cache))]
    for i, pos in enumerate((S, S + 1)):
        lg, cache = zoo.decode_step(cfg, tp, cache,
                                    torch.from_numpy(dec[i]).long(), pos)
        steps.append((lg, _copy(cache)))
    return {"logits": logits, "aux": aux, "loss": loss, "steps": steps}


def _copy(cache: dict) -> dict:
    return {k: v.clone() if torch.is_tensor(v) else v
            for k, v in cache.items()}


@pytest.fixture(scope="module", params=list(CASES))
def case(request, ref_params):
    dtype = request.param
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    max_len = zoo.cache_max_len(cfg, S + MAX_NEW)
    args = (ref_params, *_inputs(cfg), max_len)
    return {"ref": _run_reference(jcfg, *args), "port": _run_port(cfg, *args),
            "tol": CASES[dtype], "max_len": max_len}


def _close(a, b, tol):
    a = a.float().numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=tol,
                               rtol=tol)


def test_forward_logits(case):
    assert tuple(case["port"]["logits"].shape) == case["ref"]["logits"].shape
    _close(case["port"]["logits"], case["ref"]["logits"], case["tol"])
    assert float(case["port"]["aux"]) == float(case["ref"]["aux"]) == 0.0


def test_loss(case):
    _close(case["port"]["loss"], case["ref"]["loss"], case["tol"])


@pytest.mark.parametrize("step", [0, 1, 2], ids=["prefill", "decode1",
                                                 "decode2"])
def test_serving_step(case, step):
    (lg, cache), (rlg, rcache) = (case["port"]["steps"][step],
                                  case["ref"]["steps"][step])
    _close(lg, rlg, case["tol"])
    assert int(cache["len"]) == int(rcache["len"]) == S + step
    assert set(cache) == set(rcache)
    assert cache["k"].shape[2] == case["max_len"]
    for name in ("k", "v", "xk", "xv"):
        assert tuple(cache[name].shape) == rcache[name].shape, name
        _close(cache[name], rcache[name], case["tol"])


def test_cross_path_is_live(ref_params):
    """With the gates drawn, the frontend moves the float32 logits by more
    than ten times the tolerance (3.4e-3 at this size): zeroing it changes
    the function."""
    cfg = get_config(ARCH, smoke=True)
    tp = params_from_jax(ref_params)
    tokens, _, _, frontend = _inputs(cfg)
    tok = torch.from_numpy(tokens).long()
    with_img, _ = zoo.forward(cfg, tp, {"tokens": tok,
                                        "frontend": torch.from_numpy(frontend)})
    without, _ = zoo.forward(cfg, tp, {"tokens": tok, "frontend":
                                       torch.zeros(frontend.shape)})
    assert float((with_img - without).abs().max()) > 10 * CASES["float32"]
    # and prefill without a frontend is prefill with a zero one
    lg, _ = zoo.prefill(cfg, tp, {"tokens": tok}, S)
    torch.testing.assert_close(lg, without[:, -1], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("smoke", [True, False])
def test_init_cache_layout(smoke):
    cfg = get_config(ARCH, smoke)
    cache = vlm.init_cache(cfg, 3, 40, torch.device("meta"))
    ref = jax_vlm.abstract_cache(jax_get_config(ARCH, smoke), 3, 40)
    assert set(cache) == set(ref)
    for name in ("k", "v", "xk", "xv"):
        assert tuple(cache[name].shape) == ref[name].shape, name
        assert str(cache[name].dtype).removeprefix("torch.") == \
            str(ref[name].dtype)
    assert cache["len"] == 0
    assert vlm.layout(cfg) == jax_vlm.layout(jax_get_config(ARCH, smoke))
