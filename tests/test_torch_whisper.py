"""Port's audio family (``models/whisper.py``) against
``repro.models.zoo`` and ``repro.models.whisper`` with bridged params on
the whisper-small smoke config: ``encode`` on its own, forward logits and
aux, loss, prefill logits and every cache entry (decoder self k/v, cross
xk/xv, len), two decode steps.  The frames are N(0, 1) * 0.02 as
``data/pipeline.py`` draws the frontend; ``test_cross_path_is_live`` shows
that they move the logits by more than ten times the tolerance.

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
from repro.models import whisper as jax_whisper
from repro.models import zoo as jax_zoo
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import whisper, zoo

ARCH = "whisper-small"
B, S, MAX_NEW = 2, 12, 4
CASES = {"float32": 1e-4, "bfloat16": 2e-2}
_XLA_OPTS = {"xla_allow_excess_precision": False}


def frontend_np(cfg, b: int = B, seed: int = 1) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(
        (b, cfg.n_frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)


@pytest.fixture(scope="module")
def ref_params():
    jcfg = jax_get_config(ARCH, smoke=True)
    return jax.tree.map(np.asarray, jax_zoo.init(jcfg, jax.random.PRNGKey(0)))


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
        enc = jax_whisper.encode(jcfg, p, fr)
        logits, aux = jax_zoo.forward(jcfg, p, batch)
        loss, _ = jax_zoo.loss_fn(jcfg, p, {**batch, "targets": tgt})
        l0, c0 = jax_zoo.prefill(jcfg, p, batch, max_len)
        l1, c1 = jax_zoo.decode_step(jcfg, p, c0, d1, S)
        l2, c2 = jax_zoo.decode_step(jcfg, p, c1, d2, S + 1)
        return {"enc": enc, "logits": logits, "aux": aux, "loss": loss,
                "steps": ((l0, c0), (l1, c1), (l2, c2))}

    args = (p, tokens, targets, dec[0], dec[1], frontend)
    return run.lower(*args).compile(compiler_options=_XLA_OPTS)(*args)


def _run_port(cfg, params, tokens, targets, dec, frontend, max_len):
    tp = params_from_jax(params)
    batch = {"tokens": torch.from_numpy(tokens).long(),
             "frontend": torch.from_numpy(frontend)}
    enc = whisper.encode(cfg, tp, batch["frontend"])
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
    return {"enc": enc, "logits": logits, "aux": aux, "loss": loss,
            "steps": steps}


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
            "tol": CASES[dtype], "max_len": max_len, "cfg": cfg}


def _close(a, b, tol):
    a = a.float().numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=tol,
                               rtol=tol)


def test_encode(case):
    enc = case["port"]["enc"]
    cfg = case["cfg"]
    assert tuple(enc.shape) == (B, cfg.n_frontend_tokens, cfg.d_model)
    assert enc.dtype == cfg.activation_dtype
    _close(enc, case["ref"]["enc"], case["tol"])


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
    assert cache["k"].shape[1] == case["max_len"]
    for name in ("k", "v", "xk", "xv"):
        assert tuple(cache[name].shape) == rcache[name].shape, name
        _close(cache[name], rcache[name], case["tol"])


def test_cross_path_is_live(ref_params):
    """The frames move the float32 logits by more than ten times the
    tolerance: zeroing them changes the function."""
    cfg = get_config(ARCH, smoke=True)
    tp = params_from_jax(ref_params)
    tokens, _, _, frontend = _inputs(cfg)
    tok = torch.from_numpy(tokens).long()
    with_frames, _ = zoo.forward(cfg, tp, {
        "tokens": tok, "frontend": torch.from_numpy(frontend)})
    without, _ = zoo.forward(cfg, tp, {"tokens": tok, "frontend":
                                       torch.zeros(frontend.shape)})
    assert float((with_frames - without).abs().max()) > \
        10 * CASES["float32"]
    # and prefill without a frontend is prefill with zero frames
    lg, _ = zoo.prefill(cfg, tp, {"tokens": tok}, S)
    torch.testing.assert_close(lg, without[:, -1], atol=1e-5, rtol=1e-5)


def test_decoder_positions_wrap_the_table(ref_params):
    """Position p reads row p mod 4096 of ``pos_embed``, as the
    reference's decode does."""
    cfg = get_config(ARCH, smoke=True)
    tp = params_from_jax(ref_params)
    tok = torch.from_numpy(_inputs(cfg)[0]).long()
    fr = torch.from_numpy(frontend_np(cfg))
    _, cache = zoo.prefill(cfg, tp, {"tokens": tok, "frontend": fr}, S + 1)
    lg, _ = zoo.decode_step(cfg, tp, {k: v.clone() if torch.is_tensor(v)
                                      else v for k, v in cache.items()},
                            tok[:, 0], S + whisper.N_POSITIONS)
    same, _ = zoo.decode_step(cfg, tp, cache, tok[:, 0], S)
    assert torch.equal(lg, same)


@pytest.mark.parametrize("smoke", [True, False])
def test_init_cache_layout(smoke):
    cfg = get_config(ARCH, smoke)
    cache = whisper.init_cache(cfg, 3, 40, torch.device("meta"))
    ref = jax_whisper.abstract_cache(jax_get_config(ARCH, smoke), 3, 40)
    assert set(cache) == set(ref)
    for name in ("k", "v", "xk", "xv"):
        assert tuple(cache[name].shape) == ref[name].shape, name
        assert str(cache[name].dtype).removeprefix("torch.") == \
            str(ref[name].dtype)
    assert cache["len"] == 0
