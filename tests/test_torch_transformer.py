"""Port's dense transformer against ``repro.models.zoo`` with bridged
params: forward logits, loss, prefill logits and cache, two decode steps.

Smoke configs in float32 at atol 1e-4 (the two frameworks sum in other
orders), one sliding-window variant (trailing-window prefill, ring-buffer
decode) and one bfloat16 variant at the kernel tests' bf16 tolerance.
The reference runs as one function compiled once per case, with XLA's
``xla_allow_excess_precision`` off: by default XLA on the CPU drops
bf16 roundings between fused ops, which the reference's own code asks
for (``.astype(dt)``) and the port performs.  With it off the two
packages agree bit for bit in bf16 at this size.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jax_transformer
from repro.models import zoo as jax_zoo
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import transformer, zoo

B, S, MAX_NEW = 2, 12, 4
CASES = {
    # name: (arch, config overrides, tolerance)
    "olmo-1b": ("olmo-1b", {}, 1e-4),
    "granite-3-8b": ("granite-3-8b", {}, 1e-4),
    "codeqwen1.5-7b": ("codeqwen1.5-7b", {}, 1e-4),
    "olmo-1b-swa8": ("olmo-1b", {"window": 8}, 1e-4),
    "olmo-1b-bf16": ("olmo-1b", {"dtype": "bfloat16"}, 2e-2),
}
_XLA_OPTS = {"xla_allow_excess_precision": False}


def _run_reference(jcfg, params, tokens, targets, dec, max_len):
    p = jax.tree.map(jnp.asarray, params)

    @jax.jit
    def run(p, tok, tgt, d1, d2):
        logits, _ = jax_zoo.forward(jcfg, p, {"tokens": tok})
        loss, _ = jax_zoo.loss_fn(jcfg, p, {"tokens": tok, "targets": tgt})
        l0, c0 = jax_zoo.prefill(jcfg, p, {"tokens": tok}, max_len)
        l1, c1 = jax_zoo.decode_step(jcfg, p, c0, d1, S)
        l2, c2 = jax_zoo.decode_step(jcfg, p, c1, d2, S + 1)
        return {"logits": logits, "loss": loss,
                "steps": ((l0, c0), (l1, c1), (l2, c2))}

    args = (p, tokens, targets, dec[0], dec[1])
    return run.lower(*args).compile(compiler_options=_XLA_OPTS)(*args)


def _run_port(cfg, params, tokens, targets, dec, max_len):
    tp = params_from_jax(params)
    tok = torch.from_numpy(tokens).long()
    logits, _ = zoo.forward(cfg, tp, {"tokens": tok})
    loss, _ = zoo.loss_fn(cfg, tp, {"tokens": tok,
                                    "targets": torch.from_numpy(targets)})
    steps = []
    lg, cache = zoo.prefill(cfg, tp, {"tokens": tok}, max_len)
    # decode_step writes the cache in place: keep a copy of each state
    steps.append((lg, {k: v.clone() if torch.is_tensor(v) else v
                       for k, v in cache.items()}))
    for i, pos in enumerate((S, S + 1)):
        lg, cache = zoo.decode_step(cfg, tp, cache,
                                    torch.from_numpy(dec[i]).long(), pos)
        steps.append((lg, {k: v.clone() if torch.is_tensor(v) else v
                           for k, v in cache.items()}))
    return {"logits": logits, "loss": loss, "steps": steps}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    arch, over, tol = CASES[request.param]
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), **over)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    params = jax.tree.map(np.asarray, jax_zoo.init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    dec = rng.integers(0, cfg.vocab, (2, B)).astype(np.int32)
    max_len = zoo.cache_max_len(cfg, S + MAX_NEW)
    args = (params, tokens[:, :-1], tokens[:, 1:], dec, max_len)
    return {"ref": _run_reference(jcfg, *args), "port": _run_port(cfg, *args),
            "tol": tol, "max_len": max_len}


def _close(a, b, tol):
    a = a.float().numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=tol,
                               rtol=tol)


def test_forward_logits(case):
    assert tuple(case["port"]["logits"].shape) == case["ref"]["logits"].shape
    _close(case["port"]["logits"], case["ref"]["logits"], case["tol"])


def test_loss(case):
    _close(case["port"]["loss"], case["ref"]["loss"], case["tol"])


@pytest.mark.parametrize("step", [0, 1, 2], ids=["prefill", "decode1",
                                                 "decode2"])
def test_serving_step(case, step):
    (lg, cache), (rlg, rcache) = (case["port"]["steps"][step],
                                  case["ref"]["steps"][step])
    _close(lg, rlg, case["tol"])
    assert int(cache["len"]) == int(rcache["len"])
    assert tuple(cache["k"].shape) == rcache["k"].shape
    assert cache["k"].shape[1] == case["max_len"]
    _close(cache["k"], rcache["k"], case["tol"])
    _close(cache["v"], rcache["v"], case["tol"])


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-3-8b"])
def test_init_cache_layout(arch):
    cfg = get_config(arch)
    cache = transformer.init_cache(cfg, 3, 40, torch.device("meta"))
    ref = jax_transformer.abstract_cache(jax_get_config(arch), 3, 40)
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == ref[name].shape
        assert str(cache[name].dtype).removeprefix("torch.") == \
            str(ref[name].dtype)
    assert cache["len"] == 0
