"""Port's transformer (dense and MoE families) against
``repro.models.zoo`` with bridged params: forward logits and aux loss,
loss, prefill logits and cache, two decode steps.

Smoke configs in float32 at atol 1e-4 (the two frameworks sum in other
orders), one sliding-window variant (trailing-window prefill, ring-buffer
decode) and one bfloat16 variant at the kernel tests' bf16 tolerance.
The MoE configs: mixtral-8x7b (top-2, window 8), llama4-scout-17b-a16e
(top-1), mixtral-8x7b at capacity factor 1.0 (routes dropped at this
size) and mixtral-8x7b in bfloat16.
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
from repro_torch.models import layers, transformer, zoo

B, S, MAX_NEW = 2, 12, 4
CASES = {
    # name: (arch, config overrides, tolerance)
    "olmo-1b": ("olmo-1b", {}, 1e-4),
    "granite-3-8b": ("granite-3-8b", {}, 1e-4),
    "codeqwen1.5-7b": ("codeqwen1.5-7b", {}, 1e-4),
    "olmo-1b-swa8": ("olmo-1b", {"window": 8}, 1e-4),
    "olmo-1b-bf16": ("olmo-1b", {"dtype": "bfloat16"}, 2e-2),
    "llama3-405b": ("llama3-405b", {}, 1e-4),
    "mixtral-8x7b": ("mixtral-8x7b", {}, 1e-4),
    "llama4-scout-17b-a16e": ("llama4-scout-17b-a16e", {}, 1e-4),
    "mixtral-8x7b-cf1": ("mixtral-8x7b", {"moe_capacity_factor": 1.0}, 1e-4),
    "mixtral-8x7b-bf16": ("mixtral-8x7b", {"dtype": "bfloat16"}, 2e-2),
}
_XLA_OPTS = {"xla_allow_excess_precision": False}


def _run_reference(jcfg, params, tokens, targets, dec, max_len):
    p = jax.tree.map(jnp.asarray, params)

    @jax.jit
    def run(p, tok, tgt, d1, d2):
        logits, aux = jax_zoo.forward(jcfg, p, {"tokens": tok})
        loss, _ = jax_zoo.loss_fn(jcfg, p, {"tokens": tok, "targets": tgt})
        l0, c0 = jax_zoo.prefill(jcfg, p, {"tokens": tok}, max_len)
        l1, c1 = jax_zoo.decode_step(jcfg, p, c0, d1, S)
        l2, c2 = jax_zoo.decode_step(jcfg, p, c1, d2, S + 1)
        return {"logits": logits, "aux": aux, "loss": loss,
                "steps": ((l0, c0), (l1, c1), (l2, c2))}

    args = (p, tokens, targets, dec[0], dec[1])
    return run.lower(*args).compile(compiler_options=_XLA_OPTS)(*args)


def _run_port(cfg, params, tokens, targets, dec, max_len):
    tp = params_from_jax(params)
    tok = torch.from_numpy(tokens).long()
    logits, aux = zoo.forward(cfg, tp, {"tokens": tok})
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
    return {"logits": logits, "aux": aux, "loss": loss, "steps": steps}


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
            "tol": tol, "max_len": max_len, "moe": bool(cfg.moe_experts)}


def _close(a, b, tol):
    a = a.float().numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=tol,
                               rtol=tol)


def test_forward_logits(case):
    assert tuple(case["port"]["logits"].shape) == case["ref"]["logits"].shape
    _close(case["port"]["logits"], case["ref"]["logits"], case["tol"])


def test_aux_loss(case):
    """The summed MoE load-balancing loss (zero for the dense family)."""
    assert case["port"]["aux"].dtype == torch.float32
    _close(case["port"]["aux"], case["ref"]["aux"], case["tol"])
    if not case["moe"]:
        assert float(case["port"]["aux"]) == 0.0


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


def test_capacity_one_drops_routes_at_smoke_size(monkeypatch):
    """The "mixtral-8x7b-cf1" case drops routes: in its forward some expert
    gets more routes in a batch row than its capacity."""
    arch, over, _ = CASES["mixtral-8x7b-cf1"]
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), **over)
    params = params_from_jax(jax.tree.map(
        np.asarray, jax_zoo.init(jcfg, jax.random.PRNGKey(0))))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S + 1))
    overflow = []
    block = layers.moe_block

    def recorded(p, x, *, n_experts, top_k, capacity_factor):
        _, _, idx = layers.moe_route(p, x, top_k)
        counts = torch.nn.functional.one_hot(idx, n_experts).sum(dim=(1, 2))
        cap = layers.moe_capacity(x.shape[1], n_experts, top_k,
                                  capacity_factor)
        overflow.append(int(counts.max()) - cap)
        return block(p, x, n_experts=n_experts, top_k=top_k,
                     capacity_factor=capacity_factor)

    monkeypatch.setattr(layers, "moe_block", recorded)
    zoo.forward(cfg, params, {"tokens": torch.from_numpy(tokens[:, :-1])})
    assert len(overflow) == cfg.n_layers and max(overflow) > 0, overflow


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-3-8b", "mixtral-8x7b"])
def test_init_cache_layout(arch):
    cfg = get_config(arch)
    cache = transformer.init_cache(cfg, 3, 40, torch.device("meta"))
    ref = jax_transformer.abstract_cache(jax_get_config(arch), 3, 40)
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == ref[name].shape
        assert str(cache[name].dtype).removeprefix("torch.") == \
            str(ref[name].dtype)
    assert cache["len"] == 0
