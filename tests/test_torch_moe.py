"""Port's MoE block (``repro_torch.models.layers.moe_block``) against the
reference's ``repro.models.layers.moe_block`` and ``jax.grad`` of it.

Each case draws x and the params with numpy from a seed, runs the
reference once (one function compiled per case, with XLA's
``xla_allow_excess_precision`` off, see tests/test_torch_transformer.py)
and the port on the same arrays, and holds ``out``, ``aux`` and the
gradients of ``sum(out * cot) + c * aux`` (a random cotangent) with
respect to x, router, w_gate, w_up and w_down.  float32 at 1e-5; the
bfloat16 case's ``out`` at one bf16 ulp of each element (the one-hot
dispatch is exact, the gate values are rounded to bf16 before they scale
the expert outputs, SiLU runs in fp32).  The cases: top-1 with E=16,
top-2 with E=8, capacity drops (capacity factor 1.0, a router skewed so
that more than capacity pick one expert), ties (a zero router: every
probability 1/E, where ``lax.top_k`` takes the lower indices), S=1 (the
decode step, capacity 1), grouping (``MOE_GROUP`` lowered to 16 at S=32,
held against the reference on x reshaped to (2B, 16, D)) and bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jax_layers
from repro_torch.models import layers

D, F = 32, 48
_XLA_OPTS = {"xla_allow_excess_precision": False}
AUX_COT = 0.7
NAMES = ("x", "router", "w_gate", "w_up", "w_down")

# name: (B, S, E, k, capacity factor, router, dtype, port's MOE_GROUP)
CASES = {
    "top1-e16": (2, 24, 16, 1, 1.25, "random", "float32", None),
    "top2-e8": (2, 24, 8, 2, 1.25, "random", "float32", None),
    "drops": (2, 32, 4, 2, 1.0, "skewed", "float32", None),
    "ties": (2, 16, 4, 2, 1.25, "zero", "float32", None),
    "decode-s1": (3, 1, 8, 2, 1.25, "random", "float32", None),
    "grouped": (2, 32, 8, 2, 1.25, "random", "float32", 16),
    "bf16": (2, 24, 8, 2, 1.25, "random", "bfloat16", None),
}


def _arrays(b, s, e, router, seed=0):
    """x (B,S,D), the params and an out cotangent, float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, D)).astype(np.float32)
    r = (rng.standard_normal((D, e)) / np.sqrt(D)).astype(np.float32)
    if router == "zero":
        r = np.zeros_like(r)
    elif router == "skewed":
        # a shared offset on x and two router columns along it: most
        # tokens rank expert 0 first and expert 1 second
        x = x + 1.0
        r = 0.1 * r
        r[:, 0] += 0.5 / np.sqrt(D)
        r[:, 1] += 0.45 / np.sqrt(D)
    p = {"router": r,
         "w_gate": rng.standard_normal((e, D, F)).astype(np.float32)
         / np.sqrt(D),
         "w_up": rng.standard_normal((e, D, F)).astype(np.float32)
         / np.sqrt(D),
         "w_down": rng.standard_normal((e, F, D)).astype(np.float32)
         / np.sqrt(F)}
    cot = rng.standard_normal((b, s, D)).astype(np.float32)
    return x, p, cot


def _reference(x, p, cot, *, e, k, cf, dtype):
    """The reference's out, aux and gradients, compiled once."""
    jdt = getattr(jnp, dtype)

    def loss(x, p):
        out, aux = jax_layers.moe_block(p, x.astype(jdt), n_experts=e,
                                        top_k=k, capacity_factor=cf)
        return (jnp.sum(out.astype(jnp.float32) * cot) + AUX_COT * aux,
                (out, aux))

    fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    args = (jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    (_, (out, aux)), (gx, gp) = fn.lower(*args).compile(
        compiler_options=_XLA_OPTS)(*args)
    grads = {"x": gx, **gp}
    return (np.asarray(out.astype(jnp.float32)), float(aux),
            {n: np.asarray(g) for n, g in grads.items()})


def _port(x, p, cot, *, e, k, cf, dtype):
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = {n: torch.from_numpy(a).requires_grad_(True) for n, a in p.items()}
    out, aux = layers.moe_block(tp, tx.to(getattr(torch, dtype)),
                                n_experts=e, top_k=k, capacity_factor=cf)
    loss = (out.float() * torch.from_numpy(cot)).sum() + AUX_COT * aux
    grads = torch.autograd.grad(loss, [tx, *(tp[n] for n in NAMES[1:])])
    return out, aux, dict(zip(NAMES, grads))


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    b, s, e, k, cf, router, dtype, group = CASES[request.param]
    x, p, cot = _arrays(b, s, e, router)
    if group is None:
        ref = _reference(x, p, cot, e=e, k=k, cf=cf, dtype=dtype)
    else:
        # the reference splits only above 4096 tokens: give it the groups
        g = b * s // group
        out, aux, grads = _reference(x.reshape(g, group, D), p,
                                     cot.reshape(g, group, D), e=e, k=k,
                                     cf=cf, dtype=dtype)
        grads["x"] = grads["x"].reshape(b, s, D)
        ref = (out.reshape(b, s, D), aux, grads)
    mp = pytest.MonkeyPatch()
    if group is not None:
        mp.setattr(layers, "MOE_GROUP", group)
    try:
        port = _port(x, p, cot, e=e, k=k, cf=cf, dtype=dtype)
    finally:
        mp.undo()
    return {"name": request.param, "x": x, "p": p, "e": e, "k": k, "cf": cf,
            "s": group or s, "dtype": dtype, "ref": ref, "port": port}


def _bf16_ulp(a):
    """One bf16 ulp of each element of ``a`` (float32): 2^(exponent - 7)."""
    a = np.abs(np.asarray(a, np.float32))
    return np.exp2(np.floor(np.log2(np.maximum(a, 1e-30))) - 7)


def test_out_and_aux(case):
    out, aux = case["port"][:2]
    ref_out, ref_aux = case["ref"][:2]
    assert out.dtype == getattr(torch, case["dtype"])
    assert aux.dtype == torch.float32
    assert tuple(out.shape) == ref_out.shape
    got = out.detach().float().numpy()
    if case["dtype"] == "bfloat16":
        assert np.all(np.abs(got - ref_out) <= _bf16_ulp(ref_out))
    else:
        np.testing.assert_allclose(got, ref_out, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), ref_aux, atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_gradients(case, name):
    got = case["port"][2][name].float().numpy()
    want = case["ref"][2][name].astype(np.float32)
    assert got.shape == want.shape
    if case["dtype"] == "bfloat16":
        # bf16 activations: held within 2e-2 of the largest |g|
        scale = 2e-2 * float(np.max(np.abs(want)))
        assert float(np.max(np.abs(got - want))) <= scale
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _routes(case):
    x, p = torch.from_numpy(case["x"]), {n: torch.from_numpy(a)
                                         for n, a in case["p"].items()}
    return layers.moe_route(p, x.reshape(-1, case["s"], D), case["k"])


def test_case_exercises_its_path(case):
    """Each case reaches what it is named for."""
    probs, vals, idx = _routes(case)
    e, k, s = case["e"], case["k"], case["s"]
    cap = layers.moe_capacity(s, e, k, case["cf"])
    first = torch.nn.functional.one_hot(idx[..., 0], e).sum(dim=1)
    if case["name"] == "drops":
        assert int(first.max()) > cap          # slot 0 alone overflows
    if case["name"] == "ties":
        assert torch.all(probs == 1.0 / e)
        assert torch.equal(idx, torch.arange(k).expand_as(idx))
        # the lower indices win, as lax.top_k's do
        assert jax.lax.top_k(jnp.full((e,), 1.0 / e), k)[1].tolist() == \
            list(range(k))
    if case["name"] == "decode-s1":
        assert cap == 1
    if case["name"] == "grouped":
        assert s == 16 and case["x"].shape[1] == 32


@pytest.mark.parametrize("s,e,k,cf,want", [
    (1, 8, 2, 1.25, 1),          # decode: at most S
    (3, 8, 2, 1.25, 3),
    (32, 4, 2, 1.0, 16),
    (24, 16, 1, 1.25, 4),        # the floor of 4
    (4093, 8, 2, 1.25, 1279),    # the mixtral-8x7b prefill on the card
    (2048, 8, 2, 1.25, 640),
    (10, 8, 2, 1.3, 4),          # int(26.0) before the ceiling division
])
def test_capacity_rule(s, e, k, cf, want):
    assert layers.moe_capacity(s, e, k, cf) == want


def test_long_sequence_must_fill_groups():
    p = {n: torch.zeros(sh) for n, sh in (("router", (D, 4)),
                                          ("w_gate", (4, D, F)),
                                          ("w_up", (4, D, F)),
                                          ("w_down", (4, F, D)))}
    with pytest.raises(ValueError, match="multiple"):
        layers.moe_block(p, torch.zeros(1, layers.MOE_GROUP + 1, D),
                         n_experts=4, top_k=2)
