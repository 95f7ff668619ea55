"""Port's rwkv6 against ``repro.models.zoo`` with bridged params, on the
rwkv6 SMOKE config (2 layers, d_model 64, 4 heads of dim 16): forward
logits, loss, prefill logits and all three caches, and two decode steps.

The reference inits ``tm_mu``, ``tm_lora_b``, ``w0``, ``w_lora_b``, ``u``
and ``cm_mu`` to zero; with them at zero every decay is e^-1 and both
token shifts vanish.  Here they are drawn non-zero (as ``chip_smoke.py``
draws them): ``w0`` ~ U(-8, 3.5), which takes some decays below the
reference's 1e-8 clip, ``w_lora_b`` ~ N(0, 0.1), ``tm_lora_b`` ~
N(0, 0.02), the mixing amounts ~ U(0, 1) and ``u`` ~ N(0, 0.5).

float32 at 1e-4: the reference runs the recurrence in its chunked form
(exps and logs of cumulative log-decays), the port as an exact per-step
scan, and the two sum in other orders.  bfloat16 at the
kernel tests' 2e-2, the reference compiled with
``xla_allow_excess_precision`` off (see tests/test_torch_transformer.py);
as for recurrentgemma (tests/test_torch_recurrentgemma.py), an array
outside 2e-2 passes only within the reference's own bf16 error against
its float32 run on the same inputs, and both numbers are reported.  On
the CPU the WKV6 wrapper runs its plain version; the forward that
``chip_smoke.py`` holds the kernel to (``wkv_fn=wkv6_plain``) is held to
the reference's logits too.  Then both ``ServeEngine``s serve the same
ragged requests, one of prime length above 64 so that the reference's
chunk rule falls to 1.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import rwkv6 as jax_rwkv6
from repro.models import zoo as jax_zoo
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels.rwkv6 import wkv6, wkv6_plain
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import rwkv6, zoo
from repro_torch.models.common import tree_map
from repro_torch.serving import Request, ServeEngine

ARCH = "rwkv6-1.6b"
B, S = 2, 12
CASES = {"float32": 1e-4, "bfloat16": 2e-2}
_XLA_OPTS = {"xla_allow_excess_precision": False}


def _configs(dtype):
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    return jcfg, cfg


def draw_params(abstract_tree, seed=0):
    """The reference's tree drawn with numpy: its init laws for the
    matrices, the zero-initialised leaves drawn as the module docstring
    says, norm scales ~ N(0, 0.1) and ``ln_x`` ~ 1 + N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    special = {
        "w0": lambda s: rng.uniform(-8.0, 3.5, s),
        "w_lora_b": lambda s: rng.standard_normal(s) * 0.1,
        "tm_lora_b": lambda s: rng.standard_normal(s) * 0.02,
        "tm_mu": lambda s: rng.uniform(0.0, 1.0, s),
        "cm_mu": lambda s: rng.uniform(0.0, 1.0, s),
        "u": lambda s: rng.standard_normal(s) * 0.5,
        "ln_x": lambda s: 1.0 + rng.standard_normal(s) * 0.1,
    }

    def draw(path, leaf):
        name, shape = path.split("/")[-1], leaf.shape
        if name in special:
            a = special[name](shape)
        elif name.endswith("norm"):
            a = rng.standard_normal(shape) * 0.1
        else:
            scale = 0.02 if name in ("table", "unembed") else \
                shape[-2] ** -0.5
            a = rng.standard_normal(shape) * scale
        return a.astype(np.float32)

    return tree_map(draw, abstract_tree)


@pytest.fixture(scope="module")
def params_np():
    return draw_params(jax_zoo.abstract(_configs("float32")[0]))


def _run_reference(jcfg, params, tokens, targets, dec):
    p = jax.tree.map(jnp.asarray, params)

    @jax.jit
    def run(p, tok, tgt, d1, d2):
        logits, _ = jax_zoo.forward(jcfg, p, {"tokens": tok})
        loss, _ = jax_zoo.loss_fn(jcfg, p, {"tokens": tok, "targets": tgt})
        l0, c0 = jax_zoo.prefill(jcfg, p, {"tokens": tok}, 1)
        l1, c1 = jax_zoo.decode_step(jcfg, p, c0, d1, S)
        l2, c2 = jax_zoo.decode_step(jcfg, p, c1, d2, S + 1)
        return {"logits": logits, "loss": loss,
                "steps": ((l0, c0), (l1, c1), (l2, c2))}

    args = (p, tokens, targets, dec[0], dec[1])
    return run.lower(*args).compile(compiler_options=_XLA_OPTS)(*args)


def _snapshot(cache):
    # decode_step writes the cache in place: keep a copy of each state
    return tree_map(lambda _, v: v.clone() if torch.is_tensor(v) else v,
                    cache)


def _run_port(cfg, params, tokens, targets, dec):
    tp = params_from_jax(params)
    tok = torch.from_numpy(tokens).long()
    logits, _ = zoo.forward(cfg, tp, {"tokens": tok})
    loss, _ = zoo.loss_fn(cfg, tp, {"tokens": tok,
                                    "targets": torch.from_numpy(targets)})
    lg, cache = zoo.prefill(cfg, tp, {"tokens": tok}, 1)
    steps = [(lg, _snapshot(cache))]
    for i, pos in enumerate((S, S + 1)):
        lg, cache = zoo.decode_step(cfg, tp, cache,
                                    torch.from_numpy(dec[i]).long(), pos)
        steps.append((lg, _snapshot(cache)))
    # the plain path the card's checks hold the kernel path to
    plain_logits, _ = zoo.forward(cfg, tp, {"tokens": tok},
                                  wkv_fn=wkv6_plain)
    return {"logits": logits, "loss": loss, "steps": steps,
            "plain_logits": plain_logits}


def _flat(out):
    """name -> array of every compared output, caches included."""
    flat = {k: out[k] for k in ("logits", "loss", "plain_logits") if k in out}
    for i, (lg, cache) in enumerate(out["steps"]):
        flat[f"step{i}/logits"] = lg
        flat.update({f"step{i}/{k}": v for k, v in cache.items()})
    return flat


@pytest.fixture(scope="module")
def runs(params_np):
    rng = np.random.default_rng(0)
    vocab = get_config(ARCH, smoke=True).vocab
    tokens = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    dec = rng.integers(0, vocab, (2, B)).astype(np.int32)
    out = {}
    for dtype in CASES:
        jcfg, cfg = _configs(dtype)
        args = (params_np, tokens[:, :-1], tokens[:, 1:], dec)
        ref = _flat(_run_reference(jcfg, *args))
        ref["plain_logits"] = ref["logits"]
        out[dtype] = {"ref": ref, "port": _flat(_run_port(cfg, *args))}
    return out


def _np(a):
    if torch.is_tensor(a):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _check(runs, dtype, name):
    mine, ref = runs[dtype]["port"][name], runs[dtype]["ref"][name]
    assert tuple(mine.shape) == ref.shape, name
    assert str(mine.dtype).removeprefix("torch.") == str(ref.dtype), name
    tol = CASES[dtype]
    gap = np.abs(_np(mine) - _np(ref))
    if dtype == "float32":
        np.testing.assert_allclose(_np(mine), _np(ref), atol=tol, rtol=tol)
        return float(gap.max())
    own = np.abs(_np(ref) - _np(runs["float32"]["ref"][name])).max()
    print(f"bf16 {name}: max gap {gap.max():.4g} to the reference, its own "
          f"bf16 error {own:.4g}")
    if np.all(gap <= tol + tol * np.abs(_np(ref))):
        return float(gap.max())
    assert gap.max() <= own, (name, float(gap.max()), float(own))
    warnings.warn(f"bf16 {name}: max gap {gap.max():.4g} to the reference "
                  f"misses 2e-2, within its own bf16 error {own:.4g}")
    return float(gap.max())


@pytest.mark.parametrize("name", ["logits", "plain_logits"],
                         ids=["wrapper", "wkv6_plain"])
@pytest.mark.parametrize("dtype", list(CASES))
def test_forward_logits(runs, dtype, name):
    _check(runs, dtype, name)


@pytest.mark.parametrize("dtype", list(CASES))
def test_loss(runs, dtype):
    _check(runs, dtype, "loss")


@pytest.mark.parametrize("step", [0, 1, 2], ids=["prefill", "decode1",
                                                 "decode2"])
@pytest.mark.parametrize("dtype", list(CASES))
def test_serving_step(runs, dtype, step):
    mine, ref = runs[dtype]["port"], runs[dtype]["ref"]
    names = {n for n in ref if n.startswith(f"step{step}/")}
    assert {n for n in mine if n.startswith(f"step{step}/")} == names
    assert {n.split("/", 1)[1] for n in names} == {
        "logits", "tm_state", "tm_prev", "cm_prev", "len"}
    assert int(mine[f"step{step}/len"]) == int(ref[f"step{step}/len"]) == \
        S + step
    for name in sorted(names - {f"step{step}/len"}):
        _check(runs, dtype, name)


def test_init_cache_layout():
    cfg = get_config(ARCH)
    cache = rwkv6.init_cache(cfg, 3, 40, torch.device("meta"))
    ref = jax_rwkv6.abstract_cache(jax_get_config(ARCH), 3, 40)
    assert cache.pop("len") == 0 and set(cache) == set(ref) - {"len"}
    for name, t in cache.items():
        assert tuple(t.shape) == ref[name].shape, name
        assert str(t.dtype).removeprefix("torch.") == str(ref[name].dtype)
    assert zoo.cache_max_len(cfg, 5000) == 1


# ServeEngine: two waves on 2 slots; the first has a prompt of prime
# length 67 (chunk 1 in both packages) and a shorter one (left-padding and
# its exact re-prefill)
N_SLOTS, MAX_LEN, TIE = 2, 128, 1e-4
WORKLOAD = [(67, 4), (20, 4), (9, 3)]


def test_serve_engine_matches_reference(params_np):
    jcfg, cfg = _configs("float32")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n, _ in WORKLOAD]
    ref_eng = JaxServeEngine(jcfg, jax.tree.map(jnp.asarray, params_np),
                             n_slots=N_SLOTS, max_len=MAX_LEN)
    eng = ServeEngine(cfg, params_from_jax(params_np), n_slots=N_SLOTS,
                      max_len=MAX_LEN)
    for e, req in ((ref_eng, JaxRequest), (eng, Request)):
        for i, (p, (_, mx)) in enumerate(zip(prompts, WORKLOAD)):
            e.submit(req(rid=i, prompt=p, max_new_tokens=mx))
    launches = wkv6.launches
    ref = {r.rid: r.output for r in ref_eng.run()}
    mine = {r.rid: r.output for r in eng.run()}
    assert wkv6.launches == launches            # CPU: no kernel
    assert eng.prefill_calls == 3     # two waves + one exact re-prefill
    assert [len(mine[i]) for i in range(len(WORKLOAD))] == [
        mx for _, mx in WORKLOAD]
    diff = [rid for rid in ref if ref[rid] != mine[rid]]
    if diff:
        # allowed only where the port's own logits were at a near tie:
        # replay each differing request's first step through the port
        tp = params_from_jax(params_np)
        for rid in diff:
            lg, _ = zoo.prefill(cfg, tp, {"tokens": torch.from_numpy(
                prompts[rid]).long()[None]}, MAX_LEN)
            top2 = lg[0].topk(2).values
            assert float(top2[0] - top2[1]) < TIE, (rid, ref[rid], mine[rid])
        warnings.warn(f"requests {diff} differ at a near tie")


def test_launcher_serves_rwkv6_on_cpu():
    out = serve_launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                               "--requests", "2", "--max-new", "2",
                               "--slots", "2"])
    assert out["arch"] == "rwkv6-1.6b-smoke"
    assert out["requests"] == 2 and out["generated_tokens"] == 4


def test_launcher_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the refusal path cannot be exercised")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_launcher.main(["--arch", ARCH, "--smoke"])
