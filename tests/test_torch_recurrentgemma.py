"""Port's recurrentgemma against ``repro.models.zoo`` with bridged params,
on the recurrentgemma SMOKE config (5 layers: one super-block of
(rglru, rglru, attn) and 2 tail rglru blocks, window 8): forward logits,
loss, prefill logits and every cache leaf, and two decode steps.

S=12 is above the window, so the prefill trims the k/v cache to the
trailing 8 positions and both decode steps write into the ring buffer
past its end (slots 0 and 1).  float32 at 1e-4: the reference's
associative scan and the port's sequential scan sum in other orders (the
observed gap is under 1e-5).  bfloat16 at the kernel tests' 2e-2, with
the reference compiled once per dtype and ``xla_allow_excess_precision``
off (see tests/test_torch_transformer.py).  In bf16 the two packages'
blocks agree bit for bit on the same inputs, but XLA and torch sum their
bf16 matmuls in other orders and compute their float32 transcendentals to
other ulps; each such difference can flip one bf16 rounding, and the
recurrence and the bf16 residual stream carry the flips on, so a few
entries can land outside 2e-2.  Such an array passes only if its largest
gap to the reference stays below the reference's own bf16 error (its
largest gap to the float32 reference on the same inputs).  Then both
``ServeEngine``s serve the same requests, and ``cast_matrices`` keeps
``log_a`` in float32.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import recurrentgemma as jax_rg
from repro.models import zoo as jax_zoo
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rglru import rglru
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import recurrentgemma, zoo
from repro_torch.models.common import cast_matrices, tree_map
from repro_torch.serving import Request, ServeEngine

ARCH = "recurrentgemma-2b"
B, S, MAX_NEW = 2, 12, 4
CASES = {"float32": 1e-4, "bfloat16": 2e-2}
_XLA_OPTS = {"xla_allow_excess_precision": False}


def _configs(dtype):
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    return jcfg, cfg


@pytest.fixture(scope="module")
def params_np():
    """The reference's param tree drawn with numpy (faster than
    ``jax_zoo.init`` and the same for both packages): its init laws, with
    the zero-initialised vectors (norm scales, ``conv_b``, ``log_a``)
    drawn non-zero so that they are exercised."""
    jcfg, _ = _configs("float32")
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        shape = leaf.shape
        if path == "embed/table":
            scale = 0.02
        elif len(shape) >= 3:
            scale = shape[-2] ** -0.5
        else:
            scale = 0.1
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return tree_map(draw, jax_zoo.abstract(jcfg))


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


def _snapshot(cache):
    # decode_step writes the cache in place: keep a copy of each state
    return tree_map(lambda _, v: v.clone() if torch.is_tensor(v) else v,
                    cache)


def _run_port(cfg, params, tokens, targets, dec, max_len):
    tp = params_from_jax(params)
    tok = torch.from_numpy(tokens).long()
    logits, _ = zoo.forward(cfg, tp, {"tokens": tok})
    loss, _ = zoo.loss_fn(cfg, tp, {"tokens": tok,
                                    "targets": torch.from_numpy(targets)})
    lg, cache = zoo.prefill(cfg, tp, {"tokens": tok}, max_len)
    steps = [(lg, _snapshot(cache))]
    for i, pos in enumerate((S, S + 1)):
        lg, cache = zoo.decode_step(cfg, tp, cache,
                                    torch.from_numpy(dec[i]).long(), pos)
        steps.append((lg, _snapshot(cache)))
    return {"logits": logits, "loss": loss, "steps": steps}


def _flat(out):
    """name -> array of every compared output, caches included."""
    flat = {"logits": out["logits"], "loss": out["loss"]}
    for i, (lg, cache) in enumerate(out["steps"]):
        flat[f"step{i}/logits"] = lg
        flat.update({f"step{i}/{k}": v for k, v in _leaves(cache).items()})
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
        max_len = zoo.cache_max_len(cfg, S + MAX_NEW)
        args = (params_np, tokens[:, :-1], tokens[:, 1:], dec, max_len)
        out[dtype] = {"ref": _flat(_run_reference(jcfg, *args)),
                      "port": _flat(_run_port(cfg, *args)),
                      "max_len": max_len}
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
    if dtype == "float32":
        np.testing.assert_allclose(_np(mine), _np(ref), atol=tol, rtol=tol)
        return
    gap = np.abs(_np(mine) - _np(ref))
    if np.all(gap <= tol + tol * np.abs(_np(ref))):
        return
    own = np.abs(_np(ref) - _np(runs["float32"]["ref"][name])).max()
    assert gap.max() <= own, (name, float(gap.max()), float(own))
    warnings.warn(f"bf16 {name}: max gap {gap.max():.4g} to the reference "
                  f"misses 2e-2, within its own bf16 error {own:.4g}")


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.mark.parametrize("dtype", list(CASES))
def test_forward_logits(runs, dtype):
    _check(runs, dtype, "logits")


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
        "logits", "rec1/h", "rec1/conv", "rec2/h", "rec2/conv", "tail/h",
        "tail/conv", "k", "v", "len"}
    max_len = runs[dtype]["max_len"]
    assert int(mine[f"step{step}/len"]) == int(ref[f"step{step}/len"]) == \
        min(S, max_len) + step
    assert mine[f"step{step}/k"].shape[1] == max_len < S   # trimmed
    for name in sorted(names - {f"step{step}/len"}):
        _check(runs, dtype, name)


def test_init_cache_layout():
    cfg = get_config(ARCH)
    cache = recurrentgemma.init_cache(cfg, 3, 40, torch.device("meta"))
    ref = _leaves(jax_rg.abstract_cache(jax_get_config(ARCH), 3, 40))
    mine = _leaves(cache)
    assert mine.pop("len") == 0 and set(mine) == set(ref) - {"len"}
    for path, t in mine.items():
        assert tuple(t.shape) == ref[path].shape, path
        assert str(t.dtype).removeprefix("torch.") == str(ref[path].dtype)


def test_cast_matrices_keeps_log_a_float32(params_np):
    cast = _leaves(cast_matrices(params_from_jax(params_np), torch.bfloat16))
    for path, t in cast.items():
        name = path.split("/")[-1]
        keep = name == "log_a" or name.endswith("norm")
        assert t.dtype == (torch.float32 if keep else torch.bfloat16), path
    assert {p for p in cast if p.endswith("log_a")} == {
        "supers/rec1/log_a", "supers/rec2/log_a", "tail/log_a"}


# ServeEngine: one wave of 2 slots with a shorter prompt (left-padding and
# its exact re-prefill) whose decode wraps the ring buffer
N_SLOTS, MAX_LEN, TIE = 2, 64, 1e-4
WORKLOAD = [(11, 4), (6, 4)]


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
    launches = (rglru.launches, flash_attention.launches)
    ref = {r.rid: r.output for r in ref_eng.run()}
    mine = {r.rid: r.output for r in eng.run()}
    assert (rglru.launches, flash_attention.launches) == launches  # CPU
    assert eng.prefill_calls == 2            # the wave + one re-prefill
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


def test_launcher_serves_recurrentgemma_on_cpu():
    out = serve_launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                               "--requests", "2", "--max-new", "2",
                               "--slots", "2"])
    assert out["arch"] == "recurrentgemma-smoke"
    assert out["requests"] == 2 and out["generated_tokens"] == 4
