"""Port's training path against the reference (``repro.train``,
``repro.data``, ``repro.models.zoo``), on the CPU.

* Gradients of ``zoo.loss_fn`` for olmo-1b, recurrentgemma-2b,
  rwkv6-1.6b, mixtral-8x7b (its MoE aux term included),
  llama-3.2-vision-11b and whisper-small (smoke configs, float32; rwkv6's
  six zero-initialised leaves drawn non-zero as
  ``tests/test_torch_rwkv6.py`` draws them, the vlm's two zero-initialised
  cross gates drawn as ``tests/test_torch_vlm.py`` draws them, and a
  random frontend in the vlm and audio batches) against
  ``jax.grad`` of the reference's, per leaf within ``GRAD_TOL`` of the
  leaf's largest |g|: the reference sums in other orders, and runs the
  RG-LRU as an associative scan and the WKV6 in its chunked form where
  the port runs both as exact per-step scans.  One bfloat16 case
  (olmo-1b) at the kernel tests' 2e-2, the reference compiled with
  ``xla_allow_excess_precision`` off (see tests/test_torch_transformer.py).
  Per-layer remat ("full") gives the port's gradients bit for bit.
* One ``make_train_step`` step of both packages from one bridged state
  (olmo-1b, 2 microbatches, ``remat=True``), with and without top-k
  compression, and the same for mixtral-8x7b without compression.  Adam's first step is about lr * sign(g), so the new
  params are compared where |g| is far above the two packages' gradient
  gap (``_significant``); loss, lr, grad_norm, mu and nu everywhere.
* The 4-step loss decrease of tests/test_models_smoke.py on the four
  smoke configs, and on the vlm and audio ones.
* Checkpoints saved by either package restore in the other (bf16
  moments included) and both lay out the same files; ``latest_step``,
  ``keep_last_k``, ``LATEST`` and ``run_with_recovery`` behave as the
  reference's.
* ``SyntheticLM`` and ``MmapTokens`` give the reference's batches; the
  train launcher prints the reference's JSON keys, and serve restores
  its checkpoint.
* ``make_eval_step``, ``make_prefill_step``, ``make_serve_step`` and
  ``abstract_state`` against the reference's; a restore lands on the
  checkpoint manager's device.
* ``kernels._grad.KernelFn``, run with a launch that is the plain version
  (no kernel here), gives the plain version's gradients.
"""

import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import make_source as jax_make_source
from repro.models import zoo as jax_zoo
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import CompressionConfig as JaxCompressionConfig
from repro.optim import init_error_state as jax_init_error_state
from repro.optim import init_opt_state as jax_init_opt_state
from repro.train import CheckpointManager as JaxCheckpointManager
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import abstract_state as jax_abstract_state
from repro.train import make_eval_step as jax_make_eval_step
from repro.train import make_prefill_step as jax_make_prefill_step
from repro.train import make_serve_step as jax_make_serve_step
from repro.train import make_train_step as jax_make_train_step
from repro.train import run_with_recovery as jax_run_with_recovery
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, make_source
from repro_torch.kernels._grad import KernelFn
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rglru import rglru_plain
from repro_torch.kernels.rwkv6 import wkv6_plain
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import layers, zoo
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, CompressionConfig
from repro_torch.train import (CheckpointManager, TrainConfig, abstract_state,
                               init_state, make_eval_step, make_prefill_step,
                               make_serve_step, make_train_step,
                               run_with_recovery)
from test_torch_rwkv6 import draw_params
from test_torch_vlm import draw_gates, frontend_np

ARCHS = ("olmo-1b", "recurrentgemma-2b", "rwkv6-1.6b", "mixtral-8x7b")
# the families whose batches carry a frontend
FRONTEND_ARCHS = ("llama-3.2-vision-11b", "whisper-small")
B, S = 2, 12
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
_XLA_OPTS = {"xla_allow_excess_precision": False}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _rel_gap(got: dict, want: dict) -> dict:
    """Per path: max |got - want| over max |want|."""
    return {p: float(np.max(np.abs(_f32(got[p]) - _f32(w)))
                     / max(float(np.max(np.abs(_f32(w)))), 1e-30))
            for p, w in want.items()}


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=_XLA_OPTS)


@pytest.fixture(scope="module")
def smoke_params():
    """Float32 numpy params per arch, as both packages take them."""
    out = {}
    for arch in (*ARCHS, *FRONTEND_ARCHS):
        jcfg = jax_get_config(arch, smoke=True)
        if arch == "rwkv6-1.6b":
            out[arch] = draw_params(jax_zoo.abstract(jcfg))
        else:
            out[arch] = jax.tree.map(
                np.asarray, jax_zoo.init(jcfg, jax.random.PRNGKey(0)))
    out["llama-3.2-vision-11b"] = draw_gates(out["llama-3.2-vision-11b"])
    return out


def _batch_np(vocab, b=B, s=S, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32)}


def _port_grads(cfg, params_np, batch_np):
    tp = tree_map(lambda _, t: t.requires_grad_(True),
                  params_from_jax(params_np))
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    loss, _ = zoo.loss_fn(cfg, tp, batch)
    # olmo-1b's norm scales are unused (non-parametric norm): zeros, as
    # jax.grad gives them
    grads = torch.autograd.grad(loss, tree_leaves(tp), allow_unused=True,
                                materialize_grads=True)
    it = iter(grads)
    return float(loss.detach()), tree_map(lambda _, __: next(it), tp)


# ---------------------------------------------------------------------------
# gradients of the loss
# ---------------------------------------------------------------------------

# name: (arch, activation dtype, rwkv6's w0 range)
GRAD_CASES = {
    "olmo-1b": ("olmo-1b", "float32", None),
    "recurrentgemma-2b": ("recurrentgemma-2b", "float32", None),
    "rwkv6-1.6b": ("rwkv6-1.6b", "float32", (-8.0, 1.0)),
    "rwkv6-1.6b-clip": ("rwkv6-1.6b", "float32", (-8.0, 3.5)),
    "olmo-1b-bf16": ("olmo-1b", "bfloat16", None),
    "mixtral-8x7b": ("mixtral-8x7b", "float32", None),
    "llama-3.2-vision-11b": ("llama-3.2-vision-11b", "float32", None),
    "whisper-small": ("whisper-small", "float32", None),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_loss_gradients_match_reference(smoke_params, case):
    """rwkv6-1.6b: with tests/test_torch_rwkv6.py's w0 ~ U(-8, 3.5) some
    decays reach the 1e-8 clip, and the reference's chunked form gives NaN
    gradients: its intra-chunk decay matrix exp(ct - cum) overflows to inf
    at the causally masked entries, and the ``where`` that masks them
    passes 0 * inf = NaN back (ROADMAP "Faults found").  So that case
    ("-clip") holds the port's gradients finite everywhere and equal where
    the reference's are finite; the full comparison draws w0 ~ U(-8, 1),
    where no chunk's decay overflows."""
    arch, dtype, w0_range = GRAD_CASES[case]
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    params = smoke_params[arch]
    if w0_range is not None:
        # new dicts, so the module's tree stays as drawn
        params = jax.tree.map(lambda a: a, params)
        params["layers"]["w0"] = np.random.default_rng(11).uniform(
            *w0_range, params["layers"]["w0"].shape).astype(np.float32)
    batch = _batch_np(cfg.vocab)
    if zoo.needs_frontend(cfg):
        batch["frontend"] = frontend_np(cfg)
    jargs = (_jnp(params), _jnp(batch))
    jloss, jgrads = _compiled(jax.value_and_grad(
        lambda p, b: jax_zoo.loss_fn(jcfg, p, b)[0]), *jargs)(*jargs)
    loss, grads = _port_grads(cfg, params, batch)
    np.testing.assert_allclose(loss, float(jloss), rtol=GRAD_TOL[dtype])
    got, want = _flat(params_to_numpy(grads)), _flat(jgrads)
    assert all(np.isfinite(_f32(g)).all() for g in got.values())
    if case.endswith("-clip"):
        want = {p: w for p, w in want.items() if np.isfinite(w).all()}
        assert {"final_norm", "unembed"} <= set(want), sorted(want)
    gaps = _rel_gap(got, want)
    assert max(gaps.values()) <= GRAD_TOL[dtype], gaps
    if dtype == "float32":
        # per-layer remat recomputes the same forward: the same gradients
        _, remat = _port_grads(dataclasses.replace(cfg, remat="full"),
                               params, batch)
        for path, g in _flat(remat).items():
            assert torch.equal(g, _flat(grads)[path]), path


# ---------------------------------------------------------------------------
# one train step of both packages
# ---------------------------------------------------------------------------

def _stable(g_ref, g_port):
    """Where Adam's first step (about lr * sign(g)) cannot flip between the
    packages: |g| is at least 100 times the leaf's largest gradient gap,
    or g is zero in both (rows of the embedding no token reads; entries
    top-k compression drops)."""
    gap = float(np.max(np.abs(g_port - g_ref)))
    return (np.abs(g_ref) >= 100.0 * gap) | ((g_ref == 0) & (g_port == 0))


@pytest.mark.parametrize("arch,scheme", [
    pytest.param("olmo-1b", "none", id="none"),
    pytest.param("olmo-1b", "topk", id="topk"),
    pytest.param("mixtral-8x7b", "none", id="mixtral-8x7b")])
def test_train_step_matches_reference(smoke_params, arch, scheme):
    jcfg, cfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    opt = dict(lr=5e-3, total_steps=10, warmup_steps=1)
    comp = dict(scheme=scheme, topk_ratio=0.1)
    jtcfg = JaxTrainConfig(microbatches=2, remat=True,
                           optimizer=JaxAdamWConfig(**opt),
                           compression=JaxCompressionConfig(**comp))
    tcfg = TrainConfig(microbatches=2, remat=True,
                       optimizer=AdamWConfig(**opt),
                       compression=CompressionConfig(**comp))
    params = smoke_params[arch]
    state_np = {"params": params,
                "opt": jax.tree.map(np.asarray, jax_init_opt_state(
                    jtcfg.optimizer, params))}
    if scheme != "none":
        state_np["error"] = jax.tree.map(np.asarray,
                                         jax_init_error_state(params))
    batch = _batch_np(cfg.vocab, b=4)
    jargs = (_jnp(state_np), _jnp(batch))
    jstate, jm = _compiled(jax_make_train_step(jcfg, jtcfg), *jargs)(*jargs)
    tstate, tm = make_train_step(cfg, tcfg)(
        params_from_jax(state_np),
        {k: torch.from_numpy(v) for k, v in batch.items()})

    assert set(tm) == set(jm)
    for name in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-5, err_msg=name)
    if scheme != "none":
        assert np.float32(tm["compression_ratio"]) == np.float32(
            jm["compression_ratio"])
    got, want = _flat(params_to_numpy(tstate)), _flat(jstate)
    assert set(got) == set(want)
    assert int(got["opt/step"]) == int(want["opt/step"]) == 1
    gaps = _rel_gap(got, want)
    moments = {p: e for p, e in gaps.items() if p.startswith("opt/")
               and not p.endswith("step")}
    assert max(moments.values()) <= 1e-4, moments
    # mu = (1 - b1) * g_clipped after one step: |mu| and its gap stand for
    # |g| and the gradients' gap
    for path in _flat(params):
        mask = _stable(_f32(want[f"opt/mu/{path}"]),
                       _f32(got[f"opt/mu/{path}"]))
        assert mask.mean() >= 0.9, (path, mask.mean())
        p_got, p_want = _f32(got[f"params/{path}"]), _f32(want[
            f"params/{path}"])
        err = float(np.max(np.abs(p_got - p_want)[mask]))
        assert err <= 1e-6 * float(np.max(np.abs(p_want))), (path, err)
    if scheme != "none":
        # the error holds the dropped (small) entries: its gap is held to
        # the leaf's gradient scale, max |mu| / (1 - b1)
        for path in _flat(params):
            g_max = float(np.max(np.abs(_f32(want[f"opt/mu/{path}"])))) / 0.1
            gap = float(np.max(np.abs(_f32(got[f"error/{path}"])
                                      - _f32(want[f"error/{path}"]))))
            assert gap <= 1e-4 * g_max, (path, gap, g_max)


@pytest.mark.parametrize("arch", [*ARCHS, *FRONTEND_ARCHS])
def test_train_step_decreases_loss_and_finite(arch):
    """tests/test_models_smoke.py's 4-step check, on the port."""
    cfg = get_config(arch, smoke=True)
    tcfg = TrainConfig(microbatches=2, remat=True, optimizer=AdamWConfig(
        lr=5e-3, total_steps=10, warmup_steps=1))
    state = init_state(cfg, tcfg, torch.Generator().manual_seed(0),
                       device="cpu")
    step = make_train_step(cfg, tcfg)
    toks = torch.from_numpy(np.random.default_rng(100).integers(
        0, cfg.vocab, (2, 16)))
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, dims=1)}
    if zoo.needs_frontend(cfg):
        batch["frontend"] = torch.from_numpy(frontend_np(cfg))
    losses = []
    for _ in range(4):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        assert set(m) == {"loss", "lr", "grad_norm"}
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    assert all(torch.isfinite(t).all() for t in tree_leaves(state))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt_state_np(smoke_params):
    """A whole train state with bf16 moments (non-zero), an fp32 error and
    step 7, as the reference holds it after ``jax.tree.map(np.asarray)``."""
    rng = np.random.default_rng(5)
    params = smoke_params["olmo-1b"]

    def draw(scale, dtype):
        return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale)
                            .astype(dtype), params)

    return {"params": params,
            "opt": {"mu": draw(0.01, ml_dtypes.bfloat16),
                    "nu": jax.tree.map(np.abs, draw(1e-3,
                                                    ml_dtypes.bfloat16)),
                    "step": np.asarray(7, np.int32)},
            "error": draw(0.01, np.float32)}


def _files(directory):
    with np.load(os.path.join(directory, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(directory, "manifest.json")) as f:
        return arrays, json.load(f)


def test_checkpoints_cross_restore(tmp_path, ckpt_state_np):
    extra = {"data_cursor": 7}
    JaxCheckpointManager(str(tmp_path / "jax")).save(
        7, _jnp(ckpt_state_np), extra=extra, block=True)
    CheckpointManager(str(tmp_path / "torch")).save(
        7, params_from_jax(ckpt_state_np), extra=extra, block=True)
    want = _flat(ckpt_state_np)

    # reference -> port: every leaf's dtype and bits
    state, got_extra, step = CheckpointManager(
        str(tmp_path / "jax")).restore(device="cpu")
    assert step == 7 and got_extra == extra
    got = _flat(params_to_numpy(state))
    assert set(got) == set(want)
    for path, a in want.items():
        assert got[path].dtype == a.dtype and got[path].shape == a.shape, path
        assert got[path].tobytes() == a.tobytes(), path
    assert _flat(state)["opt/mu/embed/table"].dtype == torch.bfloat16

    # port -> reference: the same files as the reference's own save, so its
    # restore returns what it returns for its own checkpoint
    (ja, jman), (ta, tman) = (_files(tmp_path / d / "step_00000007")
                              for d in ("jax", "torch"))
    assert tman["paths"] == jman["paths"] and tman["step"] == 7
    assert tman["extra"] == jman["extra"]
    assert jman["paths"]["opt/mu/embed/table"][1] == "bfloat16"
    for k, a in ja.items():
        assert ta[k].dtype == a.dtype and ta[k].tobytes() == a.tobytes(), k
    jstate, _, jstep = JaxCheckpointManager(str(tmp_path / "torch")).restore()
    assert jstep == 7
    for path, a in _flat(jstate).items():
        bits = a.view(ml_dtypes.bfloat16) if a.dtype.kind == "V" else a
        assert bits.dtype == want[path].dtype, path
        assert bits.tobytes() == want[path].tobytes(), path


def test_latest_keep_last_k_and_atomic_pointer(tmp_path):
    state = {"params": {"w": np.arange(6, dtype=np.float32)},
             "opt": {"step": np.asarray(0, np.int32)}}
    mgrs = {"jax": JaxCheckpointManager(str(tmp_path / "jax"), 2),
            "torch": CheckpointManager(str(tmp_path / "torch"), 2)}
    states = {"jax": _jnp(state), "torch": params_from_jax(state)}
    for name, m in mgrs.items():
        assert m.latest_step() is None and m.restore() is None
        for step in (1, 2, 5, 9):
            m.save(step, states[name])        # async: each save waits
        m.wait()
    listing = {n: sorted(os.listdir(tmp_path / n)) for n in mgrs}
    assert listing["torch"] == listing["jax"] == [
        "LATEST", "step_00000005", "step_00000009"]
    for n, m in mgrs.items():
        assert (tmp_path / n / "LATEST").read_text() == "step_00000009"
        assert m.latest_step() == 9
    # a LATEST that names a step whose files are gone: no restore point
    for n, m in mgrs.items():
        (tmp_path / n / "LATEST").write_text("step_00000003")
        assert m.latest_step() is None


class _Counter:
    """A pure-Python step function for run_with_recovery: the state is a
    list of the batches seen; it fails once at ``fail_at``."""

    def __init__(self, fail_at):
        self.fail_at, self.failed = fail_at, False

    def __call__(self, state, batch, step):
        if step == self.fail_at and not self.failed:
            self.failed = True
            raise RuntimeError("injected failure")
        return state + [int(batch["tokens"].sum())], {}


class _Manager:
    """In-memory stand-in for a checkpoint manager."""

    def __init__(self):
        self.saved = {}

    def save(self, step, state, extra=None, block=False):
        self.saved[step] = (list(state), dict(extra or {}))

    def wait(self):
        pass

    def restore(self):
        if not self.saved:
            return None
        step = max(self.saved)
        return list(self.saved[step][0]), self.saved[step][1], step


class _Prefetch:
    def __init__(self, source):
        self.source = source


@pytest.mark.parametrize("fail_at", [1, 3])
def test_run_with_recovery_matches_reference(fail_at):
    dcfg = dict(seq_len=8, global_batch=2, vocab=97)
    runs = {}
    for name, fn, src in (
            ("jax", jax_run_with_recovery,
             jax_make_source(JaxDataConfig(**dcfg))),
            ("torch", run_with_recovery, make_source(DataConfig(**dcfg)))):
        state, stats = fn(_Counter(fail_at), [], n_steps=5, save_every=2,
                          manager=_Manager(), data_prefetch=_Prefetch(src))
        runs[name] = (state, dataclasses.asdict(stats))
    assert runs["torch"] == runs["jax"]
    assert runs["torch"][1]["failures"] == 1


def test_recovery_ends_in_the_uninterrupted_state(tmp_path):
    cfg = get_config("olmo-1b", smoke=True)
    tcfg = TrainConfig(microbatches=2, optimizer=AdamWConfig(
        lr=5e-3, total_steps=10, warmup_steps=1))
    step_fn = make_train_step(cfg, tcfg)
    src = make_source(DataConfig(seq_len=8, global_batch=2, vocab=cfg.vocab))
    fails = {"left": 1}

    def wrapped(state, batch, step):
        if step == 3 and fails["left"]:
            fails["left"] -= 1
            raise RuntimeError("injected failure")
        return step_fn(state, {k: torch.from_numpy(v)
                               for k, v in batch.items()})

    finals = []
    for n in range(2):
        fails["left"] = n          # first run uninterrupted, then one failure
        state = init_state(cfg, tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
        state, stats = run_with_recovery(
            wrapped, state, n_steps=4, save_every=2, data_prefetch=_Prefetch(
                src), manager=CheckpointManager(str(tmp_path / str(n))))
        assert (stats.failures, stats.restores, stats.steps_replayed) == (
            (0, 0, 0) if n == 0 else (1, 1, 1))
        finals.append(_flat(state))
    for path, t in finals[0].items():
        assert torch.equal(finals[1][path], t), path



def test_restore_waits_for_the_save_in_flight(tmp_path, monkeypatch):
    """A save whose background write is slow is read back by a restore
    that starts before it lands: ``run_with_recovery`` restores right after
    a failure, and the step before it may have just saved (without the wait
    it found no LATEST and restarted from step 0)."""
    import repro_torch.train.checkpoint as ckpt
    savez = np.savez

    def slow_savez(*args, **kw):
        time.sleep(0.3)
        savez(*args, **kw)

    monkeypatch.setattr(ckpt.np, "savez", slow_savez)
    manager = CheckpointManager(str(tmp_path))
    manager.save(2, {"w": torch.arange(3.0)}, extra={"data_cursor": 2})
    restored, extra, step = manager.restore()
    assert step == 2 and extra == {"data_cursor": 2}
    assert torch.equal(restored["w"], torch.arange(3.0))


def test_restore_lands_on_the_manager_device(tmp_path):
    """``run_with_recovery`` restores without naming a device: the state
    must come back where the manager was told it lives, not on the CPU."""
    state = {"params": {"w": torch.arange(6, dtype=torch.float32),
                        "b": torch.ones(3, dtype=torch.bfloat16)},
             "opt": {"step": torch.tensor(4, dtype=torch.int32)}}
    CheckpointManager(str(tmp_path)).save(4, state, block=True)
    restored, _, step = CheckpointManager(str(tmp_path),
                                          device="meta").restore()
    assert step == 4
    for path, t in _flat(restored).items():
        assert t.device.type == "meta", path
        assert t.dtype == _flat(state)[path].dtype, path
    cpu = CheckpointManager(str(tmp_path), device="meta").restore(
        device="cpu")[0]
    for path, t in _flat(cpu).items():
        assert torch.equal(t, _flat(state)[path]), path


@pytest.mark.parametrize("builder", ["eval", "prefill", "serve",
                                     "abstract_state"])
def test_step_builders_match_reference(smoke_params, builder):
    arch = "olmo-1b"
    jcfg, cfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    params = smoke_params[arch]
    batch = _batch_np(cfg.vocab)
    tparams = params_from_jax(params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if builder == "abstract_state":
        comp = dict(scheme="topk", topk_ratio=0.1)
        for opt in (dict(), dict(moment_dtype="bfloat16")):
            got = _flat(abstract_state(cfg, TrainConfig(
                optimizer=AdamWConfig(**opt),
                compression=CompressionConfig(**comp))))
            want = _flat(jax_abstract_state(jcfg, JaxTrainConfig(
                optimizer=JaxAdamWConfig(**opt),
                compression=JaxCompressionConfig(**comp))))
            assert set(got) == set(want)
            for path, w in want.items():
                assert got[path].device.type == "meta", path
                assert tuple(got[path].shape) == w.shape, path
                assert str(got[path].dtype).removeprefix("torch.") == str(
                    w.dtype), path
        return
    if builder == "eval":
        tcfg = TrainConfig()
        jargs = ({"params": _jnp(params)}, _jnp(batch))
        want = _compiled(jax_make_eval_step(jcfg, JaxTrainConfig()),
                         *jargs)(*jargs)
        got = make_eval_step(cfg, tcfg)({"params": tparams}, tbatch)
        assert set(got) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(float(got[name]), float(w),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        return
    max_len = S + 2
    jargs = (_jnp(params), {"tokens": jnp.asarray(batch["tokens"])})
    jlogits, jcache = _compiled(jax_make_prefill_step(jcfg, max_len),
                                *jargs)(*jargs)
    logits, cache = make_prefill_step(cfg, max_len)(
        tparams, {"tokens": tbatch["tokens"].long()})
    if builder == "serve":
        token = np.random.default_rng(5).integers(0, cfg.vocab, (B,)).astype(
            np.int32)
        jargs = (_jnp(params), jcache, jnp.asarray(token), S)
        jlogits, jcache = jax.jit(jax_make_serve_step(jcfg),
                                  static_argnums=3)(*jargs)
        logits, cache = make_serve_step(cfg)(
            tparams, cache, torch.from_numpy(token).long(), S)
    assert int(cache["len"]) == int(jcache["len"])
    for got, want in ((logits, jlogits), (cache["k"], jcache["k"]),
                      (cache["v"], jcache["v"])):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)

# ---------------------------------------------------------------------------
# data, launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["synthetic", "mmap"])
def test_data_sources_match_reference(tmp_path, kind):
    path = None
    if kind == "mmap":
        path = str(tmp_path / "tokens.u16")
        np.random.default_rng(1).integers(0, 60000, 400).astype(
            np.uint16).tofile(path)
    kw = dict(seq_len=16, global_batch=4, vocab=300, seed=3, kind=kind,
              path=path, frontend_tokens=2 if kind == "synthetic" else 0,
              d_model=8)
    for host in range(2):
        ref = jax_make_source(JaxDataConfig(**kw), host, 2)
        port = make_source(DataConfig(**kw), host, 2)
        for step in (0, 1, 5):
            want, got = ref.batch_at(step), port.batch_at(step)
            assert set(got) == set(want)
            for k, a in want.items():
                assert got[k].dtype == a.dtype, k
                np.testing.assert_array_equal(got[k], a, err_msg=k)


def test_train_launcher_prints_reference_keys_and_serve_restores(
        tmp_path, capsys):
    ckpt = str(tmp_path / "ck")
    out = train_launcher.main(["--smoke", "--device", "cpu", "--steps", "2",
                               "--batch", "2", "--seq", "8", "--ckpt-dir",
                               ckpt, "--save-every", "1"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == out
    assert set(out) == {"steps", "mean_step_ms", "failures", "restores"}
    assert out["steps"] == 2 and out["failures"] == 0
    assert CheckpointManager(ckpt).latest_step() == 2
    served = serve_launcher.main(["--smoke", "--device", "cpu", "--ckpt-dir",
                                  ckpt, "--requests", "2", "--max-new", "2"])
    assert served["generated_tokens"] == 4
    assert "restored params from step 2" in capsys.readouterr().out


def test_train_launcher_needs_cuda_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_launcher.main(["--smoke", "--steps", "1", "--ckpt-dir",
                             str(tmp_path)])


# ---------------------------------------------------------------------------
# the kernels' autograd Functions (forward swapped for the plain version)
# ---------------------------------------------------------------------------

def _leaf(shape, gen, lo=None):
    t = torch.rand(shape, generator=gen) if lo is not None else \
        torch.randn(shape, generator=gen)
    if lo is not None:
        t = lo + (1.0 - lo) * t
    return t.requires_grad_(True)


def _grads(out, inputs, cot):
    pairs = [(o, c) for o, c in zip(out, cot) if c is not None]
    return torch.autograd.grad([o for o, _ in pairs], inputs,
                               [c for _, c in pairs], allow_unused=True,
                               materialize_grads=True)


@pytest.mark.parametrize("cot", ["both", "first", "second"])
def test_recurrence_functions_give_the_plain_gradients(cot):
    """``KernelFn`` as the recurrences' wrappers call it on CUDA, with a
    launch that records itself and runs the plain scan in its place."""
    gen = torch.Generator().manual_seed(0)
    launched = []

    def recorded(name, fn):
        def launch(*args, **kw):
            launched.append(name)
            return fn(*args, **kw)
        return launch

    a, x = _leaf((2, 9, 5), gen, lo=0.05), _leaf((2, 9, 5), gen)
    r, k, v = (_leaf((2, 3, 9, 4), gen) for _ in range(3))
    w = _leaf((2, 3, 9, 4), gen, lo=0.0)
    with torch.no_grad():
        w[..., 0] = 1e-9              # below the floor: zero gradient there
    u = _leaf((3, 4), gen)
    for name, plain, inputs, kw in (
            ("rglru", rglru_plain, (a, x), {}),
            ("wkv6", wkv6_plain, (r, k, v, w, u), {"floor": 1e-8})):
        outs = plain(*inputs, **kw)
        cots = [torch.randn(o.shape, generator=gen) for o in outs]
        if cot != "both":
            cots[1 if cot == "first" else 0] = None
        want = _grads(outs, inputs, cots)
        got = _grads(KernelFn.apply(recorded(name, plain), plain, kw,
                                    *inputs), inputs, cots)
        for g, h in zip(got, want):
            assert g is not None and torch.equal(g, h)
    assert launched == ["rglru", "wkv6"]
    # only the inputs that need a gradient get one
    u_only = KernelFn.apply(wkv6_plain, wkv6_plain, {"floor": 1e-8},
                            r.detach(), k.detach(), v.detach(), w.detach(), u)
    (g_u,) = torch.autograd.grad(u_only[0].sum(), [u])
    (want_u,) = torch.autograd.grad(wkv6_plain(
        r.detach(), k.detach(), v.detach(), w.detach(), u,
        floor=1e-8)[0].sum(), [u])
    assert torch.equal(g_u, want_u)


def test_flash_function_gives_the_dense_gradients():
    """``KernelFn`` as ``layers.attention`` calls it on CUDA: the flash
    wrapper forward (its plain version on the CPU), the dense math's
    gradient."""
    gen = torch.Generator().manual_seed(1)
    q, k, v = (_leaf((2, 7, n, 16), gen) for n in (4, 2, 2))
    g = torch.randn((2, 7, 4, 16), generator=gen)
    for window in (None, 3):
        want = torch.autograd.grad(layers._attention_dense(
            q, k, v, causal=True, window=window, q_offset=0, softcap=0.0),
            (q, k, v), g)
        out = KernelFn.apply(flash_attention, layers._attention_torch,
                             {"causal": True, "window": window}, q, k, v)
        got = torch.autograd.grad(out, (q, k, v), g)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
