"""Port's ServeEngine against ``repro.serving.ServeEngine`` on the olmo-1b
smoke config with bridged params: two waves with left-padding, exact
re-prefill of shorter prompts and a zero-token request; the same on the
llama-3.2-vision and whisper-small smoke configs, both engines feeding one
seeded random frontend through ``_batch_for`` (the vlm's cross gates
drawn), and the zero frontend of the engines' own ``_batch_for``.
``wave_op_graph`` against the reference's, op for op, for all ten
configs.

Greedy outputs must agree token for token.  A disagreement is allowed
only where the reference itself was at a near tie (top-2 logit margin
under 1e-4 in some prefill or decode step), and the test reports it.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

import repro.models.zoo as jax_zoo_module
from repro.configs import get_config as jax_get_config
from repro.models import zoo as jax_zoo
from repro.serving import Request as JaxRequest
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving import wave_op_graph as jax_wave_op_graph
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import serve as serve_launcher
from repro_torch.configs import ARCH_IDS
from repro_torch.serving import Request, ServeEngine, wave_op_graph
from test_torch_vlm import draw_gates

N_SLOTS, MAX_LEN, TIE = 3, 64, 1e-4
# (prompt length, max_new_tokens): wave 1 has one shorter prompt; wave 2
# has two shorter lengths and a zero-token request
WORKLOAD = [(12, 5), (7, 5), (12, 5), (9, 4), (9, 0), (5, 4)]
# wave prefills + one exact re-prefill per distinct shorter length that
# asks for tokens: wave 1 -> 1 + {7}, wave 2 -> 1 + {5}
EXPECTED_PREFILLS = 4


def _top2_margin(logits) -> float:
    top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[..., -2:]
    return float(np.min(top2[..., 1] - top2[..., 0]))


def _serve_both(arch: str, params: dict, frontend: np.ndarray | None = None
                ) -> dict:
    """The WORKLOAD through the reference's engine and the port's on the
    smoke config of ``arch`` with the numpy ``params``; with ``frontend``
    (n_frontend_tokens, d_model) both engines feed it to every row of every
    prefill in place of the engine's zeros."""
    jcfg = jax_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n, _ in WORKLOAD]

    margins = []
    ref_cls, port_cls = JaxServeEngine, ServeEngine
    if frontend is not None:
        ref_cls, port_cls = _with_frontend(frontend)
    ref_eng = ref_cls(jcfg, jax.tree.map(jax.numpy.asarray, params),
                      n_slots=N_SLOTS, max_len=MAX_LEN)
    decode = ref_eng._decode

    def recording_decode(*args):
        logits, cache = decode(*args)
        margins.append(_top2_margin(logits))
        return logits, cache

    ref_eng._decode = recording_decode
    prefill = jax_zoo.prefill

    def recording_prefill(*args, **kw):
        logits, cache = prefill(*args, **kw)
        margins.append(_top2_margin(logits))
        return logits, cache

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_zoo_module, "prefill", recording_prefill)
        for i, (p, (_, mx)) in enumerate(zip(prompts, WORKLOAD)):
            ref_eng.submit(JaxRequest(rid=i, prompt=p, max_new_tokens=mx))
        ref_done = ref_eng.run()

    eng = port_cls(cfg, params_from_jax(params), n_slots=N_SLOTS,
                   max_len=MAX_LEN)
    launches = flash_attention.launches
    for i, (p, (_, mx)) in enumerate(zip(prompts, WORKLOAD)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=mx))
    done = eng.run()
    return {"ref": ref_done, "port": done, "ref_eng": ref_eng, "eng": eng,
            "min_margin": min(margins),
            "launches": flash_attention.launches - launches}


def _with_frontend(frontend: np.ndarray):
    """Subclasses of both engines whose ``_batch_for`` gives every row
    ``frontend`` instead of zeros."""
    import jax.numpy as jnp

    class Ref(JaxServeEngine):
        def _batch_for(self, prompts):
            batch = super()._batch_for(prompts)
            batch["frontend"] = jnp.broadcast_to(
                jnp.asarray(frontend), batch["frontend"].shape)
            return batch

    class Port(ServeEngine):
        def _batch_for(self, prompts):
            batch = super()._batch_for(prompts)
            batch["frontend"] = torch.from_numpy(frontend).expand(
                batch["frontend"].shape)
            return batch

    return Ref, Port


@pytest.fixture(scope="module")
def served():
    jcfg = jax_get_config("olmo-1b", smoke=True)
    params = jax.tree.map(np.asarray, jax_zoo.init(jcfg, jax.random.PRNGKey(0)))
    return _serve_both("olmo-1b", params)


def test_outputs_token_for_token(served):
    _same_tokens(served)


def _same_tokens(served: dict) -> None:
    ref = {r.rid: r.output for r in served["ref"]}
    mine = {r.rid: r.output for r in served["port"]}
    assert set(mine) == set(ref)
    for rid, (_, max_new) in enumerate(WORKLOAD):
        assert len(mine[rid]) == max_new
    diff = [rid for rid in ref if ref[rid] != mine[rid]]
    if diff:
        # allowed only at a near tie of the reference's own logits
        assert served["min_margin"] < TIE, (diff, served["min_margin"])
        warnings.warn(f"requests {diff} differ at a reference near tie "
                      f"(top-2 margin {served['min_margin']:.2e} < {TIE})")


def test_wave_stats_match_except_wall_time(served):
    ref_stats = served["ref_eng"].stats
    stats = served["eng"].stats
    assert len(stats) == len(ref_stats) == 2
    for mine, ref in zip(stats, ref_stats):
        for f in ("n_requests", "prompt_len", "decode_steps",
                  "slot_token_capacity", "useful_tokens"):
            assert getattr(mine, f) == getattr(ref, f), f
    assert served["eng"].mean_slot_utilization == pytest.approx(
        served["ref_eng"].mean_slot_utilization)


def test_prefill_calls_and_no_cpu_launches(served):
    assert served["eng"].prefill_calls == EXPECTED_PREFILLS
    assert served["launches"] == 0          # the CPU path never launches
    assert served["eng"].prefill_s > 0 and served["eng"].decode_s > 0


def test_zero_token_request_gets_nothing(served):
    zero = [r for r in served["port"] if r.max_new_tokens == 0]
    assert len(zero) == 1 and zero[0].output == [] and zero[0].done


def test_launcher_reports_the_reference_keys(capsys):
    out = serve_launcher.main(["--smoke", "--device", "cpu", "--requests",
                               "3", "--max-new", "3", "--slots", "2"])
    # the keys of repro.launch.serve's JSON report
    assert set(out) == {"arch", "requests", "generated_tokens",
                        "tokens_per_s", "mean_slot_utilization", "waves"}
    assert out["requests"] == 3 and out["generated_tokens"] == 9
    assert out["waves"] == 2
    assert '"generated_tokens": 9' in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the vlm and audio families: a frontend in every prefill's batch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["llama-3.2-vision-11b",
                                        "whisper-small"])
def served_frontend(request):
    arch = request.param
    cfg = get_config(arch, smoke=True)
    params = jax.tree.map(np.asarray, jax_zoo.init(
        jax_get_config(arch, smoke=True), jax.random.PRNGKey(0)))
    if arch == "llama-3.2-vision-11b":
        params = draw_gates(params)
    frontend = (np.random.default_rng(7).standard_normal(
        (cfg.n_frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    return _serve_both(arch, params, frontend)


def test_frontend_families_serve_token_for_token(served_frontend):
    """vlm and audio: the same tokens as the reference's engine, with the
    exact re-prefills of the shorter prompts (each given the wave's
    frontend)."""
    _same_tokens(served_frontend)
    assert served_frontend["eng"].prefill_calls == EXPECTED_PREFILLS
    assert served_frontend["launches"] == 0
    for mine, ref in zip(served_frontend["eng"].stats,
                         served_frontend["ref_eng"].stats):
        assert (mine.prompt_len, mine.decode_steps, mine.useful_tokens) == (
            ref.prompt_len, ref.decode_steps, ref.useful_tokens)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-small",
                                  "olmo-1b"])
def test_batch_for_gives_the_reference_zero_frontend(arch):
    cfg, jcfg = get_config(arch, smoke=True), jax_get_config(arch,
                                                              smoke=True)
    prompts = np.zeros((3, 5), np.int32)
    mine = ServeEngine(cfg, {"embed": {"table": torch.zeros(1)}}, n_slots=3,
                       max_len=8)._batch_for(prompts)
    ref = JaxServeEngine(jcfg, {}, n_slots=3, max_len=8)._batch_for(prompts)
    assert set(mine) == set(ref)
    assert mine["tokens"].tolist() == np.asarray(ref["tokens"]).tolist()
    if "frontend" in ref:
        assert tuple(mine["frontend"].shape) == ref["frontend"].shape
        assert mine["frontend"].dtype == cfg.activation_dtype
        assert not mine["frontend"].any()


# ---------------------------------------------------------------------------
# wave_op_graph
# ---------------------------------------------------------------------------

# (prompt length, max_new_tokens): 3 requests on 4 slots, a partial wave
GRAPH_WAVE = [(37, 9), (12, 0), (64, 5)]
OP_FIELDS = ("uid", "name", "op_class", "input_shape", "flops",
             "bytes_moved", "working_set", "parallel_fraction", "deps",
             "tunable")


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_wave_op_graph_equals_reference(arch, smoke):
    cfg, jcfg = get_config(arch, smoke), jax_get_config(arch, smoke)
    wave = [Request(rid=i, prompt=np.zeros(n, np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(GRAPH_WAVE)]
    ref_wave = [JaxRequest(rid=r.rid, prompt=r.prompt,
                           max_new_tokens=r.max_new_tokens) for r in wave]
    for kw in ({"n_slots": 4, "name": f"{arch}-wave0"}, {}):
        mine, ref = wave_op_graph(cfg, wave, **kw), jax_wave_op_graph(
            jcfg, ref_wave, **kw)
        assert mine.name == ref.name
        assert list(mine.ops) == list(ref.ops)
        for uid, op in ref.ops.items():
            for f in OP_FIELDS:
                assert getattr(mine.ops[uid], f) == getattr(op, f), (uid, f)
        assert mine.fingerprint() == ref.fingerprint()
        assert mine.topo_order() == ref.topo_order()


def test_wave_op_graph_refuses_an_empty_wave():
    cfg = get_config("olmo-1b", smoke=True)
    with pytest.raises(ValueError, match="empty wave"):
        wave_op_graph(cfg, [])
    with pytest.raises(ValueError, match="empty wave"):
        jax_wave_op_graph(jax_get_config("olmo-1b", smoke=True), [])
