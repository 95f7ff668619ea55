"""Port <-> reference: parameter bridge, configs, parameter shapes."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import zoo as jax_zoo
from repro.models.common import cast_tree
from repro_torch import resolve_device
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_config
from repro_torch.models import zoo
from repro_torch.models.common import cast_matrices, tree_leaves

ARCHS = ["olmo-1b", "granite-3-8b", "codeqwen1.5-7b", "recurrentgemma-2b",
         "rwkv6-1.6b", "mixtral-8x7b", "llama4-scout-17b-a16e", "llama3-405b",
         "llama-3.2-vision-11b", "whisper-small"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.fixture(scope="module")
def olmo_smoke_np():
    cfg = jax_get_config("olmo-1b", smoke=True)
    params = jax_zoo.init(cfg, jax.random.PRNGKey(0))
    return {"float32": jax.tree.map(np.asarray, params),
            "bfloat16": jax.tree.map(np.asarray,
                                     cast_tree(params, jnp.bfloat16))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_is_exact(olmo_smoke_np, dtype):
    ref = olmo_smoke_np[dtype]
    tparams = params_from_jax(ref, device="cpu")
    assert set(_flat(tparams)) == set(_flat(ref))
    for path, t in _flat(tparams).items():
        assert t.dtype == getattr(torch, dtype), path
        assert tuple(t.shape) == _flat(ref)[path].shape, path
    back = _flat(params_to_numpy(tparams))
    for path, a in _flat(ref).items():
        assert back[path].dtype == a.dtype, path
        # bit-for-bit: compare the raw bytes, bf16 included
        assert back[path].tobytes() == a.tobytes(), path


def test_bf16_bits_survive(olmo_smoke_np):
    table = olmo_smoke_np["bfloat16"]["embed"]["table"]
    assert table.dtype == ml_dtypes.bfloat16
    t = params_from_jax({"t": table})["t"]
    np.testing.assert_array_equal(t.float().numpy(), table.astype(np.float32))


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch, smoke):
    mine, ref = get_config(arch, smoke), jax_get_config(arch, smoke)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert (mine.hd, mine.padded_vocab) == (ref.hd, ref.padded_vocab)
    assert mine.activation_dtype == getattr(torch, ref.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_shapes_equal_reference(arch):
    cfg = get_config(arch)
    mine = _flat(zoo.init(cfg, device="meta"))
    ref = _flat(jax_zoo.abstract(jax_get_config(arch)))
    assert set(mine) == set(ref)
    for path, t in mine.items():
        assert t.device.type == "meta", path
        assert tuple(t.shape) == ref[path].shape, path
        assert str(t.dtype).removeprefix("torch.") == str(ref[path].dtype)
    assert cfg.param_count() == jax_get_config(arch).param_count()


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_active_param_count_equals_reference(arch, smoke):
    mine, ref = get_config(arch, smoke), jax_get_config(arch, smoke)
    assert mine.active_param_count() == ref.active_param_count()
    if mine.moe_experts:
        # only the unrouted experts' gate/up/down fall out
        per_expert = 3 * mine.d_model * mine.d_ff
        assert mine.param_count() - mine.active_param_count() == (
            (mine.moe_experts - mine.moe_top_k) * per_expert * mine.n_layers)
    else:
        assert mine.active_param_count() == mine.param_count()


def test_init_laws_on_cpu():
    cfg = get_config("olmo-1b", smoke=True)
    gen = torch.Generator("cpu").manual_seed(0)
    p = zoo.init(cfg, gen, device="cpu")
    assert torch.count_nonzero(p["layers"]["attn_norm"]) == 0
    table = p["embed"]["table"]
    assert abs(table.std().item() - 0.02) < 0.002
    wq = p["layers"]["wq"]           # fan_in = d_model
    assert abs(wq.std().item() - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    same = zoo.init(cfg, torch.Generator("cpu").manual_seed(0), device="cpu")
    assert torch.equal(same["layers"]["w_up"], p["layers"]["w_up"])


def test_cast_matrices_keeps_norms():
    cfg = get_config("granite-3-8b", smoke=True)
    p = zoo.init(cfg, torch.Generator("cpu").manual_seed(1), device="cpu")
    cast = cast_matrices(p, torch.bfloat16)
    c = _flat(cast)
    assert c["layers/attn_norm"].dtype == torch.float32
    assert c["final_norm"].dtype == torch.float32
    assert c["layers/wq"].dtype == torch.bfloat16
    # only the norm scales keep their 4 bytes an element
    n_norm = sum(t.numel() for k, t in c.items() if k.endswith("norm"))
    assert sum(t.numel() * t.element_size() for t in tree_leaves(cast)) == \
        2 * sum(t.numel() for t in tree_leaves(p)) + 2 * n_norm


RWKV6_FLOAT32 = ("w0", "w_lora_b", "u", "ln_x")


def test_cast_matrices_keeps_rwkv6_decay_leaves_float32():
    """rwkv6 reads ``w0``, ``w_lora_b``, ``u`` and ``ln_x`` in float32:
    a tree cast once to bf16 keeps them so, and its bf16 logits equal
    those of the uncast tree when those leaves (and the other zero-init
    ones) hold non-trivial values."""
    cfg = dataclasses.replace(get_config("rwkv6-1.6b", smoke=True),
                              dtype="bfloat16")
    gen = torch.Generator("cpu").manual_seed(2)
    p = zoo.init(cfg, gen, device="cpu")
    layers = p["layers"]
    layers["w0"] = torch.empty_like(layers["w0"]).uniform_(
        -8.0, 3.5, generator=gen)
    for name, std in (("w_lora_b", 0.1), ("tm_lora_b", 0.02), ("u", 0.5)):
        layers[name] = torch.randn(layers[name].shape, generator=gen) * std
    for name in ("tm_mu", "cm_mu"):
        layers[name] = torch.rand(layers[name].shape, generator=gen)
    layers["ln_x"] = 1.0 + 0.1 * torch.randn(layers["ln_x"].shape,
                                             generator=gen)
    cast = cast_matrices(p, torch.bfloat16)
    for path, t in _flat(cast).items():
        name = path.split("/")[-1]
        keep = name in RWKV6_FLOAT32 or name.endswith("norm")
        assert t.dtype == (torch.float32 if keep else torch.bfloat16), path
    # w0 + lora spans the decay clip, so a rounded w0 would show
    assert not torch.equal(layers["w0"].to(torch.bfloat16).float(),
                           layers["w0"])
    tokens = torch.randint(0, cfg.vocab, (2, 9), generator=gen)
    logits, _ = zoo.forward(cfg, p, {"tokens": tokens})
    logits_cast, _ = zoo.forward(cfg, cast, {"tokens": tokens})
    assert logits.dtype == torch.bfloat16
    assert torch.equal(logits, logits_cast)


def test_cast_matrices_keeps_moe_router_float32():
    """The MoE router is read in float32 (logits and softmax): a tree cast
    once to bf16 keeps it so, and routes as the uncast tree does."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b", smoke=True),
                              dtype="bfloat16")
    gen = torch.Generator("cpu").manual_seed(3)
    p = zoo.init(cfg, gen, device="cpu")
    cast = cast_matrices(p, torch.bfloat16)
    for path, t in _flat(cast).items():
        keep = path == "layers/router" or path.endswith("norm")
        assert t.dtype == (torch.float32 if keep else torch.bfloat16), path
    router = p["layers"]["router"]
    assert not torch.equal(router.to(torch.bfloat16).float(), router)
    tokens = torch.randint(0, cfg.vocab, (2, 12), generator=gen)
    logits, aux = zoo.forward(cfg, p, {"tokens": tokens})
    logits_cast, aux_cast = zoo.forward(cfg, cast, {"tokens": tokens})
    assert logits.dtype == torch.bfloat16
    assert torch.equal(logits, logits_cast) and torch.equal(aux, aux_cast)


def test_cast_matrices_keeps_vlm_gates_float32():
    """The vlm's cross gates are read in float32 (``tanh(gate)``): a tree
    cast once to bf16 keeps them so, and gives the uncast tree's logits
    with the gates drawn from U(-1, 1) and a random frontend."""
    cfg = dataclasses.replace(get_config("llama-3.2-vision-11b", smoke=True),
                              dtype="bfloat16")
    gen = torch.Generator("cpu").manual_seed(4)
    p = zoo.init(cfg, gen, device="cpu")
    cross = p["supers"]["cross"]
    for name in ("gate_attn", "gate_mlp"):
        cross[name] = torch.empty_like(cross[name]).uniform_(
            -1.0, 1.0, generator=gen)
    cast = cast_matrices(p, torch.bfloat16)
    gates = ("supers/cross/gate_attn", "supers/cross/gate_mlp")
    for path, t in _flat(cast).items():
        keep = path in gates or path.endswith("norm")
        assert t.dtype == (torch.float32 if keep else torch.bfloat16), path
    gate = cross["gate_attn"]
    assert not torch.equal(gate.to(torch.bfloat16).float(), gate)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 9), generator=gen),
             "frontend": 0.02 * torch.randn(
                 (2, cfg.n_frontend_tokens, cfg.d_model), generator=gen)}
    logits, _ = zoo.forward(cfg, p, batch)
    logits_cast, _ = zoo.forward(cfg, cast, batch)
    assert logits.dtype == torch.bfloat16
    assert torch.equal(logits, logits_cast)


def test_every_reference_arch_is_served():
    """All ten of the reference's architectures, in its order, and its six
    model families."""
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    from repro.models.zoo import FAMILY_MODULES as JAX_FAMILIES
    from repro_torch.configs import ARCH_IDS
    assert ARCH_IDS == JAX_ARCH_IDS
    assert set(zoo.FAMILY_MODULES) == set(JAX_FAMILIES)
    for arch in ARCH_IDS:
        assert zoo.module_for(get_config(arch)) is not None


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the refusal path cannot be exercised")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        zoo.init(get_config("olmo-1b", smoke=True))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        zoo.init(get_config("whisper-small", smoke=True))
