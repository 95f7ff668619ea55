"""The port's kv-cache sharding policy (``serving/kvcache.py``) against
the reference's ``repro.serving.kvcache``.

* ``kv_cache_pspec`` equals ``tuple`` of the reference's ``PartitionSpec``
  and names the same strategy, for all ten architectures, smoke and
  full, at model degrees 1, 2, 4, 8 and 16, one and two lead dims, under
  ``default_plan`` and a plan whose kv rule is ("pod", "data", "model");
  the reference's ``TestKvCachePolicy`` cases are among them.
* ``cache_shardings`` of each full configuration's abstract cache (built
  on ``meta``) gives, leaf by leaf, the placements of the reference's
  ``NamedSharding`` specs on the reference's meshes: 16x16 over a fake
  process group of 256 ranks and 2x16x16 over 512 (torch's testing
  backend: no collective runs), under ``default_plan`` (batch over
  ("pod", "data") on the pods, as the reference's dry-run sets it) and a
  plan whose kv rule takes every axis with no batch axis (the
  reference's dry-run for a batch too small for the data axis), at the
  decode_32k shape and, for the sub-quadratic archs, long_500k (batch 1:
  every batch split falls back).  The reference's side comes from a JAX
  process with 512 forced host devices, as its dry-run forces them.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch.distributed as dist

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models.common import default_plan as jax_default_plan
from repro.serving.kvcache import kv_cache_pspec as jax_kv_cache_pspec
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import zoo
from repro_torch.models.common import default_plan
from repro_torch.serving import cache_shardings, kv_cache_pspec
from repro_torch.sharding import placements_for

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEGREES = (1, 2, 4, 8, 16)
WORLDS = {256: ((16, 16), ("data", "model")),
          512: ((2, 16, 16), ("pod", "data", "model"))}


def _plans(default, axes: tuple[str, ...]) -> dict:
    """The two plans of a mesh with ``axes``, built by ``default`` (either
    package's ``default_plan``)."""
    base = default()
    if "pod" in axes:
        base.batch_axes = ("pod", "data")
    every = default()
    every.batch_axes = ()
    every.rules["kv"] = axes
    return {"default": base, "kv-every-axis": every}


def _cells(arch: str) -> list[str]:
    cells = ["decode_32k"]
    if get_config(arch).is_subquadratic:
        cells.append("long_500k")
    return cells


REFERENCE = r'''
import json, sys
from repro.configs import ARCH_IDS, SHAPES, get_config
from repro.launch.mesh import make_mesh
from repro.models import zoo
from repro.models.common import default_plan
from repro.serving.kvcache import cache_shardings

WORLDS = json.loads(sys.argv[1])


def plans(axes):
    base = default_plan()
    if "pod" in axes:
        base.batch_axes = ("pod", "data")
    every = default_plan()
    every.batch_axes = ()
    every.rules["kv"] = tuple(axes)
    return {"default": base, "kv-every-axis": every}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, p) if isinstance(v, dict) else {p: v})
    return out


def entry(part):
    return list(part) if isinstance(part, tuple) else part


out = {}
for world, (shape, axes) in WORLDS.items():
    mesh = make_mesh(tuple(shape), tuple(axes))
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        cells = ["decode_32k"] + (["long_500k"] if cfg.is_subquadratic
                                  else [])
        for cell in cells:
            shape_spec = SHAPES[cell]
            cache = zoo.abstract_cache(
                cfg, shape_spec.global_batch,
                zoo.cache_max_len(cfg, shape_spec.seq_len))
            for name, plan in plans(axes).items():
                sh, strategy = cache_shardings(cfg, plan, mesh, cache,
                                               model_degree=16)
                out[f"{world}/{arch}/{cell}/{name}"] = {
                    "strategy": strategy,
                    "specs": {p: [entry(e) for e in tuple(s.spec)]
                              for p, s in flat(sh).items()}}
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def reference():
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE),
         json.dumps({str(k): v for k, v in WORLDS.items()})],
        env=env, capture_output=True, text=True, timeout=300,
        stdin=subprocess.DEVNULL)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.fixture(scope="module")
def fake_world():
    """A fake process group of 512 ranks, torn down after the module."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _spec(entries) -> tuple:
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_kv_cache_pspec_equals_reference(arch, smoke):
    cfg, jcfg = get_config(arch, smoke), jax_get_config(arch, smoke)
    pods = ("pod", "data", "model")
    ours, theirs = _plans(default_plan, pods), _plans(jax_default_plan, pods)
    for name in ours:
        for degree in DEGREES:
            for lead in (1, 2):
                spec, strategy = kv_cache_pspec(cfg, ours[name],
                                                model_degree=degree,
                                                lead_dims=lead)
                ref, ref_strategy = jax_kv_cache_pspec(
                    jcfg, theirs[name], model_degree=degree, lead_dims=lead)
                assert (spec, strategy) == (tuple(ref), ref_strategy), (
                    name, degree, lead)
                assert len(spec) == lead + 4


class TestKvCachePolicy:
    """The reference's cases (``tests/test_autotune_sharding.py``)."""

    def test_head_sharded_when_divisible(self):
        cfg = get_config("codeqwen1.5-7b")     # kv=32
        _, strategy = kv_cache_pspec(cfg, default_plan(), model_degree=16)
        assert strategy == "head-sharded"

    def test_sequence_sharded_when_not(self):
        cfg = get_config("granite-3-8b")       # kv=8 < 16
        _, strategy = kv_cache_pspec(cfg, default_plan(), model_degree=16)
        assert "sequence-sharded" in strategy

    def test_replicated_at_degree_1(self):
        cfg = get_config("olmo-1b")
        _, strategy = kv_cache_pspec(cfg, default_plan(), model_degree=1)
        assert strategy == "replicated-heads"


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_shardings_equal_reference(reference, fake_world, arch, world):
    shape, axes = WORLDS[world]
    mesh = make_mesh(shape, axes, device_type="cpu")
    cfg = get_config(arch)
    for cell in _cells(arch):
        spec = SHAPES[cell]
        cache = zoo.abstract_cache(cfg, spec.global_batch,
                                   zoo.cache_max_len(cfg, spec.seq_len))
        for name, plan in _plans(default_plan, axes).items():
            ref = reference[f"{world}/{arch}/{cell}/{name}"]
            sh, strategy = cache_shardings(cfg, plan, mesh, cache,
                                           model_degree=16)
            assert strategy == ref["strategy"], (cell, name)
            flat = _flat(sh)
            assert sorted(flat) == sorted(ref["specs"]), (cell, name)
            for path, ns in flat.items():
                want = placements_for(_spec(ref["specs"][path]), mesh)
                assert ns.mesh is mesh
                assert ns.placements == want, (cell, name, path,
                                               ref["specs"][path])


def test_whisper_cross_kv_falls_back_to_the_batch(fake_world):
    """whisper-small's 1500-frame cross k/v does not split 16 ways: the
    sequence-sharded policy falls back to the batch for those leaves."""
    cfg = get_config("whisper-small")
    mesh = make_mesh((16, 16), ("data", "model"), device_type="cpu")
    sh, strategy = cache_shardings(
        cfg, default_plan(), mesh, zoo.abstract_cache(cfg, 128, 448),
        model_degree=16)
    assert "sequence-sharded" in strategy      # 12 kv heads on 16
    from torch.distributed.tensor import Replicate, Shard
    assert sh["k"].placements == (Shard(2), Shard(1))      # 448 splits
    assert sh["xk"].placements == (Shard(2), Replicate())  # 1500 does not
    assert sh["len"].placements == (Replicate(), Replicate())
