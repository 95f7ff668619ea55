"""The work a rank of the port's sharded step repeats, against the work a
device of the reference's repeats (ROADMAP Faults item 14), on the CPU.

Each case is a tiny analogue of a pattern that the 16x16 mesh dry-run
found repeated: smoke configs in fp32, B=8, S=96, one microbatch, on a
(2, 4) ("data", "model") mesh.  The reference's side is constants: the
per-device shape of each dot of its partitioned HLO, beside the same
dot on one device (``reference_dots.py``, which compiles the cell with
``repro.launch.dryrun.lower_cell``).  A product's repeat is 8 x its
flops on a device over its flops on one device.  The port's side is
counted live by ``launch.dryrun.count_step`` over a fake process group
of 8 ranks (this process is rank 0):

* attention whose q heads the model axis does not divide (6 on 4, as
  whisper-small's 12, recurrentgemma-2b's 10 and llama4-scout's 40 on
  16): the reference splits the heads by gcd(6, 4) = 2 and repeats each
  group on 2 ranks; the port's attention a rank costs at most the
  reference's, and its repeat is the reference's;
* every product left in ``CostCounter.replicated`` is one that the
  reference repeats as often: mixtral's dispatch and combine with E=2
  on 4, rwkv6's ``tm_lora_a``, ``tm_lora_b`` (forward and both
  gradients), ``w_lora_a`` and ``cm_wr``.  rwkv6's ``w_lora_b`` (which
  the reference splits by the heads it feeds) and the vlm decode's rows
  after its cross layer (which it splits by the batch) are no longer
  repeated;
* one live compile of the 6-head analogue keeps the constants honest.
"""

import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 8
MESH = (2, 4)
SEQ, BATCH = 96, 8

# one reference product: (einsum, result on one device, result on a
# device of (2, 4), contracted extent on one device, on a device)
SCORES = "bqhd,bkhd->bhqk"


def _attention(b, h, q, k, hd):
    """The reference's score dot of an attention of ``h`` heads, split
    over (2, 4) by the batch and gcd(h, 4) head groups."""
    g = math.gcd(h, 4)
    return (SCORES, (b, h, q, k), (b // 2, h // g, q, k), hd, hd)


# case -> (arch, shape, config fields, {port's replicated (op, shapes):
# the reference's product}); the reference's shapes are from
# ``reference_dots.py --arch ARCH --set FIELD=N`` (train_4k, or
# decode_32k, at S=96, B=8)
CASES = {
    "olmo-1b-6-heads": ("olmo-1b", "train_4k",
                        {"n_heads": 6, "n_kv_heads": 6}, {
        ("attention", ((8, 96, 6, 16), (8, 96, 6, 16))):
            _attention(8, 6, 96, 96, 16)}),
    "recurrentgemma-2b-6-heads-mqa": ("recurrentgemma-2b", "train_4k",
                                      {"n_heads": 6, "n_kv_heads": 1}, {
        ("attention", ((8, 96, 6, 32), (8, 96, 1, 32))):
            _attention(8, 6, 96, 96, 32)}),
    "whisper-small-6-heads": ("whisper-small", "train_4k",
                              {"n_heads": 6, "n_kv_heads": 6}, {
        ("attention", ((8, 96, 6, 16), (8, 96, 6, 16))):
            _attention(8, 6, 96, 96, 16),
        ("attention", ((8, 12, 6, 16), (8, 12, 6, 16))):
            _attention(8, 6, 12, 12, 16),
        ("attention", ((8, 96, 6, 16), (8, 12, 6, 16))):
            _attention(8, 6, 96, 12, 16)}),
    "mixtral-8x7b-2-experts": ("mixtral-8x7b", "train_4k",
                               {"moe_experts": 2}, {
        ("einsum bsec,bsd->ebcd", ((8, 96, 2, 96), (8, 96, 64))):
            ("bsec,bsd->ebcd", (8, 64, 192), (4, 64, 192), 96, 96),
        ("einsum bsec,ebcd->bsd", ((8, 96, 2, 96), (2, 8, 96, 64))):
            ("bsec,ebcd->bsd", (8, 96, 64), (4, 96, 64), 192, 192)}),
    "rwkv6-1.6b": ("rwkv6-1.6b", "train_4k", {}, {
        # tm_lora_a, w_lora_a, cm_wr: forward
        ("aten.mm", ((768, 64), (64, 160))):
            ("bsd,dr->bsr", (768, 160), (384, 160), 64, 64),
        ("aten.mm", ((768, 64), (64, 32))):
            ("bsd,dr->bsr", (768, 32), (384, 32), 64, 64),
        ("aten.mm", ((768, 64), (64, 64))):
            ("bsd,de->bse", (768, 64), (384, 64), 64, 64),
        # tm_lora_b: forward, the input's and the weight's gradients
        ("aten.bmm", ((5, 768, 32), (5, 32, 64))):
            ("bskr,krd->bskd", (5, 64, 768), (5, 64, 384), 32, 32),
        ("aten.bmm", ((5, 768, 64), (5, 64, 32))):
            ("bskr,krd->bskd", (5, 768, 32), (5, 384, 32), 64, 64),
        ("aten.bmm", ((5, 32, 768), (5, 768, 64))):
            ("bskr,krd->bskd", (5, 32, 64), (5, 64, 32), 768, 384)}),
    "llama-3.2-vision-11b-decode": ("llama-3.2-vision-11b", "decode_32k",
                                    {}, {}),
}
# products the reference splits over all 8 devices and the port repeated
# before it split them too: case -> the reference's product
SPLIT_BY_REFERENCE = {
    "rwkv6-1.6b": ("bsr,rd->bsd", (768, 64), (384, 16), 32, 32),
    "llama-3.2-vision-11b-decode": ("bsh,hd->bsd", (8, 64), (4, 64), 64, 16),
}


def _flops(result, k) -> int:
    return 2 * math.prod(result) * k


def _repeat(product) -> float:
    """How many devices of the 8 compute each of the product's flops."""
    _, one, dev, k_one, k_dev = product
    return WORLD * _flops(dev, k_dev) / _flops(one, k_one)


@pytest.fixture(scope="module")
def world():
    """A fake process group of 8 ranks, torn down after the module."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def live_reference():
    """``reference_dots.py`` on the 6-head analogue, started at the
    module's first test and read by its last."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "reference_dots.py"), "--arch",
         "olmo-1b", "--set", "n_heads=6", "--set", "n_kv_heads=6",
         "--only", "bhqk"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, stdin=subprocess.DEVNULL)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _count(case: str):
    from torch.distributed.device_mesh import DeviceMesh
    arch, shape_name, fields, _ = CASES[case]
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype="float32", **fields)
    shape = SHAPES[shape_name].scaled(seq=SEQ, batch=BATCH)
    mesh = DeviceMesh("cuda", torch.arange(WORLD).reshape(MESH),
                      mesh_dim_names=("data", "model"))
    plan = dryrun.plan_for_shape(cfg, shape, mesh)
    scfg = dataclasses.replace(cfg, batch_axes=tuple(plan.batch_axes),
                               seq_axes=tuple(plan.seq_axes))
    tcfg = dryrun.TrainConfig(microbatches=1, remat=False)
    return dryrun.count_step(scfg, shape, mesh, plan=plan, tcfg=tcfg)[0]


@pytest.mark.parametrize("case", list(CASES))
def test_repeats_are_the_references(world, live_reference, case):
    """Every product a rank runs beyond its 1/8 share is one the
    reference's device repeats too, as many times; an attention a rank
    runs costs at most the reference's attention a device (its score
    and PV dots, 4 b h q k d flops)."""
    expected = CASES[case][3]
    counter = _count(case)
    seen = set()
    for op, shapes, local, share in counter.replicated:
        key = (op, tuple(tuple(s) for s in shapes))
        assert key in expected, (case, key, "repeated by the port only")
        product = expected[key]
        assert local / share == pytest.approx(_repeat(product),
                                              rel=1e-12), (case, key)
        if op == "attention":
            _, _, dev, hd, _ = product
            assert local <= 4 * math.prod(dev) * hd, (case, key, local)
        seen.add(key)
    assert seen == set(expected), (case, set(expected) - seen)


@pytest.mark.parametrize("case", sorted(SPLIT_BY_REFERENCE))
def test_products_the_reference_splits_are_split(world, case):
    """rwkv6's ``w_lora_b`` and the vlm decode's rows behind its cross
    attention: the reference splits them over all 8 devices, and the
    port no longer names them repeated."""
    product = SPLIT_BY_REFERENCE[case]
    assert _repeat(product) == 1.0
    counter = _count(case)
    keys = {(op, tuple(tuple(s) for s in shapes))
            for op, shapes, _, _ in counter.replicated}
    assert keys == set(CASES[case][3]), (case, keys)


def test_live_compile_keeps_the_constants(live_reference):
    """The reference's 6-head attention, compiled now: its score and PV
    dots on one device and on a device of (2, 4) are the constants'."""
    out, err = live_reference.communicate(timeout=300)
    assert live_reference.returncode == 0, err[-3000:]
    rec = json.loads(out.splitlines()[-1])
    _, one, dev, hd, _ = CASES["olmo-1b-6-heads"][3][
        ("attention", ((8, 96, 6, 16), (8, 96, 6, 16)))]
    for mesh, scores in (("1x1", one), ("2x4", dev)):
        got = {(d["einsum"], tuple(d["result"])) for d in rec[mesh]["dots"]}
        assert (SCORES, scores) in got, (mesh, sorted(got))
        pv = (*scores[:2], hd, scores[2])       # XLA's (b, h, d, q)
        assert ("bhqk,bkhd->bqhd", pv) in got, (mesh, sorted(got))
