"""The port's sharding on 4 gloo ranks on the CPU, against the reference.

One module-scoped fixture starts 4 ranks once (``WORKER`` below, each a
process of its own with a gloo process group), beside them one JAX
process with 4 forced host devices for the reference's index maps, and
computes the reference's single-device train steps in this process.
Every test reads its part of the one report, so each case counts:

(a) ``ring_ag_matmul`` on (1, 4) and (2, 2) meshes against
    ``reference_ag_matmul`` (atol 1e-4, the reference's bound);
(b) each rank's local slice of every olmo-1b smoke parameter under
    ``default_plan`` on (2, 2) equals the slice that the reference's
    ``NamedSharding.devices_indices_map`` gives the device at the same mesh
    coordinate;
(c) the sharded train step of olmo-1b smoke on (2, 2), ``default_plan``,
    2 microbatches, batch over "data", against the port's unsharded step
    and the reference's single-device step from the same bridged params:
    fp32 loss within 1e-5 and every updated parameter within 1e-5 of its
    largest |value|; bf16 activations with the loss at the reference's
    own sharded-against-single bound, 5e-3; fp32 with sequence
    parallelism over "model".  The parameters and AdamW's moments keep
    their placements after the step.  AdamW's ``eps`` is 1e-3 here: on a
    first step Adam moves a weight by about lr * g / (|g| + eps), which
    for eps far below |g| is lr * sign(g), and a gradient near zero that
    two summation orders leave on either side of it would move by 2 lr;
    with eps 1e-3 the move is a smooth function of g, so the gap in the
    new params stays of the order of the gap in g;
(d) the elastic checkpoint: saved on a (4,) mesh, restored onto (2, 2),
    and the step's sharded state saved from (2, 2) and restored
    replicated onto (4,): arrays equal;
(e) this process has no process group afterwards.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

from repro.configs import get_config as jax_get_config
from repro.models import zoo as jax_zoo
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import init_opt_state as jax_init_opt_state
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import make_train_step as jax_make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
RANKS = 4
TIMEOUT_S = 300
B, S, MICRO = 8, 16, 2
LR, EPS = 1e-3, 1e-3
STEP_CASES = ("fp32", "bf16", "seq")
_XLA_OPTS = {"xla_allow_excess_precision": False}

WORKER = r'''
import dataclasses, json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist

out = sys.argv[1]
rank = int(os.environ["RANK"])
dist.init_process_group("gloo")
import logging
logging.getLogger("torch.distributed").setLevel(logging.ERROR)
logging.getLogger("torch._logging").setLevel(logging.ERROR)
from torch.distributed.tensor import DTensor, Shard
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import (default_plan, replicated_plan,
                                       tree_get, tree_map)
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.sharding import (NamedSharding, distribute_tree,
                                  named_sharding_tree, placements_for,
                                  reference_ag_matmul, ring_ag_matmul)
from repro_torch.train import (CheckpointManager, TrainConfig,
                               make_train_step, state_specs)

report = {"timings": {}}
t0 = time.perf_counter()

def gather(obj):
    objs = [None] * dist.get_world_size()
    dist.all_gather_object(objs, obj)
    return objs

def full(tree):
    return tree_map(lambda _, t: t.full_tensor()
                    if isinstance(t, DTensor) else t, tree)

# (a) the ring collective matmul
report["ring"] = {}
for shape in ((1, 4), (2, 2)):
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 64, generator=g)
    w = torch.randn(64, 32, generator=g)
    n, j = shape[1], mesh.get_local_rank("model")
    k = 64 // n
    y = ring_ag_matmul(x, w[j * k:(j + 1) * k], mesh=mesh, axis="model")
    err = float((y - reference_ag_matmul(x, w)).abs().max())
    report["ring"][str(shape)] = gather(err)
report["timings"]["ring"] = time.perf_counter() - t0

# the bridged state, the batch and the (2, 2) mesh
z = np.load(os.path.join(out, "inputs.npz"))
flat = {k[len("params/"):]: z[k] for k in z.files if k.startswith("params/")}
tree = {}
for path, a in flat.items():
    node = tree
    parts = path.split("/")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = a
params = params_from_jax(tree)
batch = {k: torch.from_numpy(z[k]).long() for k in ("tokens", "targets")}
mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
plan = default_plan()
tcfg = TrainConfig(microbatches=2, optimizer=AdamWConfig(
    lr=float(sys.argv[2]), eps=float(sys.argv[3]), total_steps=10))
state = {"params": params, "opt": init_opt_state(tcfg.optimizer, params)}
smoke = get_config("olmo-1b", smoke=True)
# the placements the layers pin their activations to, case by case
from repro_torch.models import layers
pinned = []
_constrain = layers.constrain_batch

def spy(x, batch_axes, seq_axes=()):
    y = _constrain(x, batch_axes, seq_axes)
    pinned.append(str(y.placements))
    return y

layers.constrain_batch = spy
cases = {"fp32": {}, "bf16": {"dtype": "bfloat16"},
         "seq": {"seq_axes": ("model",)}}
report["step"] = {}
sharded_state = None
for name, kw in cases.items():
    t1 = time.perf_counter()
    cfg = dataclasses.replace(smoke, batch_axes=("data",), **kw)
    ucfg = dataclasses.replace(cfg, batch_axes=(), seq_axes=())
    new_u, m_u = make_train_step(ucfg, tcfg)(state, batch)
    shardings = named_sharding_tree(plan, mesh, state_specs(cfg, tcfg))
    st = distribute_tree(state, shardings)
    if name == "fp32":
        # (b) this rank's slices under default_plan on (2, 2)
        np.savez(os.path.join(out, f"local_{rank}.npz"), **{
            p: tree_get(st["params"], p).to_local().numpy()
            for p in flat})
        report["coords"] = gather(list(mesh.get_coordinate()))
    pinned.clear()
    new_s, m_s = make_train_step(cfg, tcfg, batch_axes=("data",))(st, batch)
    kept = {}
    for p in flat:
        want = str(tree_get(st["params"], p).placements)
        kept[p] = [str(tree_get(t, p).placements) == want
                   for t in (new_s["params"], new_s["opt"]["mu"],
                             new_s["opt"]["nu"])]
    full_s = full(new_s["params"])
    if rank == 0:
        np.savez(os.path.join(out, f"step_{name}.npz"),
                 **{f"sharded/{p}": tree_get(full_s, p).float().numpy()
                    for p in flat},
                 **{f"unsharded/{p}": tree_get(new_u["params"], p).float()
                    .numpy() for p in flat})
    report["step"][name] = {
        "loss": float(m_s["loss"]), "loss_unsharded": float(m_u["loss"]),
        "grad_norm": float(m_s["grad_norm"]),
        "grad_norm_unsharded": float(m_u["grad_norm"]),
        "metrics_plain": not any(isinstance(v, DTensor)
                                 for v in m_s.values()),
        "placements_kept": all(all(v) for v in kept.values()),
        "pinned": sorted(set(pinned)),
        "seconds": time.perf_counter() - t1}
    if name == "fp32":
        sharded_state = new_s
    report["timings"][f"step_{name}"] = time.perf_counter() - t1

# (d) elastic checkpoints
t1 = time.perf_counter()
ck = os.path.join(out, "ck")
mesh_a = make_mesh((4,), ("data",), device_type="cpu")
mgr = CheckpointManager(ck)
from torch.distributed.tensor import distribute_tensor
mgr.save(5, {"w": distribute_tensor(torch.arange(16.0), mesh_a,
                                    [Shard(0)])}, block=True)
mesh_b = make_mesh((2, 2), ("x", "y"), device_type="cpu")
sh_b = {"w": NamedSharding(mesh_b, placements_for((("x", "y"),), mesh_b))}
restored, _, step = mgr.restore(shardings=sh_b)
w = restored["w"]
report["elastic"] = {
    "step": step, "equal": bool(torch.equal(w.full_tensor(),
                                            torch.arange(16.0))),
    "placements": str(w.placements), "want": str(sh_b["w"].placements),
    "local": gather(w.to_local().tolist())}
mgr2 = CheckpointManager(os.path.join(out, "ck_state"))
mgr2.save(1, sharded_state, block=True)
back, _, _ = mgr2.restore(shardings=named_sharding_tree(
    replicated_plan(), mesh_a, state_specs(smoke, tcfg)))
want = full(sharded_state)
report["elastic"]["state_equal"] = all(
    torch.equal(b.full_tensor(), tree_get(want, p))
    for p, b in ((p, tree_get(back, p)) for p in
                 [f"params/{q}" for q in flat]
                 + [f"opt/{m}/{q}" for m in ("mu", "nu") for q in flat]
                 + ["opt/step"]))
report["timings"]["elastic"] = time.perf_counter() - t1
report["timings"]["worker"] = time.perf_counter() - t0
if rank == 0:
    with open(os.path.join(out, "report.json"), "w") as f:
        json.dump(report, f)
dist.destroy_process_group()
'''

JAX_INDEX = r'''
import json, numpy as np
from jax.sharding import NamedSharding
from repro.configs import get_config
from repro.launch.mesh import make_mesh
from repro.models import zoo
from repro.models.common import default_plan

cfg = get_config("olmo-1b", smoke=True)
mesh = make_mesh((2, 2), ("data", "model"))
plan = default_plan()

def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, p) if isinstance(v, dict) else {p: v})
    return out

specs = flat(zoo.specs(cfg))
out = {}
for path, a in flat(zoo.abstract(cfg)).items():
    sh = NamedSharding(mesh, plan.spec_for(specs[path]))
    out[path] = {}
    for dev, idx in sh.devices_indices_map(a.shape).items():
        coord = [int(c) for c in np.argwhere(mesh.devices == dev)[0]]
        out[path][str(coord)] = [[s.start or 0, n if s.stop is None
                                  else s.stop]
                                 for s, n in zip(idx, a.shape)]
print(json.dumps(out))
'''


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_step(cfg, jparams, batch):
    tcfg = JaxTrainConfig(microbatches=MICRO, optimizer=JaxAdamWConfig(
        lr=LR, eps=EPS, total_steps=10))
    state = {"params": jparams,
             "opt": jax_init_opt_state(tcfg.optimizer, jparams)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax.jit(jax_make_train_step(cfg, tcfg)).lower(
        state, jb).compile(compiler_options=_XLA_OPTS)
    new, metrics = step(state, jb)
    return ({p: np.asarray(a, dtype=np.float32)
             for p, a in _flat(new["params"]).items()},
            float(metrics["loss"]), float(metrics["grad_norm"]))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("multidevice")
    t0 = time.perf_counter()
    cfg = jax_get_config("olmo-1b", smoke=True)
    jparams = jax_zoo.init(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}
    np.savez(out / "inputs.npz", **batch, **{
        f"params/{p}": np.asarray(a) for p, a in _flat(jparams).items()})

    env = {**os.environ, "PYTHONPATH": SRC, "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(_free_port()), "WORLD_SIZE": str(RANKS),
           "OMP_NUM_THREADS": "1"}
    code = textwrap.dedent(WORKER)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(out), repr(LR), repr(EPS)],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        stdin=subprocess.DEVNULL) for r in range(RANKS)]
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_INDEX)],
        env={**os.environ, "PYTHONPATH": SRC,
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        stdin=subprocess.DEVNULL)
    try:
        # the reference's single-device steps, while the ranks run
        import dataclasses
        ref = {"fp32": _jax_step(cfg, jparams, batch),
               "bf16": _jax_step(dataclasses.replace(cfg, dtype="bfloat16"),
                                 jparams, batch)}
        deadline = t0 + TIMEOUT_S
        outs = [p.communicate(timeout=max(deadline - time.perf_counter(), 1))
                for p in procs]
        jax_out = jax_proc.communicate(
            timeout=max(deadline - time.perf_counter(), 1))
    finally:
        for p in (*procs, jax_proc):
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-4000:]}"
    assert jax_proc.returncode == 0, jax_out[1][-4000:]
    with open(out / "report.json") as f:
        report = json.load(f)
    report["seconds"] = time.perf_counter() - t0
    return {"report": report, "out": out, "ref": ref,
            "index": json.loads(jax_out[0].splitlines()[-1]),
            "params": {p: np.asarray(a) for p, a in _flat(jparams).items()}}


@pytest.mark.parametrize("mesh", ["(1, 4)", "(2, 2)"])
def test_ring_ag_matmul_matches_reference(run, mesh):
    errs = run["report"]["ring"][mesh]
    assert len(errs) == RANKS and max(errs) <= 1e-4, errs


def test_default_plan_slices_match_reference_index_map(run):
    coords = run["report"]["coords"]
    assert sorted(map(tuple, coords)) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for rank, coord in enumerate(coords):
        local = np.load(run["out"] / f"local_{rank}.npz")
        assert sorted(local.files) == sorted(run["params"])
        for path, full in run["params"].items():
            bounds = run["index"][path][str(coord)]
            want = full[tuple(slice(a, b) for a, b in bounds)]
            assert local[path].shape == want.shape, (path, coord)
            np.testing.assert_array_equal(local[path], want,
                                          err_msg=f"{path} at {coord}")


@pytest.mark.parametrize("case", STEP_CASES)
def test_sharded_step_matches_unsharded_and_reference(run, case):
    rep = run["report"]["step"][case]
    ref_params, ref_loss, ref_norm = run["ref"][
        "bf16" if case == "bf16" else "fp32"]
    assert rep["metrics_plain"]
    assert rep["placements_kept"], "params or moments lost their placement"
    # the residual stream pinned to the batch over "data", and with
    # sequence parallelism also to the sequence over "model"
    batch_only = "(Shard(dim=0), Replicate())"
    seq = "(Shard(dim=0), Shard(dim=1))"
    assert rep["pinned"] == ([batch_only, seq] if case == "seq"
                             else [batch_only]), rep["pinned"]
    if case == "bf16":
        # the reference's sharded-against-single bound
        assert abs(rep["loss"] - rep["loss_unsharded"]) < 5e-3, rep
        assert abs(rep["loss"] - ref_loss) < 5e-3, (rep, ref_loss)
        return
    assert abs(rep["loss"] - rep["loss_unsharded"]) <= 1e-5, rep
    assert abs(rep["loss"] - ref_loss) <= 1e-5, (rep, ref_loss)
    assert abs(rep["grad_norm"] - ref_norm) <= 1e-5 * ref_norm, rep
    new = np.load(run["out"] / f"step_{case}.npz")
    for path, want in ref_params.items():
        got = new[f"sharded/{path}"]
        scale = float(np.max(np.abs(want)))
        for other in (want, new[f"unsharded/{path}"]):
            gap = float(np.max(np.abs(got - other)))
            assert gap <= 1e-5 * scale, (case, path, gap, scale)


def test_elastic_checkpoint_restores_onto_another_mesh(run):
    el = run["report"]["elastic"]
    assert el["step"] == 5 and el["equal"]
    assert el["placements"] == el["want"]
    # x major, y minor: the rank at (i, j) holds w[4(2i + j):4(2i + j) + 4]
    assert el["local"] == [list(map(float, range(4 * r, 4 * r + 4)))
                           for r in range(RANKS)]
    assert el["state_equal"]


def test_main_process_has_no_process_group(run):
    assert not dist.is_initialized()
