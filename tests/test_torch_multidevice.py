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
(c') the same fp32 step with one attention head a rank, olmo-1b smoke
    with ``n_heads = n_kv_heads`` = the model degree on (1, 2) and
    (2, 2), and GQA with one q head a rank (4 q heads on 2 kv heads on
    (1, 4)): within 1e-5 of the unsharded port's step and the
    reference's;
(c'') q heads that the model axis does not divide, split in head groups
    as GSPMD splits them (gcd of the heads and the axis): 6 heads and 10
    q heads on 2 kv heads, each on (1, 4) (two groups, each on 2
    ranks), within 1e-5 of the unsharded port's step and the
    reference's;
(d) the elastic checkpoint: saved on a (4,) mesh, restored onto (2, 2),
    and the step's sharded state saved from (2, 2) and restored
    replicated onto (4,): arrays equal; a compressed step's sharded
    state, "error" included, saved and restored onto its own placements
    by ``restore(shardings=...)``: arrays and placements equal;
(e) this process has no process group afterwards;
(i) gradient compression on a sharded state: topk and int8 steps on
    (2, 2) and (1, 4) against the unsharded port's and the reference's
    ``make_train_step`` with the same ``CompressionConfig`` (loss, grad
    norm and every parameter at the sharded-step tolerance; the "error"
    state on its parameter's placements, equal to the unsharded
    port's within 1e-5 of its largest |value| but where a gap of about
    1e-7 in a gradient moves an element across a rounding or threshold
    boundary: those elements are counted and kept under 0.2 %); and
    ``compress`` of placed gradients (Shard(0), Shard(1), uneven on
    both mesh dims, Replicate, and a leaf of ties at the threshold) bit
    for bit with the plain ``compress`` of the full tensors.
"""

import dataclasses
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
from repro.optim import CompressionConfig as JaxCompressionConfig
from repro.optim import init_error_state as jax_init_error_state
from repro.optim import init_opt_state as jax_init_opt_state
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import make_train_step as jax_make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
RANKS = 4
# the ranks' wall time: about 170 s alone on a CPU; beside five other
# test workers (the tier-1 run) it took more than 300 s
TIMEOUT_S = 600
B, S, MICRO = 8, 16, 2
LR, EPS = 1e-3, 1e-3
# (c') one head a rank: mesh, n_heads, n_kv_heads
HEAD_CASES = {"one-head-1x2": ([1, 2], 2, 2), "one-head-2x2": ([2, 2], 2, 2),
              "gqa-one-head-1x4": ([1, 4], 4, 2)}
# (c'') q heads in groups: mesh, n_heads, n_kv_heads
GROUP_CASES = {"six-heads-1x4": ([1, 4], 6, 6),
               "ten-on-two-heads-1x4": ([1, 4], 10, 2)}
STEP_CASES = ("fp32", "bf16", "seq", *HEAD_CASES, *GROUP_CASES)
# (i) compressed steps: mesh, scheme
COMPRESSED_CASES = {"topk-2x2": ([2, 2], "topk"), "int8-2x2": ([2, 2], "int8"),
                    "topk-1x4": ([1, 4], "topk"), "int8-1x4": ([1, 4], "int8")}
TOPK_RATIO = 0.05
PLACED_SCHEMES = {"topk-0.01": ("topk", 0.01), "topk-0.3": ("topk", 0.3),
                  "int8": ("int8", 0.01)}
# elements of an "error" leaf allowed across a boundary
FLIP_SHARE = 2e-3
# (f) the other families' train steps: arch, plan rules, config fields
TRAIN_CASES = {
    "mixtral-expert": ("mixtral-8x7b", {}, {}),
    "mixtral-expert-replicated": ("mixtral-8x7b", {"expert": []}, {}),
    "recurrentgemma": ("recurrentgemma-2b", {}, {}),
    "rwkv6": ("rwkv6-1.6b", {}, {}),
    "rwkv6-seq": ("rwkv6-1.6b", {}, {"seq_axes": ["model"]}),
    "vlm": ("llama-3.2-vision-11b", {}, {}),
    "whisper": ("whisper-small", {}, {}),
}
# (g), (h) sharded prefill and decode: arch, mesh, and the cache plan's
# kv axes (None: ``default_plan``; else the kv policy over those axes and
# the batch unsplit, as the reference's plans with ``rules["kv"]`` over
# every axis: each mesh dim splits the cache's sequence, nested)
SERVE_CASES = {
    "olmo-head-sharded": ("olmo-1b", [2, 2], None),
    "recurrentgemma-seq-sharded": ("recurrentgemma-2b", [2, 2], None),
    "mixtral-seq-sharded": ("mixtral-8x7b", [1, 4], None),
    "mixtral-seq-sharded-nested": ("mixtral-8x7b", [2, 2],
                                   ["data", "model"]),
    "rwkv6": ("rwkv6-1.6b", [2, 2], None),
    "vlm": ("llama-3.2-vision-11b", [2, 2], None),
    "whisper": ("whisper-small", [2, 2], None),
    "whisper-replicated": ("whisper-small", [4, 1], None),
}
# rwkv6's decay bias and LoRA: decays exp(-exp(w0 + lora)) in about
# (0.6, 0.95), where the reference's chunked WKV6 keeps finite gradients
# (its gradient is NaN once decays reach its 1e-8 clip: ROADMAP Faults
# item 4; the port's per-step form has no such limit)
DECAY_DRAWS = {"layers/w0": (-3.0, -1.0), "layers/w_lora_b": (-0.05, 0.05)}
SEQ_SHARDED = "sequence-sharded(flash-decode)"
STRATEGY = {"olmo-head-sharded": "head-sharded",
            "recurrentgemma-seq-sharded": SEQ_SHARDED,
            "mixtral-seq-sharded": SEQ_SHARDED,
            "mixtral-seq-sharded-nested": SEQ_SHARDED,
            "whisper-replicated": "replicated-heads"}
DECODE_STEPS = 3
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
from torch.distributed.tensor import DTensor, Replicate, Shard
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

def flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(flat_tree(v, p) if isinstance(v, dict) else {p: v})
    return out

def tree_leaves_paths(tree):
    return sorted(flat_tree(tree))

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
layers.constrain_batch = _constrain

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

# (i) compression on placed gradients, then compressed sharded steps
from repro_torch.optim import CompressionConfig, compress, init_error_state
t1 = time.perf_counter()
g = torch.Generator().manual_seed(5)
grads = {"shard0": torch.randn(10, 12, generator=g),
         "shard1": torch.randn(12, 10, generator=g),
         "uneven": torch.randn(7, 5, generator=g),
         "replicate": torch.randn(6, 4, generator=g),
         "ties": torch.randint(-3, 4, (8, 8), generator=g).float()}
errors = {k: 0.1 * torch.randn(v.shape, generator=g)
          for k, v in grads.items()}
placed_at = {"shard0": (Shard(0), Replicate()),
             "shard1": (Replicate(), Shard(1)),
             "uneven": (Shard(0), Shard(1)),
             "replicate": (Replicate(), Replicate()),
             "ties": (Shard(1), Shard(0))}
report["placed_compress"] = {}
cases = json.loads(sys.argv[4])
for name, (scheme, ratio) in cases["placed"].items():
    ccfg = CompressionConfig(scheme=scheme, topk_ratio=ratio)
    wire, err, _ = compress(ccfg, grads, errors)
    pwire, perr, _ = compress(
        ccfg, {k: distribute_tensor(v, mesh, placed_at[k], src_data_rank=None)
               for k, v in grads.items()},
        {k: distribute_tensor(v, mesh, placed_at[k], src_data_rank=None)
         for k, v in errors.items()})
    report["placed_compress"][name] = {
        k: {"wire": bool(torch.equal(pwire[k].full_tensor(), wire[k])),
            "error": bool(torch.equal(perr[k].full_tensor(), err[k])),
            "placements": [list(pwire[k].placements) == list(placed_at[k]),
                           list(perr[k].placements) == list(placed_at[k])]}
        for k in grads}

report["compressed"] = {}
cstate = {**state, "error": init_error_state(params)}


def compressed(scheme):
    return dataclasses.replace(tcfg, compression=CompressionConfig(
        scheme=scheme, topk_ratio=float(sys.argv[5])))


for name, (shape, scheme) in cases["compressed"].items():
    cmesh = make_mesh(tuple(shape), ("data", "model"), device_type="cpu")
    cfg = dataclasses.replace(smoke, batch_axes=("data",))
    csh = named_sharding_tree(plan, cmesh,
                              state_specs(cfg, compressed(scheme)))
    st = distribute_tree(cstate, csh)
    new_s, m_s = make_train_step(cfg, compressed(scheme),
                                 batch_axes=("data",))(st, batch)
    kept = all(str(tree_get(new_s, f"{part}/{p}").placements)
               == str(tree_get(st, f"params/{p}").placements)
               for p in flat for part in ("params", "error"))
    full_s = full(new_s)
    if rank == 0:
        np.savez(os.path.join(out, f"compressed_{name}.npz"),
                 **{f"{part}/{p}": tree_get(full_s, f"{part}/{p}").numpy()
                    for p in flat for part in ("params", "error")})
    rep = {"loss": float(m_s["loss"]), "grad_norm": float(m_s["grad_norm"]),
           "ratio": m_s["compression_ratio"],
           "metrics_plain": not any(isinstance(v, DTensor)
                                    for v in m_s.values()),
           "placements_kept": kept}
    if name == "topk-2x2":
        # the state with "error" through a checkpoint and back onto its
        # own placements
        mgr3 = CheckpointManager(os.path.join(out, "ck_compressed"))
        mgr3.save(1, new_s, block=True)
        back, _, _ = mgr3.restore(shardings=csh)
        rep["restored"] = all(
            torch.equal(tree_get(back, p).full_tensor(),
                        tree_get(full_s, p))
            and str(tree_get(back, p).placements)
            == str(tree_get(new_s, p).placements)
            for p in [f"{part}/{q}" for q in flat
                      for part in ("params", "error", "opt/mu", "opt/nu")])
    report["compressed"][name] = rep
# the unsharded compressed steps, one a scheme, on rank 0 alone
report["compressed_unsharded"] = {}
if rank == 0:
    ucfg = dataclasses.replace(smoke, batch_axes=())
    for scheme in sorted({s for _, s in cases["compressed"].values()}):
        new_u, m_u = make_train_step(ucfg, compressed(scheme))(cstate, batch)
        np.savez(os.path.join(out, f"compressed_unsharded_{scheme}.npz"),
                 **{f"{part}/{p}": tree_get(new_u, f"{part}/{p}").numpy()
                    for p in flat for part in ("params", "error")})
        report["compressed_unsharded"][scheme] = {
            "loss": float(m_u["loss"]), "grad_norm": float(m_u["grad_norm"]),
            "ratio": m_u["compression_ratio"]}
report["timings"]["compressed"] = time.perf_counter() - t1

# (f), (g), (h): the other families
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.hw.cost import CostCounter
from repro_torch.models import zoo
from repro_torch.serving import cache_shardings
from repro_torch.train import make_prefill_step, make_serve_step
cases = json.loads(sys.argv[4])

def family_inputs(arch):
    z = np.load(os.path.join(out, f"inputs_{arch}.npz"))
    tree = {}
    for k in z.files:
        if not k.startswith("params/"):
            continue
        node = tree
        parts = k[len("params/"):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = z[k]
    batch = {k: torch.from_numpy(z[k]) for k in z.files
             if not k.startswith("params/")}
    for k in ("tokens", "targets"):
        batch[k] = batch[k].long()
    return params_from_jax(tree), batch

def counts(cm):
    return {str(op): int(n) for op, n in cm.get_comm_counts().items()}

def kinds(cc):
    """The dry-run counter's collectives by kind."""
    out = {}
    for op in cc.collectives:
        out[op.kind] = out.get(op.kind, 0) + 1
    return out

def cache_plan(plan, kv, shape):
    """The plan that places a serving case's cache, and its kv degree."""
    if not kv:
        return plan, shape[1]
    cplan = dataclasses.replace(plan, batch_axes=(),
                                rules={**plan.rules, "kv": tuple(kv)})
    return cplan, int(np.prod([shape[("data", "model").index(a)]
                               for a in kv]))

# attention with q heads split where the kv heads do not divide and the
# rank's q heads straddle kv groups unevenly (H=12, K=3 on model=2)
g = torch.Generator().manual_seed(3)
qa, ka, va = (torch.randn(2, 4, n, 8, generator=g) for n in (12, 3, 3))
want = layers.attention(qa, ka, va, causal=True)
qd = DTensor.from_local(qa, mesh, [Replicate(), Replicate()],
                        run_check=False).redistribute(
    mesh, (Shard(0), Shard(2)))
got = layers.attention(qd, ka, va, causal=True)
report["attention_groups"] = {
    "err": float((got.full_tensor() - want).abs().max()),
    "placements": str(got.placements)}

# (c') one head a rank, (c'') head groups: the groups each step makes
t_heads = time.perf_counter()
layers.constrain_batch = spy
groups_made = []
_group_mesh = layers._head_group_mesh

def group_spy(mesh, dim, groups):
    groups_made.append(str((dim, groups)))
    return _group_mesh(mesh, dim, groups)

layers._head_group_mesh = group_spy
for name, (shape, nh, nkv) in {**cases["heads"], **cases["groups"]}.items():
    t1 = time.perf_counter()
    hparams, hbatch = family_inputs(f"heads-{nh}-{nkv}")
    if shape[0] * shape[1] < dist.get_world_size():
        # (1, 2) on 4 ranks: two meshes of 2, each rank in one
        hmesh = make_mesh((2, *shape), ("replica", "data", "model"),
                          device_type="cpu")["data", "model"]
    else:
        hmesh = make_mesh(tuple(shape), ("data", "model"), device_type="cpu")
    cfg = dataclasses.replace(smoke, n_heads=nh, n_kv_heads=nkv,
                              batch_axes=("data",))
    ucfg = dataclasses.replace(cfg, batch_axes=())
    hstate = {"params": hparams,
              "opt": init_opt_state(tcfg.optimizer, hparams)}
    new_u, m_u = make_train_step(ucfg, tcfg)(hstate, hbatch)
    st = distribute_tree(hstate, named_sharding_tree(
        default_plan(), hmesh, state_specs(cfg, tcfg)))
    pinned.clear()
    groups_made.clear()
    new_s, m_s = make_train_step(cfg, tcfg, batch_axes=("data",))(st, hbatch)
    paths = tree_leaves_paths(hparams)
    kept = all(str(tree_get(t, p).placements)
               == str(tree_get(st["params"], p).placements)
               for p in paths for t in (new_s["params"], new_s["opt"]["mu"],
                                        new_s["opt"]["nu"]))
    full_s = full(new_s["params"])
    if rank == 0:
        np.savez(os.path.join(out, f"step_{name}.npz"),
                 **{f"sharded/{p}": tree_get(full_s, p).float().numpy()
                    for p in paths},
                 **{f"unsharded/{p}": tree_get(new_u["params"], p).float()
                    .numpy() for p in paths})
    report["step"][name] = {
        "loss": float(m_s["loss"]), "loss_unsharded": float(m_u["loss"]),
        "grad_norm": float(m_s["grad_norm"]),
        "grad_norm_unsharded": float(m_u["grad_norm"]),
        "metrics_plain": not any(isinstance(v, DTensor)
                                 for v in m_s.values()),
        "placements_kept": kept, "pinned": sorted(set(pinned)),
        "heads_a_rank": tree_get(st["params"], "layers/wq").to_local()
        .shape[-1] // cfg.hd,
        "head_groups": sorted(set(groups_made)),
        "seconds": time.perf_counter() - t1}
layers.constrain_batch = _constrain
layers._head_group_mesh = _group_mesh
report["timings"]["one_head"] = time.perf_counter() - t_heads

report["family_step"] = {}
t_fam = time.perf_counter()
for name, (arch, rules, kw) in cases["train"].items():
    t1 = time.perf_counter()
    fparams, fbatch = family_inputs(arch)
    fplan = default_plan()
    fplan.rules.update({k: tuple(v) for k, v in rules.items()})
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              batch_axes=("data",),
                              **{k: tuple(v) for k, v in kw.items()})
    fstate = {"params": fparams,
              "opt": init_opt_state(tcfg.optimizer, fparams)}
    st = distribute_tree(fstate, named_sharding_tree(
        fplan, mesh, state_specs(cfg, tcfg)))
    with CommDebugMode() as cm, CostCounter() as cc:
        new_s, m_s = make_train_step(cfg, tcfg, batch_axes=("data",))(
            st, fbatch)
    paths = [p for p in tree_leaves_paths(fparams)]
    kept = all(str(tree_get(t, p).placements)
               == str(tree_get(st["params"], p).placements)
               for p in paths for t in (new_s["params"], new_s["opt"]["mu"],
                                        new_s["opt"]["nu"]))
    full_s = full(new_s["params"])
    rep = {"loss": float(m_s["loss"]), "grad_norm": float(m_s["grad_norm"]),
           "placements_kept": kept, "collectives": counts(cm),
           "counted": kinds(cc),
           "placements": {p: str(tree_get(st["params"], p).placements)
                          for p in paths}}
    if rank == 0:
        ucfg = dataclasses.replace(cfg, batch_axes=(), seq_axes=())
        new_u, m_u = make_train_step(ucfg, tcfg)(fstate, fbatch)
        rep["loss_unsharded"] = float(m_u["loss"])
        np.savez(os.path.join(out, f"family_step_{name}.npz"),
                 **{f"sharded/{p}": tree_get(full_s, p).float().numpy()
                    for p in paths},
                 **{f"unsharded/{p}": tree_get(new_u["params"], p).float()
                    .numpy() for p in paths})
    rep["seconds"] = time.perf_counter() - t1
    report["family_step"][name] = rep
report["timings"]["family_step"] = time.perf_counter() - t_fam

report["serve"] = {}
t_fam = time.perf_counter()
for name, (arch, shape, kv) in cases["serve"].items():
    t1 = time.perf_counter()
    fparams, fbatch = family_inputs(arch)
    smesh = make_mesh(tuple(shape), ("data", "model"), device_type="cpu")
    plan = default_plan()
    cplan, degree = cache_plan(plan, kv, shape)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              batch_axes=cplan.batch_axes)
    ucfg = dataclasses.replace(cfg, batch_axes=())
    b, s = fbatch["tokens"].shape
    max_len = zoo.cache_max_len(cfg, s + 4)
    prompt = {k: v for k, v in fbatch.items() if k != "targets"}
    sp = distribute_tree(fparams, named_sharding_tree(plan, smesh,
                                                      zoo.specs(cfg)))
    csh, strategy = cache_shardings(
        cfg, cplan, smesh, zoo.abstract_cache(cfg, b, max_len),
        model_degree=degree)
    lu, cu = make_prefill_step(ucfg, max_len)(fparams, prompt)
    with CommDebugMode() as cm, CostCounter() as cc:
        ls, cs = make_prefill_step(cfg, max_len, csh)(sp, prompt)
    coll = {"prefill": counts(cm)}
    counted = {"prefill": kinds(cc)}
    errs = [float((lu - ls).abs().max())]
    scale = [float(lu.abs().max())]
    step_u, step_s = make_serve_step(ucfg), make_serve_step(cfg)
    tok = torch.argmax(lu, dim=-1)
    for i in range(3):
        lu, cu = step_u(fparams, cu, tok, s + i)
        with CommDebugMode() as cm, CostCounter() as cc:
            ls, cs = step_s(sp, cs, tok, s + i)
        coll.setdefault("decode", counts(cm))
        counted.setdefault("decode", kinds(cc))
        errs.append(float((lu - ls).abs().max()))
        scale.append(float(lu.abs().max()))
        tok = torch.argmax(lu, dim=-1)
    leaves = {p: t for p, t in flat_tree(cs).items()
              if isinstance(t, torch.Tensor)}
    np.savez(os.path.join(out, f"cache_{name}_{rank}.npz"),
             **{p: t.to_local().numpy() for p, t in leaves.items()})
    gathered = {p: t.full_tensor().numpy() for p, t in leaves.items()}
    if rank == 0:
        np.savez(os.path.join(out, f"cache_{name}_full.npz"), **gathered)
        np.savez(os.path.join(out, f"cache_{name}_unsharded.npz"),
                 **{p: t.numpy() for p, t in flat_tree(cu).items()
                    if isinstance(t, torch.Tensor)})
    report["serve"][name] = {
        "strategy": strategy, "errs": errs, "scale": scale,
        "coords": gather(list(smesh.get_coordinate())),
        "placements": {p: str(t.placements) for p, t in leaves.items()},
        "len": [cu["len"], cs["len"]], "collectives": coll,
        "counted": counted,
        "seconds": time.perf_counter() - t1}
report["timings"]["serve"] = time.perf_counter() - t_fam
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

def index_map(sh, shape, mesh):
    out = {}
    for dev, idx in sh.devices_indices_map(shape).items():
        coord = [int(c) for c in np.argwhere(mesh.devices == dev)[0]]
        out[str(coord)] = [[s.start or 0, n if s.stop is None else s.stop]
                           for s, n in zip(idx, shape)]
    return out

specs = flat(zoo.specs(cfg))
out = {}
for path, a in flat(zoo.abstract(cfg)).items():
    out[path] = index_map(NamedSharding(mesh, plan.spec_for(specs[path])),
                          a.shape, mesh)

# (h) the caches of the serving cases, placed by cache_shardings
import dataclasses, sys
from repro.serving.kvcache import cache_shardings
caches = {}
for name, (arch, shape, kv) in json.loads(sys.argv[1])["serve"].items():
    cplan, degree = default_plan(), shape[1]
    if kv:
        cplan.batch_axes = ()
        cplan.rules["kv"] = tuple(kv)
        degree = int(np.prod([shape[("data", "model").index(a)]
                              for a in kv]))
    ccfg = dataclasses.replace(get_config(arch, smoke=True),
                               batch_axes=cplan.batch_axes)
    cmesh = make_mesh(tuple(shape), ("data", "model"))
    b, s = [int(n) for n in sys.argv[2].split(",")]
    cache = zoo.abstract_cache(ccfg, b, zoo.cache_max_len(ccfg, s + 4))
    sh, strategy = cache_shardings(ccfg, cplan, cmesh, cache,
                                   model_degree=degree)
    caches[name] = {"strategy": strategy, "maps": {
        p: index_map(sh_p, flat(cache)[p].shape, cmesh)
        for p, sh_p in flat(sh).items() if p != "len"}}
print(json.dumps({"params": out, "caches": caches}))
'''


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _nest(flat: dict) -> dict:
    """A ``/``-path dict of arrays -> the nested tree of jnp arrays."""
    tree = {}
    for path, a in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(a)
    return tree


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_step(cfg, jparams, batch, compression=None):
    tcfg = JaxTrainConfig(microbatches=MICRO, optimizer=JaxAdamWConfig(
        lr=LR, eps=EPS, total_steps=10),
        compression=compression or JaxCompressionConfig())
    state = {"params": jparams,
             "opt": jax_init_opt_state(tcfg.optimizer, jparams)}
    if compression is not None:
        state["error"] = jax_init_error_state(jparams)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax.jit(jax_make_train_step(cfg, tcfg)).lower(
        state, jb).compile(compiler_options=_XLA_OPTS)
    new, metrics = step(state, jb)
    out = ({p: np.asarray(a, dtype=np.float32)
            for p, a in _flat(new["params"]).items()},
           float(metrics["loss"]), float(metrics["grad_norm"]))
    if compression is None:
        return out
    return (*out, {p: np.asarray(a) for p, a in _flat(new["error"]).items()})


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

    # every family's bridged params, each leaf the reference's init left
    # at zero drawn from U(-0.5, 0.5) (a zero leaf's first AdamW move is
    # about lr * sign(g), so a bound relative to its largest |value|
    # would be one relative to lr), rwkv6's decay leaves from DECAY_DRAWS,
    # and the batch with a frontend for vlm and audio
    fam_params, fam_batch = {}, {}
    for arch in sorted({a for a, _, _ in TRAIN_CASES.values()}
                       | {a for a, _, _ in SERVE_CASES.values()}):
        fcfg = jax_get_config(arch, smoke=True)
        flat = {p: np.asarray(a) for p, a in
                _flat(jax_zoo.init(fcfg, jax.random.PRNGKey(0))).items()}
        for p, a in flat.items():
            if not a.any():
                lo, hi = DECAY_DRAWS.get(p, (-0.5, 0.5))
                flat[p] = rng.uniform(lo, hi, a.shape).astype(a.dtype)
        ftok = rng.integers(0, fcfg.vocab, size=(B, S)).astype(np.int32)
        fb = {"tokens": ftok, "targets": np.roll(ftok, -1, axis=1)}
        if fcfg.n_frontend_tokens:
            fb["frontend"] = rng.standard_normal(
                (B, fcfg.n_frontend_tokens, fcfg.d_model)).astype(np.float32)
        np.savez(out / f"inputs_{arch}.npz", **fb,
                 **{f"params/{p}": a for p, a in flat.items()})
        fam_params[arch], fam_batch[arch] = flat, fb
    # (c') the one-head configs' params, the olmo batch
    head_cfgs = {}
    for _, nh, nkv in (*HEAD_CASES.values(), *GROUP_CASES.values()):
        hcfg = dataclasses.replace(cfg, n_heads=nh, n_kv_heads=nkv)
        hflat = {p: np.asarray(a) for p, a in
                 _flat(jax_zoo.init(hcfg, jax.random.PRNGKey(0))).items()}
        np.savez(out / f"inputs_heads-{nh}-{nkv}.npz", **batch,
                 **{f"params/{p}": a for p, a in hflat.items()})
        head_cfgs[(nh, nkv)] = (hcfg, hflat)
    cases = json.dumps({"train": TRAIN_CASES, "serve": SERVE_CASES,
                        "heads": HEAD_CASES, "groups": GROUP_CASES,
                        "compressed": COMPRESSED_CASES,
                        "placed": PLACED_SCHEMES})

    env = {**os.environ, "PYTHONPATH": SRC, "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(_free_port()), "WORLD_SIZE": str(RANKS),
           "OMP_NUM_THREADS": "1"}
    code = textwrap.dedent(WORKER)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(out), repr(LR), repr(EPS), cases,
         repr(TOPK_RATIO)],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        stdin=subprocess.DEVNULL) for r in range(RANKS)]
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_INDEX), cases,
         f"{B},{S}"],
        env={**os.environ, "PYTHONPATH": SRC,
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        stdin=subprocess.DEVNULL)
    try:
        # the reference's single-device steps, while the ranks run
        ref = {"fp32": _jax_step(cfg, jparams, batch),
               "bf16": _jax_step(dataclasses.replace(cfg, dtype="bfloat16"),
                                 jparams, batch)}
        head_ref = {key: _jax_step(hcfg, _nest(hflat), batch)
                    for key, (hcfg, hflat) in head_cfgs.items()}
        for name, (_, nh, nkv) in {**HEAD_CASES, **GROUP_CASES}.items():
            ref[name] = head_ref[(nh, nkv)]
        compressed_ref = {
            scheme: _jax_step(cfg, jparams, batch, JaxCompressionConfig(
                scheme=scheme, topk_ratio=TOPK_RATIO))
            for scheme in sorted({s for _, s in COMPRESSED_CASES.values()})}
        fam_ref = {arch: _jax_step(jax_get_config(arch, smoke=True),
                                   _nest(fam_params[arch]), fam_batch[arch])
                   for arch in sorted({a for a, _, _ in
                                       TRAIN_CASES.values()})}
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
    index = json.loads(jax_out[0].splitlines()[-1])
    return {"report": report, "out": out, "ref": ref, "family_ref": fam_ref,
            "compressed_ref": compressed_ref,
            "index": index["params"], "cache_index": index["caches"],
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
        case if case in HEAD_CASES or case in GROUP_CASES
        else "bf16" if case == "bf16" else "fp32"]
    if case in HEAD_CASES:
        # one q head a rank, as the case's name says
        assert rep["heads_a_rank"] == 1, rep
    if case in GROUP_CASES:
        # "model" (mesh dim 1) unflattened into 2 head groups of 2 ranks
        assert rep["head_groups"] == ["(1, 2)"], rep
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


def _held_to_reference(new, ref_params: dict, case: str) -> None:
    """Every updated parameter of the sharded step within 1e-5 of its
    largest |value| of the reference's and of the unsharded port's."""
    for path, want in ref_params.items():
        got = new[f"sharded/{path}"]
        scale = float(np.max(np.abs(want)))
        for other in (want, new[f"unsharded/{path}"]):
            gap = float(np.max(np.abs(got - other)))
            assert gap <= 1e-5 * scale, (case, path, gap, scale)


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_sharded_family_step_matches_unsharded_and_reference(run, case):
    rep = run["report"]["family_step"][case]
    arch, rules, kw = TRAIN_CASES[case]
    ref_params, ref_loss, ref_norm = run["family_ref"][arch]
    assert rep["placements_kept"], "params or moments lost their placement"
    assert abs(rep["loss"] - rep["loss_unsharded"]) <= 1e-5, rep
    assert abs(rep["loss"] - ref_loss) <= 1e-5, (rep, ref_loss)
    assert abs(rep["grad_norm"] - ref_norm) <= 1e-5 * ref_norm, rep
    _held_to_reference(np.load(run["out"] / f"family_step_{case}.npz"),
                       ref_params, case)
    if arch == "mixtral-8x7b":
        # (layers, expert, embed, ff) on ("data", "model"): the experts
        # split over "model" (E=4 on 2), or the FFN inside each expert
        want = ("(Shard(dim=2), Shard(dim=3))" if "expert" in rules
                else "(Shard(dim=2), Shard(dim=1))")
        assert rep["placements"]["layers/w_gate"] == want, rep["placements"]


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_sharded_prefill_and_decode_match_unsharded(run, case):
    """Prefill and ``DECODE_STEPS`` decode steps on params placed by
    ``default_plan`` and a cache placed by ``cache_shardings``: fp32 logits
    within 1e-5 of the unsharded port's, and every cache leaf within 1e-5
    of its largest |value| (rwkv6's fp32 matrix state sums 19 steps)."""
    rep = run["report"]["serve"][case]
    assert rep["strategy"] == run["cache_index"][case]["strategy"]
    assert rep["strategy"] == STRATEGY.get(case, rep["strategy"])
    assert len(rep["errs"]) == 1 + DECODE_STEPS
    assert max(rep["errs"]) <= 1e-5, rep
    assert rep["len"][0] == rep["len"][1]
    full = np.load(run["out"] / f"cache_{case}_full.npz")
    unsharded = np.load(run["out"] / f"cache_{case}_unsharded.npz")
    assert sorted(full.files) == sorted(unsharded.files)
    for path in full.files:
        gap = float(np.max(np.abs(full[path] - unsharded[path])))
        scale = max(float(np.max(np.abs(unsharded[path]))), 1.0)
        assert gap <= 1e-5 * scale, (case, path, gap, scale)


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_cache_slices_match_reference_index_map(run, case):
    """(h) each rank's local slice of every cache leaf is the slice the
    reference's ``cache_shardings`` index map gives the device at the same
    mesh coordinate."""
    maps = run["cache_index"][case]["maps"]
    full = np.load(run["out"] / f"cache_{case}_full.npz")
    coords = run["report"]["serve"][case]["coords"]
    assert len({tuple(c) for c in coords}) == RANKS
    for rank, coord in enumerate(coords):
        local = np.load(run["out"] / f"cache_{case}_{rank}.npz")
        assert sorted(local.files) == sorted(maps)
        for path, index in maps.items():
            want = full[path][tuple(slice(a, b)
                                    for a, b in index[str(coord)])]
            np.testing.assert_array_equal(local[path], want,
                                          err_msg=f"{case} {path} {coord}")


def test_attention_on_unevenly_straddled_kv_groups(run):
    """q heads split over "model" where the kv heads do not divide it and
    each rank's 6 of 12 q heads straddle the 3 kv groups of 4 unevenly:
    the sharded attention equals the whole one."""
    rep = run["report"]["attention_groups"]
    assert rep["placements"] == "(Shard(dim=0), Shard(dim=2))", rep
    assert rep["err"] <= 1e-6, rep


def _by_kind(comm_counts: dict) -> dict:
    """``CommDebugMode``'s counts (by functional collective op) by the
    reference's kinds."""
    names = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
             "all_reduce": "all-reduce", "all_to_all": "all-to-all"}
    out = {}
    for op, n in comm_counts.items():
        kind = next(k for name, k in names.items() if name in op)
        out[kind] = out.get(kind, 0) + n
    return out


def test_collectives_are_recorded_per_family(run):
    """A record, not a bound: each family's collectives a step by kind
    (``CommDebugMode``), for ``PERF.md``; the dry-run's counter
    (``hw.cost.CostCounter``, on in the same steps) counts the same
    collectives, kind by kind."""
    rep = run["report"]
    for group in (rep["family_step"].values(), rep["serve"].values()):
        for case in group:
            flat = (case["collectives"].items()
                    if "prefill" not in case["collectives"] else
                    [kv for d in case["collectives"].values()
                     for kv in d.items()])
            assert all(isinstance(n, int) and n >= 0 for _, n in flat)
    for case in rep["family_step"].values():
        assert case["counted"] == _by_kind(case["collectives"]), case
    for case in rep["serve"].values():
        for phase in ("prefill", "decode"):
            assert case["counted"][phase] == \
                _by_kind(case["collectives"][phase]), (phase, case)
    with open(run["out"] / "collectives.json", "w") as f:
        json.dump({"train": {k: v["collectives"] for k, v in
                             rep["family_step"].items()},
                   "serve": {k: v["collectives"] for k, v in
                             rep["serve"].items()}}, f, indent=1)


def test_main_process_has_no_process_group(run):
    assert not dist.is_initialized()


@pytest.mark.parametrize("case", sorted(COMPRESSED_CASES))
def test_compressed_step_matches_unsharded_and_reference(run, case):
    """(i) A compressed step on a sharded state against the unsharded
    port's compressed step and the reference's: loss and grad norm
    within the sharded-step tolerance, the parameters and "error" on
    their placements, ``compression_ratio`` the reference's.  A gap of
    the order of 1e-7 in a gradient (another summation order) can move
    an element across an int8 rounding boundary or the top-k threshold:
    its wire value then differs by a quantum, or by the whole element,
    and so do its "error" and its AdamW update.  Such elements, found
    where the "error" leaves differ by more than 1e-5 of the compressed
    gradient's largest |value| (for int8 at least 254 x the error's, an
    int8 residual being at most half a quantum, max|g| / 254), are at
    most ``FLIP_SHARE`` of a leaf, and their parameters differ by at
    most 2 lr; every other element of every parameter and "error" leaf
    is within the tolerance (1e-5 of the leaf's largest |value|)."""
    rep = run["report"]["compressed"][case]
    scheme = COMPRESSED_CASES[case][1]
    plain = run["report"]["compressed_unsharded"][scheme]
    ref_params, ref_loss, ref_norm, ref_error = \
        run["compressed_ref"][scheme]
    assert rep["metrics_plain"] and rep["placements_kept"], rep
    want = TOPK_RATIO if scheme == "topk" else 0.25
    assert rep["ratio"] == plain["ratio"] == want, (rep, plain)
    assert abs(rep["loss"] - plain["loss"]) <= 1e-5, (rep, plain)
    assert abs(rep["loss"] - ref_loss) <= 1e-5, (rep, ref_loss)
    assert abs(rep["grad_norm"] - ref_norm) <= 1e-5 * ref_norm, rep
    new = np.load(run["out"] / f"compressed_{case}.npz")
    unsharded = np.load(run["out"] / f"compressed_unsharded_{scheme}.npz")
    for path, want_p in ref_params.items():
        got, got_e = new[f"params/{path}"], new[f"error/{path}"]
        scale = float(np.max(np.abs(want_p)))
        for other, other_e in ((want_p, ref_error[path]),
                               (unsharded[f"params/{path}"],
                                unsharded[f"error/{path}"])):
            scale_e = max(float(np.max(np.abs(other_e))), 1e-30) * (
                254 if scheme == "int8" else 1)
            flipped = np.abs(got_e - other_e) > 1e-5 * scale_e
            assert flipped.sum() <= FLIP_SHARE * flipped.size, \
                (case, path, int(flipped.sum()))
            gap = np.abs(got - other)
            assert gap[~flipped].max(initial=0.0) <= 1e-5 * scale, \
                (case, path, float(gap[~flipped].max()), scale)
            assert gap[flipped].max(initial=0.0) <= 2 * LR, (case, path)


@pytest.mark.parametrize("scheme", sorted(PLACED_SCHEMES))
def test_placed_compress_equals_plain_bit_for_bit(run, scheme):
    """(i) ``compress`` of placed gradients and errors: the wire and the
    new error of every leaf, gathered, equal the plain ``compress`` of
    the full tensors bit for bit, on the leaf's placements."""
    rep = run["report"]["placed_compress"][scheme]
    assert sorted(rep) == ["replicate", "shard0", "shard1", "ties",
                           "uneven"]
    for leaf, r in rep.items():
        assert r == {"wire": True, "error": True,
                     "placements": [True, True]}, (scheme, leaf, r)


def test_compressed_state_restores_onto_its_placements(run):
    """(d) The compressed (2, 2) step's state, "error" included, through
    ``CheckpointManager.save`` and ``restore(shardings=...)``."""
    assert run["report"]["compressed"]["topk-2x2"]["restored"]
