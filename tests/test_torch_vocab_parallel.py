"""The port's vocab-parallel cross-entropy (``zoo.loss_fn`` on logits split
over the vocab, ``layers.vocab_parallel_nll``) on 4 gloo ranks on the CPU,
against the reference's ``loss_fn``.

One module-scoped fixture starts 4 ranks (``WORKER``, each a process with a
gloo process group) and computes the reference's loss and its gradient
in this process.  The logits are the same seeded fp32 (B, S, V) array on
both sides, V the padded vocab of a config whose vocab is smaller (pad
columns are never targets but take part in the log-sum-exp); each
package's model forward is replaced by one that returns them, so the
loss alone is compared:

* on a (1, 4) mesh (vocab over "model" in 4) and a (2, 2) mesh (rows over
  "data", vocab over "model" in 2), masked and unmasked: the loss within
  1e-5 of the reference's, and its gradient by the logits within 1e-5 of
  the largest |value| of the reference's;
* on (1, 4) the widest tensor any op of the loss's forward and backward
  makes on a rank has V/4 columns: no (B, S, V) tensor, fp32 or one-hot,
  is whole on a rank.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.models import zoo as ref_zoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
B, S = 4, 8
VOCAB = 500                       # padded to 512
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
CASES = [(m, masked) for m in MESHES for masked in (False, True)]

WORKER = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

out = sys.argv[1]
rank = int(os.environ["RANK"])
dist.init_process_group("gloo")
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config
from repro_torch.hw.cost import CostCounter, tensor_leaves
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import zoo

z = np.load(os.path.join(out, "inputs.npz"))
cfg = get_config("olmo-1b", smoke=True)
logits_np = z["logits"]


class Widest(CostCounter):
    """A counter that also keeps the widest last dim of any 3-dim tensor
    an op makes on this rank."""
    widest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        res = super().__torch_dispatch__(func, types, args, kwargs)
        if res is not NotImplemented:
            for t in tensor_leaves(res, []):
                if t.ndim == 3:
                    self.widest = max(self.widest, t.shape[-1])
        return res


report = {}
for name, shape in json.loads(sys.argv[2]).items():
    mesh = make_mesh(tuple(shape), ("data", "model"), device_type="cpu")
    rows = Shard(0) if shape[0] > 1 else Replicate()
    logits = distribute_tensor(torch.from_numpy(logits_np), mesh,
                               (rows, Shard(2))).requires_grad_(True)
    zoo.forward = lambda cfg, params, batch, **kw: (
        logits, torch.zeros((), dtype=torch.float32))
    for masked in (False, True):
        batch = {"tokens": None, "targets": distribute_tensor(
            torch.from_numpy(z["targets"]).long(), mesh, (rows, Replicate()))}
        if masked:
            batch["mask"] = distribute_tensor(
                torch.from_numpy(z["mask"]), mesh, (rows, Replicate()))
        with implicit_replication(), Widest() as spy:
            loss, _ = zoo.loss_fn(cfg, {}, batch)
            (grad,) = torch.autograd.grad(loss, [logits])
        full = grad.full_tensor().numpy()
        if rank == 0:
            np.save(os.path.join(out, f"grad_{name}_{masked}.npy"), full)
        report[f"{name}/{masked}"] = {
            "loss": float(loss.full_tensor()), "widest": spy.widest,
            "local": list(logits.to_local().shape),
            "grad_placements": str(grad.placements)}
if rank == 0:
    with open(os.path.join(out, "report.json"), "w") as f:
        json.dump(report, f)
dist.destroy_process_group()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _reference(logits, targets, mask):
    """The reference's ``loss_fn`` and its gradient by the logits, its
    forward replaced by one that returns them."""
    cfg = ref_get_config("olmo-1b", smoke=True)
    saved = ref_zoo.forward
    ref_zoo.forward = lambda cfg, params, batch: (params["logits"],
                                                  jnp.float32(0.0))
    try:
        def loss(params):
            batch = {"targets": jnp.asarray(targets)}
            if mask is not None:
                batch["mask"] = jnp.asarray(mask)
            return ref_zoo.loss_fn(cfg, params, batch)[0]
        value, grad = jax.value_and_grad(loss)(
            {"logits": jnp.asarray(logits)})
    finally:
        ref_zoo.forward = saved
    return float(value), np.asarray(grad["logits"])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("vocab_parallel")
    rng = np.random.default_rng(0)
    padded = -(-VOCAB // 256) * 256
    assert padded > VOCAB
    logits = (4.0 * rng.standard_normal((B, S, padded))).astype(np.float32)
    targets = rng.integers(0, VOCAB, size=(B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32)
    np.savez(out / "inputs.npz", logits=logits, targets=targets, mask=mask)
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": str(RANKS), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(WORKER), str(out),
         json.dumps(MESHES)],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        stdin=subprocess.DEVNULL) for r in range(RANKS)]
    try:
        ref = {masked: _reference(logits, targets, mask if masked else None)
               for masked in (False, True)}
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-4000:]}"
    with open(out / "report.json") as f:
        report = json.load(f)
    return {"report": report, "ref": ref, "out": out, "padded": padded}


@pytest.mark.parametrize("mesh,masked", CASES)
def test_vocab_parallel_loss_matches_reference(run, mesh, masked):
    rep = run["report"][f"{mesh}/{masked}"]
    ref_loss, ref_grad = run["ref"][masked]
    assert abs(rep["loss"] - ref_loss) <= 1e-5, (rep, ref_loss)
    grad = np.load(run["out"] / f"grad_{mesh}_{masked}.npy")
    scale = float(np.max(np.abs(ref_grad)))
    gap = float(np.max(np.abs(grad - ref_grad)))
    assert gap <= 1e-5 * scale, (gap, scale)
    # the logits' gradient keeps their split: rows over "data" where the
    # mesh has them, vocab over "model"
    rows = "Shard(dim=0)" if MESHES[mesh][0] > 1 else "Replicate()"
    assert rep["grad_placements"] == f"({rows}, Shard(dim=2))", rep


@pytest.mark.parametrize("masked", [False, True])
def test_no_rank_holds_the_whole_vocab(run, masked):
    rep = run["report"][f"1x4/{masked}"]
    assert rep["local"] == [B, S, run["padded"] // 4]
    assert rep["widest"] == run["padded"] // 4, rep
