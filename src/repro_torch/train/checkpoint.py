"""Checkpointing in the reference's on-disk format, async, atomic.

Port of ``repro.train.checkpoint``, writing and reading the same files:

    ckpt_dir/step_00000100/
        arrays.npz          (flat "/" path -> array, logical values)
        manifest.json       (step, paths with [shape, dtype string], extra,
                             time)
    ckpt_dir/LATEST         (atomic pointer file)

so a checkpoint saved by either package restores in the other.  The
state is copied to the host synchronously and written on a background
thread; ``LATEST`` is renamed into place only after an fsync'd write, so a
crash mid-save never corrupts the restore point; ``keep_last_k`` removes
older steps.

bfloat16 leaves: numpy has no bfloat16 of its own.  The reference saves
``ml_dtypes.bfloat16`` arrays, which ``np.savez`` writes as 2-byte void
(``|V2``) and ``np.load`` hands back as such; only the manifest's dtype
string says "bfloat16".  The port writes a bf16 tensor's bits the same
way (its ``uint16`` view, stored as ``|V2``) and, on restore, reads any
leaf whose manifest dtype is "bfloat16" back through a ``uint16`` view,
so neither direction needs ``ml_dtypes``.

Sharded state (DTensors): ``save`` gathers each leaf's full value
(``full_tensor``, a collective every rank of the mesh joins) and rank 0
writes; the save is then synchronous and ends in a barrier, so that every
rank may restore right after it.  ``restore(shardings=tree)`` places each
leaf on the mesh and placements of its ``sharding.NamedSharding``: saved
on one mesh shape, a state restores onto another (elastic restart).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.models.common import is_dtensor, tree_map

SEP = "/"
_BF16 = "bfloat16"


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as the numpy array the reference would save for it (a
    DTensor's full value)."""
    if is_dtensor(t):
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _dtype_name(a: np.ndarray) -> str:
    return _BF16 if a.dtype == np.dtype("V2") else str(a.dtype)


def _tensor(a: np.ndarray, dtype_name: str, device: torch.device
            ) -> torch.Tensor:
    """A restored leaf as a tensor on ``device``, bfloat16 by its bits."""
    if dtype_name == _BF16:
        bits = torch.from_numpy(np.asarray(a).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.asarray(a)).to(device)


def _flatten(tree, prefix="") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{SEP}"))
        return out
    out[prefix.rstrip(SEP)] = tree
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, val in flat.items():
        node = tree
        parts = path.split(SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


class CheckpointManager:
    """Saves to and restores from ``directory``; a restored state's
    tensors land on ``device`` (the device the train state lives on), or,
    with ``shardings``, on their meshes, so a recovery loop that restores
    without naming either resumes where it ran."""

    def __init__(self, directory: str, keep_last_k: int = 3,
                 device: str | torch.device = "cpu", shardings=None):
        self.directory = directory
        self.keep = keep_last_k
        self.device = torch.device(device)
        self.shardings = shardings
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, state: dict, extra: dict | None = None,
             block: bool = False) -> None:
        """Async save.  Copies the state to the host synchronously (the
        copy waits for the device), writes on a background thread.  A
        sharded state is gathered, written by rank 0 alone, and saved
        synchronously up to a barrier of every rank."""
        self.wait()
        flat = {k: _host(v) for k, v in _flatten(state).items()}
        extra = dict(extra or {})
        sharded = any(is_dtensor(v) for v in _flatten(state).values())
        if sharded:
            import torch.distributed as dist
            if dist.get_rank() != 0:
                dist.barrier()
                return

        def write():
            tag = f"step_{step:08d}"
            tmp = os.path.join(self.directory, f".tmp_{tag}_{time.time_ns()}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            manifest = {
                "step": step,
                "paths": {k: [list(v.shape), _dtype_name(v)]
                          for k, v in flat.items()},
                "extra": extra,
                "time": time.time(),
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            final = os.path.join(self.directory, tag)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            with open(os.path.join(self.directory, ".LATEST_tmp"), "w") as f:
                f.write(tag)
                f.flush()
                os.fsync(f.fileno())
            os.rename(os.path.join(self.directory, ".LATEST_tmp"),
                      os.path.join(self.directory, "LATEST"))
            self._gc()

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if block or sharded:
            self.wait()
        if sharded:
            dist.barrier()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.directory)
                       if d.startswith("step_"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, d),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def latest_step(self) -> int | None:
        ptr = os.path.join(self.directory, "LATEST")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            tag = f.read().strip()
        path = os.path.join(self.directory, tag, "manifest.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)["step"]

    def restore(self, step: int | None = None,
                device: str | torch.device | None = None, shardings=None
                ) -> tuple[dict, dict, int] | None:
        """Returns (state, extra, step) with the state's tensors on
        ``device`` (the manager's own by default), or None if there is no
        checkpoint.  ``shardings`` (the manager's own by default): a tree
        of ``sharding.NamedSharding`` of the state's structure; each leaf
        becomes a DTensor on its mesh and placements, whatever mesh the
        state was saved from.  A save still being written lands first, so
        a restore right after ``save`` (``run_with_recovery`` after a
        failure) reads it back."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        base = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(base, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(base, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        dev = self.device if device is None else torch.device(device)
        shardings = self.shardings if shardings is None else shardings
        if shardings is not None:
            from repro_torch.sharding import distribute_tree
            state = tree_map(
                lambda path, a: _tensor(a, manifest["paths"][path][1],
                                        torch.device("cpu")),
                _unflatten(flat))
            state = distribute_tree(state, shardings)
        else:
            state = tree_map(
                lambda path, a: _tensor(a, manifest["paths"][path][1], dev),
                _unflatten(flat))
        return state, manifest.get("extra", {}), manifest["step"]
