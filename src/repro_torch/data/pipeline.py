"""Data pipeline: deterministic synthetic LM stream + mmap token files,
per-host sharding, background prefetch.

The port's own copy of ``repro.data.pipeline`` (numpy and threads only;
the port imports nothing of ``repro``): the same batches for the same
(seed, step, host), which ``tests/test_torch_train.py`` pins.

Determinism contract: ``SyntheticLM(seed, ...)`` yields the same global
batch sequence regardless of host count; each host materializes only its
slice (``host_id/num_hosts``), so elastic restarts resume bit-identically
from a (seed, step) cursor — the cursor is what the checkpoint stores.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0
    kind: str = "synthetic"       # synthetic | mmap
    path: str | None = None       # token file for kind="mmap" (uint16/32)
    frontend_tokens: int = 0      # >0: also emit stub modality embeddings
    d_model: int = 0


class SyntheticLM:
    """Seeded Zipf-ish token stream with enough structure that loss can
    actually decrease (n-gram correlations), generated per (step, host)."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, num_hosts: int = 1):
        assert cfg.global_batch % num_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts
        # Zipf-like unigram distribution
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = 1.0 / ranks
        self.probs = (probs / probs.sum()).astype(np.float64)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.host_id]))
        shape = (self.local_batch, cfg.seq_len + 1)
        base = rng.choice(cfg.vocab, size=shape, p=self.probs)
        # inject bigram structure: every even position partially predicts
        # the next token (so training has signal)
        follow = (base * 31 + 7) % cfg.vocab
        m = rng.random(shape) < 0.35
        base[:, 1:] = np.where(m[:, 1:], follow[:, :-1], base[:, 1:])
        out = {
            "tokens": base[:, :-1].astype(np.int32),
            "targets": base[:, 1:].astype(np.int32),
        }
        if cfg.frontend_tokens:
            fr = rng.standard_normal(
                (self.local_batch, cfg.frontend_tokens, cfg.d_model)) * 0.02
            out["frontend"] = fr.astype(np.float32)
        return out

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class MmapTokens:
    """Memory-mapped flat token file, strided into (batch, seq+1) windows.

    Window assignment is a seeded permutation over document offsets so
    epochs reshuffle deterministically."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, num_hosts: int = 1):
        assert cfg.path is not None
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts
        self.tokens = np.memmap(cfg.path, dtype=np.uint16, mode="r")
        self.n_windows = (len(self.tokens) - 1) // cfg.seq_len
        if self.n_windows < cfg.global_batch:
            raise ValueError("token file too small for one global batch")

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        epoch = (step * cfg.global_batch) // self.n_windows
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, epoch]))
        perm = rng.permutation(self.n_windows)
        start = (step * cfg.global_batch) % self.n_windows
        idx = perm[(start + np.arange(cfg.global_batch)) % self.n_windows]
        idx = idx[self.host_id::self.num_hosts][:self.local_batch]
        rows = np.stack([
            self.tokens[i * cfg.seq_len: i * cfg.seq_len + cfg.seq_len + 1]
            for i in idx]).astype(np.int32)
        return {"tokens": rows[:, :-1] % cfg.vocab,
                "targets": rows[:, 1:] % cfg.vocab}


def make_source(cfg: DataConfig, host_id: int = 0, num_hosts: int = 1):
    if cfg.kind == "synthetic":
        return SyntheticLM(cfg, host_id, num_hosts)
    if cfg.kind == "mmap":
        return MmapTokens(cfg, host_id, num_hosts)
    raise ValueError(cfg.kind)


class Prefetcher:
    """Background-thread prefetch with a bounded queue.

    ``cursor`` tracks the next step to produce; ``state()`` returns the
    resume cursor to store in checkpoints."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.cursor = start_step
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        step = self.cursor
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> dict[str, np.ndarray]:
        step, batch = self._q.get()
        self.cursor = step + 1
        return batch

    def state(self) -> dict:
        return {"cursor": self.cursor}

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
