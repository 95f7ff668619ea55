"""Fault tolerance: heartbeat, straggler detection, checkpoint-retry loop.

The port's own copy of ``repro.train.fault`` (standard library only; the
port imports nothing of ``repro``).

Scope note: in-process mechanisms are fully implemented
and tested — what belongs to the cluster manager (re-scheduling a dead
host, swapping hardware) is exposed as policy decisions
(``StragglerMonitor.decide``) the manager consumes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable


class Heartbeat:
    """Periodic liveness file: {step, time}.  A watchdog (or another
    host) treats staleness > timeout as failure."""

    def __init__(self, path: str, interval_s: float = 10.0):
        self.path = path
        self.interval_s = interval_s
        self._last = 0.0

    def beat(self, step: int, force: bool = False) -> None:
        now = time.time()
        if not force and now - self._last < self.interval_s:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": now}, f)
        os.rename(tmp, self.path)
        self._last = now

    @staticmethod
    def is_stale(path: str, timeout_s: float) -> bool:
        if not os.path.exists(path):
            return True
        with open(path) as f:
            return time.time() - json.load(f)["time"] > timeout_s


@dataclasses.dataclass
class StragglerMonitor:
    """Per-host step-time EMA + z-score flagging.

    observe() ingests per-host step times (from an allgather in real
    deployments); decide() emits the mitigation policy:
      - "exclude": host consistently beyond z_threshold -> re-mesh without it
      - "watch":   transient slowness
    """

    z_threshold: float = 3.0
    ema_alpha: float = 0.2
    min_observations: int = 5
    consecutive_to_exclude: int = 3
    min_relative_excess: float = 0.2   # must also be >20% over median

    def __post_init__(self) -> None:
        self._ema: dict[str, float] = {}
        self._count: dict[str, int] = {}
        self._flags: dict[str, int] = {}

    def observe(self, host_times: dict[str, float]) -> dict[str, str]:
        for h, t in host_times.items():
            prev = self._ema.get(h, t)
            self._ema[h] = (1 - self.ema_alpha) * prev + self.ema_alpha * t
            self._count[h] = self._count.get(h, 0) + 1

        out: dict[str, str] = {}
        # flag on THIS round's raw times (an EMA would keep flagging a
        # host for many rounds after one transient spike); robust
        # median/MAD stats so a single straggler cannot inflate its own
        # detection threshold, plus a relative floor so sub-20% jitter
        # never flags even when MAD ~ 0
        vals = sorted(host_times.values())
        if len(vals) < 2:
            return out
        mid = len(vals) // 2
        median = (vals[mid] if len(vals) % 2
                  else 0.5 * (vals[mid - 1] + vals[mid]))
        devs = sorted(abs(v - median) for v in vals)
        mad = (devs[mid] if len(devs) % 2
               else 0.5 * (devs[mid - 1] + devs[mid]))
        scale = max(1.4826 * mad, 1e-9)
        for h, v in host_times.items():
            if self._count[h] < self.min_observations:
                continue
            z = (v - median) / scale
            if v < median * (1.0 + self.min_relative_excess):
                z = 0.0
            if z > self.z_threshold:
                self._flags[h] = self._flags.get(h, 0) + 1
                out[h] = ("exclude"
                          if self._flags[h] >= self.consecutive_to_exclude
                          else "watch")
            else:
                self._flags[h] = 0
        return out

    def healthy_hosts(self, hosts: list[str]) -> list[str]:
        return [h for h in hosts
                if self._flags.get(h, 0) < self.consecutive_to_exclude]


@dataclasses.dataclass
class RecoveryStats:
    failures: int = 0
    restores: int = 0
    steps_replayed: int = 0


def run_with_recovery(step_fn: Callable, state, *, n_steps: int,
                      save_every: int, manager, data_prefetch=None,
                      max_failures: int = 5,
                      on_metrics: Callable | None = None
                      ) -> tuple[object, RecoveryStats]:
    """Drive (state, batch) -> (state, metrics) with checkpoint/restore.

    Any exception from step_fn triggers restore-from-latest and replay.
    ``data_prefetch`` must expose .next()/.state()/.cursor and a
    ``source.batch_at(step)`` for deterministic replay."""
    stats = RecoveryStats()
    step = 0
    while step < n_steps:
        try:
            if data_prefetch is not None:
                batch = data_prefetch.source.batch_at(step)
            else:
                batch = None
            state, metrics = step_fn(state, batch, step)
            if on_metrics is not None:
                on_metrics(step, metrics)
            step += 1
            if save_every and step % save_every == 0:
                manager.save(step, state,
                             extra={"data_cursor": step})
        except Exception:
            stats.failures += 1
            if stats.failures > max_failures:
                raise
            restored = manager.restore()
            if restored is None:
                # no checkpoint yet: restart from scratch
                stats.steps_replayed += step
                step = 0
                continue
            state, extra, ck_step = restored
            stats.restores += 1
            stats.steps_replayed += max(0, step - ck_step)
            step = ck_step
    manager.wait()
    return state, stats
