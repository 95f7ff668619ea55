"""Deterministic KNL-like machine model — the cost oracle for the faithful
op-graph reproduction.

The paper measures wall-time of TF ops on a 68-core Knights Landing socket.
This container has one CPU core, so the *timing function* is modeled; every
scheduling/modeling decision downstream of the timing function is computed
by the real reimplemented algorithms (hill climbing, strategies 1-4).

The model reproduces the qualitative structure the paper reports:

* concave speedup with an interior optimum thread count (Fig 1 /
  Observation 1): Amdahl serial fraction + per-thread spawn/management
  overhead + bandwidth saturation;
* optimum grows with input size (Table II / Observation 2): bigger ops
  amortize spawn overhead further;
* cache-sharing affinity matters (paper §III-B): when two threads of a tile
  share data and the per-tile working set fits L2, traffic drops; when it
  does not fit, sharing thrashes;
* hyper-threads help only co-run throughput, not single-op latency
  (Table III: +3% co-run with HT vs +38% with core partitioning);
* co-running ops contend for MCDRAM bandwidth (§III-D interference).

A small deterministic "measurement jitter" (hash-seeded, ±1.5%) makes the
hill-climb/interpolation accuracy numbers honest rather than trivially 100%.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Iterable

from repro_torch.core.graph import Op
from repro_torch.hw.spec import KNL, KnlLikeSpec


@dataclasses.dataclass(frozen=True)
class Placement:
    """How an op's threads are placed (the paper's two affinity variants)."""

    threads: int
    cache_sharing: bool = True      # two threads per tile vs one per tile
    hyper_thread: bool = False      # running on the 2nd HW thread lane (S4)

    def cores_used(self, spec: KnlLikeSpec) -> int:
        if self.hyper_thread:
            return 0                # borrows busy cores' spare HW threads
        if self.cache_sharing:
            return self.threads     # 2 threads/tile => threads/2 tiles
        return self.threads         # 1 thread/tile, tile-exclusive cores


class SimMachine:
    """Deterministic cost oracle: time(op, placement, contention)."""

    def __init__(self, spec: KnlLikeSpec = KNL, jitter: float = 0.015,
                 seed: int = 0):
        self.spec = spec
        self.jitter = jitter
        self.seed = seed

    @property
    def fingerprint(self) -> tuple:
        """Identity of the timing function: curves measured on one machine
        are only valid on a machine with the same fingerprint (used by the
        cross-job PlanCache to refuse cross-machine reuse)."""
        return (self.spec, self.jitter, self.seed)

    # ------------------------------------------------------------------
    def _jitter_factor(self, op: Op, placement: Placement) -> float:
        if self.jitter == 0.0:
            return 1.0
        key = f"{self.seed}:{op.op_class}:{op.input_shape}:" \
              f"{placement.threads}:{placement.cache_sharing}"
        h = zlib.crc32(key.encode()) / 0xFFFFFFFF
        return 1.0 + self.jitter * math.sin(2 * math.pi * h)

    def _effective_bandwidth(self, threads: int, bw_share: float) -> float:
        # MCDRAM saturates around ~16 streams; share models co-run contention.
        sat = min(1.0, threads / 16.0 + 0.15)
        return self.spec.mcdram_bandwidth * sat * bw_share

    def corun_bw_share(self, threads: int,
                       co_running_threads: Iterable[int]) -> float:
        """Bandwidth fraction a ``threads``-wide launch gets next to the
        given co-runners — the machine owns the contention policy so every
        scheduler (single-graph co-run, multi-tenant pool) divides MCDRAM
        the same way.  Floored at 0.25: even a narrow op keeps a minimum
        stream share (MCDRAM is not perfectly fair-queued)."""
        total = threads + sum(co_running_threads)
        return max(0.25, threads / max(total, 1))

    def quadrant_bw_share(
            self, cores: tuple[int, ...],
            co_running: Iterable[tuple[int, tuple[int, ...]]]) -> float:
        """Topology-aware replacement for ``corun_bw_share``: bandwidth
        fraction of a launch PLACED on concrete core ids, next to
        co-runners given as ``(threads, cores)`` pairs.

        MCDRAM pages stay interleaved machine-wide (quadrant clustering
        localizes the tag directory, not the memory), so the BASE share is
        the same fair split as the flat rule — a solo launch gets 1.0
        whatever its placement.  The topology modulates the base per
        thread: a thread in a quadrant no co-runner occupies keeps its
        directory traffic home and recovers the all-to-all conflict waste
        (``spec.quadrant_local_boost``, calibrated to the paper's Table
        III core-partitioning gain), while a thread in a CONTESTED
        quadrant — one that co-runners also occupy — pays
        ``spec.cross_quadrant_penalty``, the cross-quadrant co-run the
        placement policy exists to avoid.  The blend is the per-core
        weighted mean, so the share degrades smoothly with how much of
        the launch overlaps foreign traffic.  Unplaced co-runners
        (hyper-thread-lane launches) count toward the fair split — their
        streams are real — but contest no quadrant: they have no pinned
        placement, just time-sliced spare HW threads at 0.55 efficiency,
        so they don't drag a placed launch's directory traffic off its
        home quadrant."""
        spec = self.spec
        mine: dict[int, int] = {}
        for c in cores:
            q = spec.quadrant_of_core(c)
            mine[q] = mine.get(q, 0) + 1
        my_threads = len(cores)
        other_threads = 0
        contested: set[int] = set()
        for threads, other in co_running:
            other_threads += len(other) if other else threads
            if other:
                contested |= ({spec.quadrant_of_core(c) for c in other}
                              & set(mine))
        share = max(0.25, my_threads / max(my_threads + other_threads, 1))
        locality = sum(
            (m / my_threads) * (spec.cross_quadrant_penalty
                                if q in contested
                                else spec.quadrant_local_boost)
            for q, m in mine.items()) if my_threads else 1.0
        return min(1.0, share * locality)

    def op_time(self, op: Op, placement: Placement, *,
                bw_share: float = 1.0) -> float:
        """Seconds to execute ``op`` under ``placement``.

        ``bw_share`` in (0,1]: fraction of memory bandwidth available
        (co-run contention, computed by the scheduler from concurrent load).
        """
        p = max(1, placement.threads)
        spec = self.spec
        if not placement.hyper_thread:
            p = min(p, spec.cores)

        # --- compute: bounded-parallelism Amdahl + sync serialization ----
        # an op only exposes ceil(elems/chunk) independent work chunks
        # (MKL-DNN loop blocking), so threads beyond p_max add overhead but
        # no speedup: the curve decreases to p_max, then rises gently —
        # the paper's Fig 1 shape, with Table II's size-dependent optimum.
        elems = 1.0
        for d in op.input_shape:
            elems *= d
        p_max = max(1, int(-(-elems // spec.chunk_elems)))
        eff = spec.hyper_thread_efficiency if placement.hyper_thread else 1.0
        p_used = min(p * eff, p_max)
        t1 = op.flops / spec.core_flops
        f = op.parallel_fraction
        sigma = spec.sync_serialization
        t_comp = t1 * (1.0 - f) + t1 * f * ((1.0 - sigma) / p_used + sigma)

        # --- memory traffic ----------------------------------------------
        traffic = op.bytes_moved
        if placement.cache_sharing and p >= 2:
            # two threads/tile share the tile's 1MB L2
            per_tile_ws = op.working_set / max(1, p // 2)
            if per_tile_ws <= spec.l2_bytes_per_tile:
                traffic *= 0.62          # reuse hits in shared L2
            else:
                traffic *= 1.12          # thrash: two working sets, one L2
        t_mem = traffic / self._effective_bandwidth(p, bw_share)

        # --- thread management overhead (spawn/bind), paper §III-D -------
        t_spawn = p * spec.thread_spawn_us * 1e-6

        return (t_comp + t_mem + t_spawn) * self._jitter_factor(op, placement)

    # ------------------------------------------------------------------
    def best_time_exhaustive(self, op: Op, max_threads: int | None = None
                             ) -> tuple[float, Placement]:
        """Ground-truth optimum by scanning every (threads, sharing) case —
        the oracle the model-accuracy benchmarks compare against."""
        max_threads = max_threads or self.spec.cores
        best: tuple[float, Placement] | None = None
        for sharing in (False, True):
            for t in self.thread_cases(sharing, max_threads):
                pl = Placement(t, cache_sharing=sharing)
                dt = self.op_time(op, pl)
                if best is None or dt < best[0]:
                    best = (dt, pl)
        assert best is not None
        return best

    def thread_cases(self, cache_sharing: bool, max_threads: int | None = None
                     ) -> list[int]:
        """The paper's 68 prediction cases: 34 no-sharing (1 thread/tile,
        1..34) + 34 sharing (even counts 2..68)."""
        max_threads = max_threads or self.spec.cores
        if cache_sharing:
            return [t for t in range(2, max_threads + 1, 2)]
        return [t for t in range(1, self.spec.tiles + 1) if t <= max_threads]

    # ------------------------------------------------------------------
    # Synthetic "hardware counter" features for the regression baseline.
    # Deterministic functions of the op's analytic profile, normalized by
    # instruction count (as the paper normalizes) — plus hash noise at the
    # magnitude the paper blames for counter inaccuracy.
    # ------------------------------------------------------------------
    def counters(self, op: Op, threads: int) -> dict[str, float]:
        instrs = max(op.flops / 4.0, 1.0)
        cycles = (op.flops / self.spec.core_flops) * 1.3e9 / max(threads, 1)
        llc_acc = op.bytes_moved / 64.0
        fit = min(1.0, self.spec.l2_bytes_per_tile /
                  max(op.working_set / max(threads // 2, 1), 1.0))
        llc_miss = llc_acc * (1.0 - 0.55 * fit)
        l1_hit = instrs * (0.6 + 0.3 * fit)
        noise_key = f"cnt:{self.seed}:{op.uid}:{threads}"
        noise = 1.0 + 0.08 * math.sin(
            2 * math.pi * zlib.crc32(noise_key.encode()) / 0xFFFFFFFF)
        return {
            "cycles_per_instr": cycles / instrs * noise,
            "llc_miss_per_instr": llc_miss / instrs * noise,
            "llc_acc_per_instr": llc_acc / instrs,
            "l1_hit_per_instr": l1_hit / instrs,
        }
