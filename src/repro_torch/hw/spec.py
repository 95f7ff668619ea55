"""Hardware constants of one NVIDIA H100 and the roofline arithmetic.

The port's counterpart of ``repro.hw.spec.TpuV5eSpec``: the peak rates
are the data sheet's (SXM part, dense, at the full 700 W power limit); the
name, memory size and SM count can be read from the card
(``H100Spec.from_device``).  ``compute_time`` takes flops by peak class,
because one H100 step mixes classes 15 times apart in rate: bf16 on the
tensor cores, fp32 GEMMs (TF32 on the tensor cores only where
``torch.backends.cuda.matmul.allow_tf32`` is set) and fp32 outside them.
``KnlLikeSpec`` (a copy of the reference's) models the paper's Knights
Landing socket for the scheduling stack's cost oracle
(``core.simmachine``); it is never used for the card's roofline.
``ClusterSpec`` (also the reference's) groups such machines for the
cluster layer.
"""

from __future__ import annotations

import dataclasses

import torch

# NVIDIA H100 SXM data sheet, dense rates without sparsity
H100_PEAK_BF16_FLOPS = 989e12      # bf16 and fp16 on the tensor cores
H100_PEAK_TF32_FLOPS = 494.7e12    # fp32 GEMMs as TF32 on the tensor cores
H100_PEAK_FP32_FLOPS = 67e12       # fp32 outside the tensor cores
H100_HBM_BYTES_PER_S = 3.35e12     # HBM3
H100_HBM_BYTES = 80 * 10**9
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class H100Spec:
    """One NVIDIA H100: the three roofline terms of a step on it."""

    name: str = "h100_sxm"
    peak_bf16_flops: float = H100_PEAK_BF16_FLOPS
    peak_tf32_flops: float = H100_PEAK_TF32_FLOPS
    peak_fp32_flops: float = H100_PEAK_FP32_FLOPS
    hbm_bandwidth: float = H100_HBM_BYTES_PER_S
    hbm_bytes: int = H100_HBM_BYTES
    sms: int = H100_SMS

    @classmethod
    def from_device(cls, dev: int | str | torch.device = 0) -> "H100Spec":
        """The card's name, memory and SM count from
        ``torch.cuda.get_device_properties``; the peak rates stay the
        data sheet's (no API reports them)."""
        props = torch.cuda.get_device_properties(dev)
        return cls(name=props.name, hbm_bytes=int(props.total_memory),
                   sms=int(props.multi_processor_count))

    def peak(self, peak_class: str) -> float:
        """FLOP/s of one peak class: the dtype of a GEMM or of a kernel's
        arithmetic, or "tfloat32" for an fp32 GEMM run as TF32."""
        return {"bfloat16": self.peak_bf16_flops,
                "float16": self.peak_bf16_flops,
                "tfloat32": self.peak_tf32_flops,
                "float32": self.peak_fp32_flops}[peak_class]

    # ---- roofline terms (seconds) -------------------------------------
    def compute_time(self, flops_by_class: dict[str, float]) -> float:
        """Each class's flops at its own peak, one class after another
        (eager PyTorch runs one kernel at a time)."""
        return sum(f / self.peak(c) for c, f in flops_by_class.items())

    def memory_time(self, bytes_per_device: float) -> float:
        return bytes_per_device / self.hbm_bandwidth

    def collective_time(self, ici_bytes_per_device: float,
                        dci_bytes_per_device: float = 0.0) -> float:
        """Kept as the reference's; one card moves nothing between cards,
        so every caller passes 0 until the multi-device slice."""
        if ici_bytes_per_device or dci_bytes_per_device:
            raise NotImplementedError(
                "collective_time: link rates arrive with the port's "
                "multi-device slice")
        return 0.0


H100 = H100Spec()


@dataclasses.dataclass(frozen=True)
class KnlLikeSpec:
    """Machine model for the paper's KNL socket (Xeon Phi 7250).

    Only what the scheduling reproduction needs: core/tile/HW-thread
    topology and enough bandwidth/latency structure for a convex
    time-vs-threads curve (the paper's Fig. 1 / Observation 1).
    """

    name: str = "knl_7250"
    cores: int = 68
    tiles: int = 34                       # 2 cores per tile share 1MB L2
    quadrants: int = 4                    # tiles group into mesh quadrants,
                                          # each owning 2 of the 8 MCDRAM
                                          # devices (KNL quadrant clustering)
    hw_threads_per_core: int = 4
    l2_bytes_per_tile: int = 1 * 1024**2
    mcdram_bandwidth: float = 450e9       # B/s (cache mode, ~STREAM)
    # quadrant-contained traffic skips the cross-mesh directory hop, so a
    # launch whose threads AND streams stay in one quadrant recovers the
    # bandwidth that all-to-all interleaving wastes on co-run conflicts —
    # calibrated to the paper's Table III, where core partitioning buys
    # +38% co-run throughput where hyper-threading buys +3%
    quadrant_local_boost: float = 1.38
    # a launch straddling INTO a quadrant that other ops occupy pays the
    # cross-quadrant contention premium per contested quadrant
    cross_quadrant_penalty: float = 0.85
    core_flops: float = 41.6e9            # 2x AVX-512 FMA @ ~1.3GHz
    thread_spawn_us: float = 4.0          # per-op thread wake/sync overhead
    sync_serialization: float = 0.005     # per-thread serialized sync share
    chunk_elems: int = 30000              # elems per independent work chunk:
                                          # an op with E elems exposes at most
                                          # ceil(E/chunk_elems) useful threads
                                          # (MKL-DNN loop-blocking structure)
    hyper_thread_efficiency: float = 0.55 # 2nd HW thread relative throughput
    restart_waste: float = 0.30           # fraction of a preempted op's
                                          # partial core-seconds charged as
                                          # waste: checkpoint-free preemption
                                          # discards the partial result, but
                                          # the fair-share ledger should not
                                          # bill the victim full price for
                                          # work the SCHEDULER threw away

    @property
    def logical_cpus(self) -> int:
        return self.cores * self.hw_threads_per_core

    # ---- topology: cores -> shared-L2 tiles -> quadrants ---------------
    # Core ids are 0..cores-1; tile t owns the shared-L2 pair (2t, 2t+1).
    # 34 tiles do not divide evenly by 4: quadrants get 9/9/8/8 tiles
    # (18/18/16/16 cores), matching the asymmetric real-chip floorplan.

    def tile_cores(self, tile: int) -> tuple[int, int]:
        """The shared-L2 core pair of one tile (cache-sharing affinity
        places both threads of a pair here — paper §III-B)."""
        return (2 * tile, 2 * tile + 1)

    @property
    def quadrant_tile_counts(self) -> tuple[int, ...]:
        base, extra = divmod(self.tiles, self.quadrants)
        return tuple(base + (1 if q < extra else 0)
                     for q in range(self.quadrants))

    def quadrant_tiles(self, quadrant: int) -> range:
        counts = self.quadrant_tile_counts
        start = sum(counts[:quadrant])
        return range(start, start + counts[quadrant])

    def quadrant_cores(self, quadrant: int) -> tuple[int, ...]:
        return tuple(c for t in self.quadrant_tiles(quadrant)
                     for c in self.tile_cores(t))

    def quadrant_of_core(self, core: int) -> int:
        tile = core // 2
        counts = self.quadrant_tile_counts
        start = 0
        for q, n in enumerate(counts):
            if tile < start + n:
                return q
            start += n
        raise ValueError(f"core {core} outside the {self.cores}-core socket")

    @property
    def quadrant_bandwidth(self) -> float:
        """Each quadrant's slice of MCDRAM (2 of the 8 devices)."""
        return self.mcdram_bandwidth / self.quadrants


KNL = KnlLikeSpec()


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """N (possibly heterogeneous) KNL-like machines behind one placement
    layer (``repro_torch.cluster``).

    The cluster model is shared-nothing: machines exchange no memory or
    bandwidth, only JOBS move between them — so each machine keeps its
    own ``KnlLikeSpec`` cost oracle and the cluster layer is pure
    routing.  ``transfer_cost_s`` is the modeled wall-clock price of
    moving one job's working set between machines; the router charges it
    (plus restart waste) through ``MovePrice`` before any cross-machine
    split or migration of started work, mirroring how the preemption
    economics price every other move in the stack."""

    machines: tuple[KnlLikeSpec, ...] = (KNL,)
    name: str = "cluster"
    transfer_cost_s: float = 0.5e-3       # per-job cross-machine move price

    def __post_init__(self):
        if not self.machines:
            raise ValueError("ClusterSpec needs at least one machine")

    @classmethod
    def homogeneous(cls, n: int, spec: KnlLikeSpec = KNL,
                    **kwargs) -> "ClusterSpec":
        return cls(machines=tuple(spec for _ in range(n)), **kwargs)

    @property
    def n_machines(self) -> int:
        return len(self.machines)

    @property
    def total_cores(self) -> int:
        return sum(m.cores for m in self.machines)

    def __len__(self) -> int:
        return len(self.machines)



def matmul_class(dtype: torch.dtype) -> str:
    """The peak class of a GEMM in ``dtype``: an fp32 GEMM runs as TF32
    where ``torch.backends.cuda.matmul.allow_tf32`` is set."""
    name = str(dtype).removeprefix("torch.")
    if name == "float32" and torch.backends.cuda.matmul.allow_tf32:
        return "tfloat32"
    return name


def dominant_term(compute_s: float, memory_s: float, collective_s: float) -> str:
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    return max(terms, key=terms.get)
