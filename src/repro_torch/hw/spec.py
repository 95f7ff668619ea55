"""Hardware constants of one NVIDIA H100 and the roofline arithmetic.

The port's counterpart of ``repro.hw.spec.TpuV5eSpec``: the peak rates
are the data sheet's (SXM part, dense, at the full 700 W power limit); the
name, memory size and SM count can be read from the card
(``H100Spec.from_device``).  ``compute_time`` takes flops by peak class,
because one H100 step mixes classes 15 times apart in rate: bf16 on the
tensor cores, fp32 GEMMs (TF32 on the tensor cores only where
``torch.backends.cuda.matmul.allow_tf32`` is set) and fp32 outside them.
``KnlLikeSpec`` and ``ClusterSpec`` belong to the scheduling stack, which
the port does not carry yet.
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
