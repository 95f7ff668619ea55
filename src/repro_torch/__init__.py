"""PyTorch/CUDA port of the ``repro`` model stack, for one NVIDIA H100.

The JAX package ``repro`` stays the reference: this package imports
neither it nor JAX, keeps its own copy of what it needs, and mirrors its
module names (``models/``, ``configs/``, ``kernels/``, ``serving/``,
``launch/``).  Kernels that were Pallas TPU kernels there are CUDA C++
kernels here, built at first use (``kernels/_build.py``).

Entry points take a ``device`` that defaults to ``"cuda"`` and never fall
back to the CPU on their own: a caller that wants the CPU asks for it.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is present (no silent fall-back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


__all__ = ["resolve_device"]
