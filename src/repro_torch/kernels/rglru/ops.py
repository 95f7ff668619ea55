"""Public wrapper of the RG-LRU kernel.

A CUDA tensor goes to the hand-written kernel (``csrc/rglru.cu``) or to
an exception; a CPU tensor goes to the plain version
(``ref.rglru_plain``); a meta tensor under a ``hw.cost.CostCounter`` gets
meta outputs and adds ``cost`` to the count (the dry-run), and raises
otherwise.  ``rglru.launches`` counts the kernel launches, so
a run can show its path went through the kernel.  The kernel is
forward-only; where autograd needs the gradient, ``_grad.KernelFn``'s
backward recomputes ``rglru_plain`` on the saved inputs and returns its
vector-Jacobian product.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.hw import cost as _cost
from repro_torch.kernels import _build
from repro_torch.kernels._grad import KernelFn, needs_grad
from repro_torch.kernels.rglru.ref import rglru_plain

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("rglru")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_rglru_fwd.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.repro_rglru_fwd.restype = i
    lib.repro_rglru_error_string.argtypes = [i]
    lib.repro_rglru_error_string.restype = ctypes.c_char_p
    return lib


def _check(a: torch.Tensor, x: torch.Tensor) -> None:
    if a.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"rglru: a {tuple(a.shape)} and x {tuple(x.shape)} "
                         "must be the same (B,S,R)")
    if min(a.shape) < 1:
        raise ValueError(f"rglru: empty shape {tuple(a.shape)}")
    if a.dtype not in _DTYPE_CODES or x.dtype != a.dtype:
        raise TypeError(f"rglru: dtypes {a.dtype}, {x.dtype}; the kernel "
                        "takes float32 or bfloat16, the same for a and x")
    if a.device != x.device:
        raise ValueError(f"rglru: a on {a.device}, x on {x.device}")
    if not (a.is_contiguous() and x.is_contiguous()):
        raise ValueError("rglru: a and x must be contiguous")


def rglru(a: torch.Tensor, x: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """a, x: (B,S,R), a in (0,1), any S >= 1.  Returns (h (B,S,R) in x's
    dtype, h_last (B,R) float32), the scan from h = 0."""
    if a.device.type == "cpu":
        return rglru_plain(a, x)
    if a.device.type == "cuda":
        launch = _launch
    elif _cost.counts_meta(a):
        launch = _counted
    else:
        raise ValueError(f"rglru: no kernel for device {a.device}")
    _check(a, x)
    if needs_grad(a, x):
        return KernelFn.apply(launch, rglru_plain, {}, a, x)
    return launch(a, x)


def cost(b: int, s: int, r: int, dtype: torch.dtype = torch.bfloat16
         ) -> dict:
    """The least work of one call: 7 fp32 operations an element (a·a,
    1−, max, sqrt, ·x, a·h, +) outside the tensor cores; a and x read
    once, h written once, h_last (fp32) written once."""
    n = b * s * r
    size = torch.finfo(dtype).bits // 8
    return {"flops": 7.0 * n, "bytes": float(3 * n * size + b * r * 4),
            "peak_class": "float32"}


def _counted(a: torch.Tensor, x: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's outputs on meta, its cost added to the counter."""
    b, s, r = a.shape
    h = torch.empty_like(x)
    h_last = torch.empty((b, r), dtype=torch.float32, device=x.device)
    _cost.current().add_kernel("rglru", **cost(b, s, r, x.dtype))
    return h, h_last


def _launch(a: torch.Tensor, x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One counted launch of the kernel on inputs that passed ``_check``."""
    b, s, r = a.shape
    h = torch.empty_like(x)
    h_last = torch.empty((b, r), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(a.device):
        err = lib.repro_rglru_fwd(
            a.data_ptr(), x.data_ptr(), h.data_ptr(), h_last.data_ptr(),
            _DTYPE_CODES[a.dtype], b, s, r,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("rglru launch failed: "
                           + lib.repro_rglru_error_string(err).decode())
    _build.count_launch(rglru)
    return h, h_last


rglru.launches = 0
