"""Public wrapper of the WKV6 kernel.

A CUDA tensor goes to the hand-written kernel (``csrc/wkv6.cu``) or to
an exception; a CPU tensor goes to the plain version
(``ref.wkv6_plain``); a meta tensor under a ``hw.cost.CostCounter`` gets
meta outputs and adds ``cost`` to the count (the dry-run), and raises
otherwise.  ``wkv6.launches`` counts the kernel launches, so a
run can show its path went through the kernel.  The kernel is
forward-only; where autograd needs the gradient, ``_grad.KernelFn``'s
backward recomputes ``wkv6_plain`` (with the same floor, so the clip's zero
gradient below it is the same) on the saved inputs and returns its
vector-Jacobian product.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.hw import cost as _cost
from repro_torch.kernels import _build
from repro_torch.kernels._grad import KernelFn, needs_grad
from repro_torch.kernels.rwkv6.ref import wkv6_plain

HEAD_DIMS = (16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("wkv6")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.repro_wkv6_fwd.argtypes = (
        [p] * 7 + [i] * 7 + [i64] * 6 + [ctypes.c_float, p])
    lib.repro_wkv6_fwd.restype = i
    lib.repro_wkv6_error_string.argtypes = [i]
    lib.repro_wkv6_error_string.restype = ctypes.c_char_p
    return lib


def _check(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u: torch.Tensor) -> None:
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"wkv6: r, k, v, w must be the same (B,H,S,D); got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    b, h, s, d = r.shape
    if min(b, h, s) < 1 or d not in HEAD_DIMS:
        raise ValueError(f"wkv6: shape {tuple(r.shape)}; the kernel takes "
                         f"B, H, S >= 1 and D in {HEAD_DIMS}")
    if r.dtype not in _DTYPE_CODES or any(t.dtype != r.dtype
                                          for t in (k, v, w)):
        raise TypeError(f"wkv6: dtypes {[t.dtype for t in (r, k, v, w)]}; "
                        "the kernel takes float32 or bfloat16, the same for "
                        "r, k, v and w")
    if u.shape != (h, d) or u.dtype != torch.float32 \
            or not u.is_contiguous():
        raise ValueError(f"wkv6: u must be contiguous float32 ({h}, {d}); "
                         f"got {u.dtype} {tuple(u.shape)}")
    if any(t.device != r.device for t in (k, v, w, u)):
        raise ValueError("wkv6: r, k, v, w and u must be on one device")
    # read through strides (the model passes (B,S,H,D) activations viewed
    # as (B,H,S,D)), one set for all four inputs
    if r.stride(3) != 1 or any(t.stride() != r.stride() for t in (k, v, w)):
        raise ValueError("wkv6: r, k, v and w must share their strides, with "
                         "the head dim contiguous (stride 1)")
    # the kernel stages rows of D elements by 16-byte asynchronous copies
    size = r.element_size()
    if any(not t.is_meta and t.data_ptr() % 16 for t in (r, k, v, w)) or any(
            r.stride(i) * size % 16 for i in range(3) if r.shape[i] > 1):
        raise ValueError("wkv6: r, k, v and w must start on 16 bytes, and "
                         "their batch, head and step strides be multiples "
                         f"of 16 bytes; got strides {r.stride()} of "
                         f"{size}-byte elements")


# the kernel's geometries: the (rows, columns) of the state a thread keeps
GEOMETRIES = ((8, 4), (8, 1))


def geometry(b: int, h: int, d: int) -> tuple[int, int]:
    """The kernel's geometry for a (B,H,.,D) call.  At D=64, 8 x 4 a thread
    makes one block of 128 threads a head, and each r, k, w value it reads
    from shared memory serves 4 columns; 8 x 1 makes 4 blocks a head, for
    a B*H too small to fill an H100's 132 SMs with one block a head.
    8 x 4 needs D >= 32."""
    return (8, 4) if b * h >= 128 and d > 16 else (8, 1)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, *, floor: float
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: (B,H,S,D), any S >= 1, D in ``HEAD_DIMS``; u: (H,D)
    float32.  ``w`` is clipped to ``[floor, 1]``.  Returns (out (B,H,S,D)
    in r's dtype, final state (B,H,D,D) float32), the scan from S = 0.
    ``out`` has r's strides where r is dense (``torch.empty_like``)."""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, floor=floor)
    if r.device.type == "cuda":
        forward = _forward
    elif _cost.counts_meta(r):
        forward = _counted
    else:
        raise ValueError(f"wkv6: no kernel for device {r.device}")
    _check(r, k, v, w, u)
    if not 0.0 <= floor <= 1.0:
        raise ValueError(f"wkv6: floor {floor} outside [0, 1]")
    if needs_grad(r, k, v, w, u):
        return KernelFn.apply(forward, wkv6_plain, {"floor": floor},
                              r, k, v, w, u)
    return forward(r, k, v, w, u, floor=floor)


def cost(b: int, h: int, s: int, d: int,
         dtype: torch.dtype = torch.bfloat16) -> dict:
    """The least work of one call, per (b, h, t): k vᵀ (D²), the decayed
    state (2 D²), rᵀ S (2 D²) and the bonus (r·(u∘k)) v (4 D), fp32
    outside the tensor cores; r, k, v, w read once and out written once,
    u (fp32) read and the final state (fp32) written."""
    n = b * h * s
    size = torch.finfo(dtype).bits // 8
    return {"flops": n * (5.0 * d * d + 4.0 * d),
            "bytes": float(5 * n * d * size + h * d * 4 + b * h * d * d * 4),
            "peak_class": "float32"}


def _counted(r, k, v, w, u, *, floor: float
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's outputs on meta, its cost added to the counter."""
    b, h, s, d = r.shape
    out = torch.empty_like(r)
    state = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    _cost.current().add_kernel("wkv6", **cost(b, h, s, d, r.dtype))
    return out, state


def _forward(r, k, v, w, u, *, floor: float
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One counted launch, in the geometry ``geometry`` picks."""
    b, h, _, d = r.shape
    out, state = launch(r, k, v, w, u, floor=floor, geom=geometry(b, h, d))
    _build.count_launch(wkv6)
    return out, state


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u: torch.Tensor, *, floor: float,
           geom: tuple[int, int]) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel in geometry ``geom`` (of ``GEOMETRIES``),
    on inputs that passed ``_check``; counts nothing (``wkv6`` counts)."""
    b, h, s, d = r.shape
    out = torch.empty_like(r)
    state = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    lib = _lib()
    with torch.cuda.device(r.device):
        err = lib.repro_wkv6_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), out.data_ptr(), state.data_ptr(),
            _DTYPE_CODES[r.dtype], b, h, s, d, *geom, *r.stride()[:3],
            *out.stride()[:3], floor, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("wkv6 launch failed: "
                           + lib.repro_wkv6_error_string(err).decode())
    return out, state


wkv6.launches = 0
