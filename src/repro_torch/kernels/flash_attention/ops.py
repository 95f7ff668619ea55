"""Public wrapper of the flash attention kernel.

A CUDA tensor goes to the hand-written kernel
(``csrc/flash_attention.cu``) or to an exception; a CPU tensor goes to the
plain version (``ref.attention_plain``); a meta tensor under a
``hw.cost.CostCounter`` gets meta outputs and adds ``cost`` to the count
(the dry-run), and raises otherwise.  ``flash_attention.launches`` counts
the kernel launches, so a run can show its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.hw import cost as _cost
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_plain

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.repro_flash_attention_fwd.argtypes = (
        [p, p, p, p] + [i] * 6 + [i64] * 12 + [i, i, ctypes.c_float, p])
    lib.repro_flash_attention_fwd.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B,S,H,D)/(B,S,K,D)")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != s \
            or k.shape[3] != d:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if h % k.shape[2]:
        raise ValueError(f"flash_attention: H={h} is not a multiple of "
                         f"K={k.shape[2]}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; the kernel takes float32 or bfloat16")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim must be "
                             "contiguous (stride 1)")
        # the bf16 kernel moves rows in 16-byte vectors
        # (a meta tensor has no address)
        if t.dtype == torch.bfloat16 and (
                (not t.is_meta and t.data_ptr() % 16)
                or any(st % 8 for st in t.stride()[:3])):
            raise ValueError(f"flash_attention: bf16 {name} must be 16-byte "
                             "aligned with strides that are multiples of 8")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None
                    ) -> torch.Tensor:
    """q: (B,S,H,D); k/v: (B,S,K,D), H % K == 0 -> (B,S,H,D) in q's dtype.

    Self-attention only (Sq == Sk, query i at position i).  Any S >= 1;
    D in ``HEAD_DIMS``; float32 or bfloat16."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window)
    counted = _cost.counts_meta(q)
    if q.device.type != "cuda" and not counted:
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    b, s, h, d = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if counted:
        _cost.current().add_kernel("flash_attention", **cost(
            b, s, h, k.shape[2], d, causal=causal, window=window,
            dtype=q.dtype))
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], b, s, h, k.shape[2], d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(causal), window or 0,
            1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    _build.count_launch(flash_attention)
    return out


flash_attention.launches = 0


def causal_pairs(s: int, window: int | None) -> int:
    """The (query, key) pairs of a causal self-attention over ``s``
    positions, each query seeing at most its ``window`` latest keys."""
    w = s if window is None else min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def cost(b: int, s: int, h: int, kh: int, d: int, *, causal: bool = True,
         window: int | None = None, dtype: torch.dtype = torch.bfloat16
         ) -> dict:
    """The least work of one call: 4·D flops (QKᵀ and PV) for each
    (query, key) pair a head sees, on the tensor cores in bf16 (the fp32
    kernel is scalar); q, k and v read once and out written once."""
    pairs = causal_pairs(s, window) if causal else s * s
    size = torch.finfo(dtype).bits // 8
    return {"flops": 4.0 * b * h * d * pairs,
            "bytes": float(size * b * s * d * (2 * h + 2 * kh)),
            "peak_class": ("bfloat16" if dtype == torch.bfloat16
                           else "float32")}
