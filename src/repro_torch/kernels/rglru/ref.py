"""Plain PyTorch version of the RG-LRU kernel: a port of
``repro.kernels.rglru.ref``'s ``rglru_ref``, the exact per-step fp32
scan

    h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) * x_t

The CPU path of ``ops.rglru``, the decode path of the model (``h0``
given) and the yardstick the CUDA kernel is held to on the card.
"""

from __future__ import annotations

import torch


def rglru_plain(a: torch.Tensor, x: torch.Tensor,
                h0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """a, x: (B,S,R), a in (0,1); h0: (B,R) or None (zeros).  Returns
    (h (B,S,R) in x's dtype, h_last (B,R) float32)."""
    af = a.float()
    b = torch.sqrt(torch.clamp(1.0 - af * af, min=1e-12)) * x.float()
    h = (torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32,
                     device=a.device) if h0 is None else h0.float())
    hs = torch.empty_like(b)
    for t in range(a.shape[1]):
        h = af[:, t] * h + b[:, t]
        hs[:, t] = h
    return hs.to(x.dtype), h
