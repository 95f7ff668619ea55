"""Plain PyTorch version of the WKV6 kernel: a port of
``repro.kernels.rwkv6.ref``'s ``wkv6_ref``, the exact per-step fp32 scan

    S_t   = diag(w_t) S_{t-1} + k_t v_t^T
    out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

with one difference: ``w`` is clipped to ``[floor, 1]`` first, as the
Pallas kernel (floor 1e-38) and the reference model's chunked form
(floor 1e-8) clip it.  The CPU path of ``ops.wkv6`` (so the model's
prefill on the CPU) and the yardstick the CUDA kernel is held to on the
card.
"""

from __future__ import annotations

import torch


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, *, floor: float,
               state0: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: (B,H,S,D); u: (H,D); state0: (B,H,D,D) or None (zeros).
    Returns (out (B,H,S,D) in r's dtype, final state (B,H,D,D) float32)."""
    b, h, s, d = r.shape
    rf, kf, vf = r.float(), k.float(), v.float()
    wf = torch.clamp(w.float(), min=floor, max=1.0)
    uf = u.float()[None, :, :, None]
    state = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
             if state0 is None else state0.float())
    out = torch.empty((b, h, s, d), dtype=torch.float32, device=r.device)
    for t in range(s):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        out[:, :, t] = torch.einsum("bhd,bhdv->bhv", rf[:, :, t],
                                    state + uf * kv)
        state = state * wf[:, :, t, :, None] + kv
    return out.to(r.dtype), state
