"""Plain PyTorch version of the flash attention kernel (GQA, causal,
window): a line-for-line port of ``repro.kernels.flash_attention.ref``'s
``attention_ref``, fp32 math.  The CPU path of ``ops.flash_attention``
and the yardstick the CUDA kernel is held to on the card."""

from __future__ import annotations

import math

import torch


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None
                    ) -> torch.Tensor:
    """q: (B,S,H,D); k/v: (B,S,K,D), H multiple of K. fp32 math."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    rep = h // kh
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(d)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask[None, None], -math.inf)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)
