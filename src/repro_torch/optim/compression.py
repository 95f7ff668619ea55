"""Gradient compression for the slow (pod-crossing) axis, with error
feedback (Karimireddy et al., arXiv:1901.09847).

Port of ``repro.optim.compression``:

* ``topk``  keeps the entries of a leaf whose magnitude reaches its k-th
  largest (a dense mask, as the reference models it);
* ``int8``  quantizes a leaf symmetrically to int8 (round half to even)
  and dequantizes it.

``compress`` and ``wire_bytes`` work on nested dicts of tensors and leave
their inputs as they are.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.common import Params, tree_get, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    scheme: str = "none"          # none | topk | int8
    topk_ratio: float = 0.01      # fraction of entries kept
    ef: bool = True               # error feedback


def init_error_state(params: Params) -> Params:
    return tree_map(lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)


def _topk_mask(g: torch.Tensor, ratio: float) -> torch.Tensor:
    flat = torch.abs(g.reshape(-1))
    k = max(1, int(flat.numel() * ratio))
    thresh = torch.topk(flat, k).values[-1]
    return (torch.abs(g) >= thresh).to(g.dtype)


@torch.no_grad()
def compress(cfg: CompressionConfig, grads: Params, error: Params
             ) -> tuple[Params, Params, dict]:
    """Returns (wire_grads, new_error, metrics): what crosses the slow axis
    and the residual re-injected next step (error feedback)."""
    if cfg.scheme == "none":
        return grads, error, {"compression_ratio": 1.0}
    if cfg.scheme not in ("topk", "int8"):
        raise ValueError(cfg.scheme)

    def one(path, g):
        gf = g.float()
        if cfg.ef:
            gf = gf + tree_get(error, path)
        if cfg.scheme == "topk":
            wire = gf * _topk_mask(gf, cfg.topk_ratio)
        else:
            scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
            wire = torch.clamp(torch.round(gf / scale), -127, 127) * scale
        return wire.to(g.dtype), gf - wire

    outs = tree_map(one, grads)
    ratio = cfg.topk_ratio if cfg.scheme == "topk" else 0.25
    return (tree_map(lambda _, o: o[0], outs),
            tree_map(lambda _, o: o[1], outs), {"compression_ratio": ratio})


def wire_bytes(cfg: CompressionConfig, grads: Params) -> float:
    """Bytes a cross-pod all-reduce of these grads would move per device
    under the configured scheme (for the roofline's DCI term)."""
    total = sum(math.prod(g.shape) * g.element_size()
                for g in tree_leaves(grads))
    if cfg.scheme == "topk":
        # index+value pairs: 4B index + 2B value per kept entry
        kept = total * cfg.topk_ratio / 2      # entries (bf16 grads)
        return kept * 6
    if cfg.scheme == "int8":
        return total / 2                        # bf16 -> int8
    return float(total)

