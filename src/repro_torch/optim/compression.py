"""Gradient compression for the slow (pod-crossing) axis, with error
feedback (Karimireddy et al., arXiv:1901.09847).

Port of ``repro.optim.compression``:

* ``topk``  keeps the entries of a leaf whose magnitude reaches its k-th
  largest (a dense mask, as the reference models it);
* ``int8``  quantizes a leaf symmetrically to int8 (round half to even)
  and dequantizes it.

``compress`` and ``wire_bytes`` work on nested dicts of tensors and leave
their inputs as they are.  A leaf may be a DTensor (a sharded train
state): each rank then compresses its own slice with the statistic of
the whole leaf, so every element gets the bits the plain ``compress``
of the full tensor gives it.  topk's threshold is the k-th largest |g|
of the ranks' local top-k candidates (their union holds the leaf's top
k), int8's scale the all-reduced (MAX) local maxima of |g|.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.common import (Params, is_dtensor, tree_get,
                                       tree_leaves, tree_map)


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


def _split_groups(g) -> list:
    """(mesh, mesh dim) of each mesh dim that splits DTensor ``g``: the
    ranks whose slices differ (a Replicate dim holds copies)."""
    from torch.distributed.tensor import Shard
    mesh = g.device_mesh
    return [(mesh, i) for i, p in enumerate(g.placements)
            if isinstance(p, Shard) and mesh.size(i) > 1]


def _topk_threshold(g, k: int) -> torch.Tensor:
    """The k-th largest |g| of the whole DTensor ``g``, from each rank's
    local top-k candidates (padded with -inf where a slice holds fewer,
    as an uneven split leaves it) gathered over the dims that split it."""
    from torch.distributed import _functional_collectives as funcol
    a = torch.abs(g.to_local().reshape(-1))
    cand = torch.topk(a, min(k, a.numel())).values
    if cand.numel() < k:
        cand = torch.cat([cand, cand.new_full((k - cand.numel(),),
                                              -math.inf)])
    for group in _split_groups(g):
        cand = funcol.wait_tensor(funcol.all_gather_tensor(cand, 0, group))
    return torch.topk(cand, k).values[-1]


def _abs_max(g) -> torch.Tensor:
    """max |g| of the whole DTensor ``g``: the local maxima (0 for an
    empty slice), all-reduced by MAX over the dims that split it."""
    from torch.distributed import _functional_collectives as funcol
    a = torch.abs(g.to_local())
    m = torch.max(a) if a.numel() else a.new_zeros(())
    for group in _split_groups(g):
        m = funcol.wait_tensor(funcol.all_reduce(m, "max", group))
    return m


def _compress_placed(cfg: CompressionConfig, gf, dtype
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``compress`` of one DTensor leaf ``gf`` (fp32, error added): the
    plain math on the local slice, with the whole leaf's threshold or
    scale; (wire, residual) keep ``gf``'s placements."""
    from torch.distributed.tensor import DTensor
    gl = gf.to_local()
    if cfg.scheme == "topk":
        k = max(1, int(gf.numel() * cfg.topk_ratio))
        wire = gl * (torch.abs(gl) >= _topk_threshold(gf, k)).to(gl.dtype)
    else:
        scale = torch.clamp(_abs_max(gf), min=1e-12) / 127.0
        wire = torch.clamp(torch.round(gl / scale), -127, 127) * scale

    def placed(t):
        return DTensor.from_local(t, gf.device_mesh, gf.placements,
                                  run_check=False, shape=gf.shape,
                                  stride=gf.stride())
    return placed(wire.to(dtype)), placed(gl - wire)


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
        if is_dtensor(gf):
            return _compress_placed(cfg, gf, g.dtype)
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

