"""Family dispatch: the reference's uniform model interface over its six
model families (dense, moe, hybrid, ssm, vlm and audio)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import (recurrentgemma, rwkv6, transformer, vlm,
                                whisper)
from repro_torch.models.common import ModelConfig

FAMILY_MODULES = {"dense": transformer, "moe": transformer,
                  "hybrid": recurrentgemma, "ssm": rwkv6, "vlm": vlm,
                  "audio": whisper}


def module_for(cfg: ModelConfig):
    return FAMILY_MODULES[cfg.family]


def init(cfg: ModelConfig, generator: torch.Generator | None = None, *,
         device: str | torch.device = "cuda") -> dict:
    """Random params drawn from ``generator``, which must live on
    ``device``.  On the ``meta`` device no generator is needed and
    nothing is allocated."""
    dev = resolve_device(device)
    if dev.type != "meta":
        if generator is None:
            raise ValueError("init: pass a torch.Generator on the target "
                             "device (e.g. torch.Generator(device)"
                             ".manual_seed(0))")
        if generator.device.type != dev.type:
            raise ValueError(f"init: generator on {generator.device}, "
                             f"params on {dev}")
    return module_for(cfg).init(cfg, generator, dev)


def abstract(cfg: ModelConfig) -> dict:
    """The params' tree on the ``meta`` device: shapes and dtypes."""
    return init(cfg, device="meta")


def specs(cfg: ModelConfig) -> dict:
    """The logical-axes tree of the params: the same structure, one tuple
    of logical axis names (or None) a leaf, one entry a dim."""
    return module_for(cfg).specs(cfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: str | torch.device = "cuda") -> dict:
    """A zero decode cache for ``batch`` rows of up to ``max_len``
    positions (its "len" 0)."""
    return module_for(cfg).init_cache(cfg, batch, max_len,
                                      resolve_device(device))


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """``init_cache``'s tree on the ``meta`` device."""
    return init_cache(cfg, batch, max_len, device="meta")


def needs_frontend(cfg: ModelConfig) -> bool:
    """Whether the family takes frontend (modality) tokens: vlm and
    audio."""
    return cfg.family in ("vlm", "audio")


def forward(cfg: ModelConfig, params: dict, batch: dict, **kw):
    """batch: tokens (B,S) [+ frontend (B,T,d) for vlm and audio].
    Returns (logits, aux_loss)."""
    return module_for(cfg).forward(cfg, params, batch, **kw)


def cache_max_len(cfg: ModelConfig, seq_len: int) -> int:
    return module_for(cfg).cache_max_len(cfg, seq_len)


def prefill(cfg: ModelConfig, params: dict, batch: dict, max_len: int, **kw):
    """batch: tokens (B,S) [+ frontend for vlm and audio: zeros if
    absent, as in the reference]."""
    if needs_frontend(cfg):
        kw["frontend"] = batch.get("frontend")
    return module_for(cfg).prefill(cfg, params, batch["tokens"], max_len,
                                   **kw)


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                token: torch.Tensor, pos):
    return module_for(cfg).decode_step(cfg, params, cache, token, pos)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            aux_weight: float = 0.01, **kw):
    """Next-token cross-entropy (+ MoE aux).  batch needs "tokens" and
    "targets", optionally "mask".  The true-class logit comes from a
    one-hot contraction, as in the reference.  ``kw`` goes to ``forward``
    (e.g. ``self_attn``, to hold the kernel path against the plain one)."""
    logits, aux = forward(cfg, params, batch, **kw)
    targets = batch["targets"]
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    onehot = F.one_hot(targets.long(), lf.shape[-1]).to(lf.dtype)
    true_logit = torch.einsum("bsv,bsv->bs", lf, onehot)
    nll = lse - true_logit
    mask = batch.get("mask")
    if mask is not None:
        nll = nll * mask
        denom = torch.clamp(torch.sum(mask), min=1.0)
    else:
        denom = nll.numel()
    loss = torch.sum(nll) / denom
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}
