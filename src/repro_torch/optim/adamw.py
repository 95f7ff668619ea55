"""AdamW + LR schedules + global-norm clipping on trees of tensors.

Port of ``repro.optim.adamw``: the same config, the same update in the
same float32 arithmetic, written by hand (not ``torch.optim.AdamW``, whose
schedule, clipping and bias corrections are not the reference's).  Trees
are nested dicts of tensors; every function returns new tensors and
leaves its inputs as they are.  The step count is an int32 scalar tensor,
and ``lr`` and ``grad_norm`` stay 0-d float32 tensors on the params'
device, so a step needs no host sync.  Moment dtypes are configurable:
bf16 moments halve the optimizer's memory.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.common import (Params, torch_dtype, tree_get,
                                       tree_leaves, tree_map)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    moment_dtype: str = "float32"       # "bfloat16" halves optimizer memory
    schedule: str = "cosine"            # cosine | linear | constant
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor): a linear warm-up
    of ``(step + 1) / warmup_steps``, then the decay to ``min_lr_ratio``."""
    s = step.float()
    warm = torch.clamp((s + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = torch.ones_like(frac)
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * decay
    return cfg.lr * warm * decay


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> tuple[Params, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda _, g: (g.float() * scale).to(g.dtype), grads), norm


def init_opt_state(cfg: AdamWConfig, params: Params) -> dict:
    """Zero moments in ``moment_dtype`` beside each param, step 0 (int32),
    on the params' device (``meta`` included)."""
    mdt = torch_dtype(cfg.moment_dtype)
    device = tree_leaves(params)[0].device

    def zeros(_, p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_opt_state(cfg: AdamWConfig, params: Params) -> dict:
    """``init_opt_state`` on the ``meta`` device: shapes and dtypes only."""
    meta = tree_map(lambda _, p: torch.empty(p.shape, dtype=p.dtype,
                                             device="meta"), params)
    return init_opt_state(cfg, meta)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Params, opt_state: dict,
                 params: Params) -> tuple[Params, dict, dict]:
    """Returns (new_params, new_opt_state, metrics).  Clips by global norm,
    takes the schedule at the incremented step, divides by both bias
    corrections and decays every leaf (the reference's ``_is_matrix`` is
    True for all); moments are stored in ``moment_dtype`` and params in
    their own dtype."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip_norm)
    step = opt_state["step"] + 1
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    mdt = torch_dtype(cfg.moment_dtype)

    def upd(p, g, m, v):
        gf = g.float()
        mf = m.float() * b1 + gf * (1 - b1)
        vf = v.float() * b2 + torch.square(gf) * (1 - b2)
        mhat = mf / bc1
        vhat = vf / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        pf = p.float()
        pf = pf - lr * (delta + cfg.weight_decay * pf)
        return pf.to(p.dtype), mf.to(mdt), vf.to(mdt)

    out = tree_map(lambda path, p: upd(p, *(tree_get(t, path) for t in (
        grads, opt_state["mu"], opt_state["nu"]))), params)
    new_state = {"mu": tree_map(lambda _, o: o[1], out),
                 "nu": tree_map(lambda _, o: o[2], out), "step": step}
    return (tree_map(lambda _, o: o[0], out), new_state,
            {"lr": lr, "grad_norm": gnorm})

