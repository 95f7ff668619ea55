"""Train-step builder with gradient accumulation, per-layer remat,
gradient compression and AdamW.

Port of ``repro.train.trainer``.  ``make_train_step`` builds the
(state, batch) -> (state, metrics) function the launcher drives:

* microbatch gradient accumulation: the batch's leading dim is reshaped
  to (n_micro, B/n_micro) and a Python loop takes the place of the
  reference's ``lax.scan``; gradients are summed in ``accum_dtype``;
* ``remat=True`` sets ``cfg.remat = "full"``, which checkpoints every
  layer of the forward (``torch.utils.checkpoint``), as the reference's
  ``jax.checkpoint`` around its scan bodies;
* gradient compression with error feedback before the optimizer, when
  the state holds "error";
* AdamW with schedule and global-norm clip (``repro_torch.optim``).

The train state is a plain dict {params, opt, error?} so checkpointing
stays structural.  The step returns a new state and leaves the old one as
it is; the metrics are 0-d tensors on the params' device (no host sync).

Sharded state: a state placed on a mesh by ``state_specs`` and a plan
(``sharding.distribute_tree``) holds DTensors, and the step runs on them
under ``implicit_replication`` (the few plain tensors it makes, such as
the loss sum's zero, count as replicated).  With ``batch_axes`` each
microbatch's batch dim is sharded over those mesh axes.  Every gradient
is redistributed to its parameter's placements before it is summed and
before the optimizer (the data-parallel reduce-scatter), so AdamW's
moments keep the parameters' placements.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections.abc import Callable

import torch

from repro_torch.models import zoo
from repro_torch.models.common import (ModelConfig, Params, Specs,
                                       is_dtensor, torch_dtype, tree_leaves,
                                       tree_map)
from repro_torch.optim import (AdamWConfig, CompressionConfig,
                               abstract_opt_state, adamw_update, compress,
                               init_error_state, init_opt_state)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    remat: bool = True
    remat_policy: str = "dots"       # kept for equality with the reference's
                                     # config; neither train step reads it
    accum_dtype: str = "float32"     # grad-accumulator dtype
    aux_weight: float = 0.01
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    compression: CompressionConfig = dataclasses.field(
        default_factory=CompressionConfig)


def _has_error(tcfg: TrainConfig) -> bool:
    return tcfg.compression.scheme != "none" and tcfg.compression.ef


def init_state(cfg: ModelConfig, tcfg: TrainConfig,
               generator: torch.Generator | None = None, *,
               device: str | torch.device = "cuda") -> dict:
    """Params drawn from ``generator`` (on ``device``, as ``zoo.init``),
    zero moments and, with error feedback, a zero error."""
    params = zoo.init(cfg, generator, device=device)
    state = {"params": params,
             "opt": init_opt_state(tcfg.optimizer, params)}
    if _has_error(tcfg):
        state["error"] = init_error_state(params)
    return state


def abstract_state(cfg: ModelConfig, tcfg: TrainConfig) -> dict:
    """``init_state``'s tree on the ``meta`` device: shapes and dtypes."""
    params = zoo.init(cfg, device="meta")
    state = {"params": params,
             "opt": abstract_opt_state(tcfg.optimizer, params)}
    if _has_error(tcfg):
        state["error"] = tree_map(
            lambda _, p: torch.empty(p.shape, dtype=torch.float32,
                                     device="meta"), params)
    return state


def state_specs(cfg: ModelConfig, tcfg: TrainConfig) -> Specs:
    """Logical-axes tree matching ``init_state``'s structure."""
    pspecs = zoo.specs(cfg)
    out = {"params": pspecs,
           "opt": {"mu": pspecs, "nu": pspecs, "step": ()}}
    if _has_error(tcfg):
        out["error"] = pspecs
    return out


def _dtensor_mesh(tree: Params):
    """The mesh of the tree's DTensors, or None for plain tensors."""
    for t in tree_leaves(tree):
        if is_dtensor(t):
            return t.device_mesh
    return None


def _shard_batch(x: torch.Tensor, mesh, batch_axes: tuple[str, ...],
                 dim: int = 1):
    """A DTensor with ``dim`` sharded over ``batch_axes``: dim 1 of a
    microbatched (n_micro, B/n_micro, ...) tensor, dim 0 of a prefill's
    or a decode step's (B, ...).  ``x`` is the same full batch on every
    rank: each keeps its slice; a batch already placed (a DTensor, as the
    dry-run places it) is redistributed.  Rows that the batch axes'
    ranks do not divide go over those that do
    (``launch.mesh.dividing_axes``)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import dividing_axes
    names = tuple(mesh.mesh_dim_names)
    unknown = [a for a in batch_axes if a not in names]
    if unknown:
        raise ValueError(f"batch_axes {unknown} are not axes of the "
                         f"mesh {names}")
    batch_axes = dividing_axes(x.shape[dim], mesh, tuple(batch_axes))
    placements = tuple(Shard(dim) if n in batch_axes else Replicate()
                       for n in names)
    if is_dtensor(x):
        return x.redistribute(mesh, placements)
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def _like_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient with its parameter's placements (a reduce-scatter of a
    partial sum, a slice of a replicated one); plain tensors as they
    are."""
    if is_dtensor(p) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A metric as a plain tensor (a DTensor's full value)."""
    return t.full_tensor() if is_dtensor(t) else t


def _unflatten_like(tree: Params, leaves) -> Params:
    it = iter(leaves)
    return tree_map(lambda _, __: next(it), tree)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    batch_axes: tuple[str, ...] | None = None
                    ) -> Callable[[dict, dict], tuple[dict, dict]]:
    """``batch`` is a dict of (B, ...) tensors ("tokens", "targets",
    optionally "mask") on the params' device, B a multiple of
    ``tcfg.microbatches``.  Metrics: loss, lr, grad_norm (and
    compression_ratio with compression), plain tensors.

    ``batch_axes``: mesh axes the batch dim is sharded over (the state
    must then be DTensors on that mesh); each microbatch is sharded
    explicitly, as the reference constrains its microbatched tree, since
    the (B,) -> (n_micro, B/n) reshape would otherwise leave the batch
    whole on every rank."""
    n_micro = tcfg.microbatches
    # per-LAYER remat: checkpointing the whole loss would still keep every
    # layer's backward residuals
    if tcfg.remat:
        cfg = dataclasses.replace(cfg, remat="full")
    acc_dt = torch_dtype(tcfg.accum_dtype)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        mesh = _dtensor_mesh(state["params"])
        if mesh is None:
            if batch_axes:
                raise ValueError("make_train_step: batch_axes needs a "
                                 "state placed on a mesh (DTensors)")
            return _step(state, batch, None)
        if "error" in state:
            raise NotImplementedError(
                "make_train_step: gradient compression on a sharded state")
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            new_state, metrics = _step(state, batch, mesh)
        return new_state, {k: _plain(v) for k, v in metrics.items()}

    def _step(state: dict, batch: dict, mesh) -> tuple[dict, dict]:
        params = state["params"]
        leaves = tree_map(lambda _, p: p.detach().requires_grad_(True),
                          params)
        flat = tree_leaves(leaves)

        def reshape_micro(x):
            b = x.shape[0]
            if b % n_micro:
                raise ValueError(f"batch {b} is not a multiple of "
                                 f"{n_micro} microbatches")
            return x.reshape(n_micro, b // n_micro, *x.shape[1:])

        micro = {k: reshape_micro(v) for k, v in batch.items()}
        if batch_axes:
            micro = {k: _shard_batch(v, mesh, tuple(batch_axes))
                     for k, v in micro.items()}
        gsum = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                if mesh is None else torch.zeros_like(p, dtype=acc_dt)
                for p in flat]
        lsum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
        for i in range(n_micro):
            mb = {k: v[i] for k, v in micro.items()}
            loss, _ = zoo.loss_fn(cfg, leaves, mb,
                                  aux_weight=tcfg.aux_weight)
            grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                        materialize_grads=True)
            with torch.no_grad():
                for acc, g, p in zip(gsum, grads, flat):
                    acc.add_(_like_param(g, p).to(acc_dt))
                lsum = lsum + loss.detach()
            del loss, grads
        with torch.no_grad():
            grads = _unflatten_like(params, [(g.float() / n_micro).to(acc_dt)
                                             for g in gsum])
        del gsum
        loss = lsum / n_micro

        metrics = {"loss": loss}
        if "error" in state:
            grads, new_error, cm = compress(tcfg.compression, grads,
                                            state["error"])
            metrics.update(cm)
        new_params, new_opt, om = adamw_update(tcfg.optimizer, grads,
                                               state["opt"], params)
        metrics.update(om)
        new_state = {"params": new_params, "opt": new_opt}
        if "error" in state:
            new_state["error"] = new_error
        return new_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, tcfg: TrainConfig):
    @torch.no_grad()
    def eval_step(state: dict, batch: dict) -> dict:
        loss, metrics = zoo.loss_fn(cfg, state["params"], batch,
                                    aux_weight=tcfg.aux_weight)
        return {"loss": loss, **metrics}
    return eval_step


def _serving(cfg: ModelConfig, params: Params, batch: dict):
    """The context a serving step runs in and its batch: on DTensor
    params, ``implicit_replication`` (plain tensors count as replicated)
    and each batch tensor's rows sharded over ``cfg.batch_axes``; on
    plain params, nothing and the batch as it is."""
    mesh = _dtensor_mesh(params)
    if mesh is None:
        return contextlib.nullcontext(), batch
    from torch.distributed.tensor.experimental import implicit_replication
    if cfg.batch_axes:
        batch = {k: v if is_dtensor(v) or not isinstance(v, torch.Tensor)
                 else _shard_batch(v, mesh, tuple(cfg.batch_axes), dim=0)
                 for k, v in batch.items()}
    return implicit_replication(), batch


def make_prefill_step(cfg: ModelConfig, max_len: int,
                      cache_shardings: dict | None = None):
    """(params, batch) -> (last-token logits, cache).  On DTensor params
    the prompt's rows are sharded over ``cfg.batch_axes``, the logits come
    back whole (a plain tensor) and, with ``cache_shardings`` (from
    ``serving.kvcache.cache_shardings``), the cache is placed on them."""
    @torch.no_grad()
    def prefill_step(params: dict, batch: dict):
        ctx, batch = _serving(cfg, params, batch)
        with ctx:
            logits, cache = zoo.prefill(cfg, params, batch, max_len)
            if cache_shardings is not None:
                from repro_torch.sharding import place_cache
                cache = place_cache(cache, cache_shardings)
        return _plain(logits), cache
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: (params, cache, token, pos) -> (logits, cache).
    On DTensor params and a placed cache each rank writes its slice of
    the new token's state in place; the logits come back whole."""
    @torch.no_grad()
    def serve_step(params: dict, cache: dict, token, pos):
        ctx, batch = _serving(cfg, params, {"token": token})
        with ctx:
            logits, cache = zoo.decode_step(cfg, params, cache,
                                            batch["token"], pos)
        return _plain(logits), cache
    return serve_step
