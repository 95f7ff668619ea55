"""KV-cache sharding policy: the port's ``repro.serving.kvcache``.

Cache layout is (L, S, B, K, hd) (``models/transformer.py``; the other
families add lead dims or keep recurrent states).  The policy applies
the paper's per-op concurrency idea to decode:

* batch always shards over the plan's batch axes;
* if the kv-head count divides the model degree, shard heads (classic
  tensor-parallel decode);
* otherwise shard the SEQUENCE dim over the kv axes: partial-softmax
  decode (flash-decoding).  ``layers.decode_attention`` turns the
  softmax over the split S into local reductions and all-reduces of the
  (max, sum, weighted v) statistics;
* at model degree 1 (or no kv axes) the heads stay replicated.

``kv_cache_pspec`` returns the reference's ``PartitionSpec`` as a plain
tuple (as ``ShardingPlan.spec_for`` does) with the strategy's name;
``cache_shardings`` places a whole cache tree, as DTensor placements
through ``sharding.placements_for``.  The port keeps its own copy of the
rules; ``tests/test_torch_kvcache.py`` holds both equal to the
reference's.
"""

from __future__ import annotations

import torch

from repro_torch.launch.mesh import mesh_sizes
from repro_torch.models.common import ModelConfig, ShardingPlan
from repro_torch.sharding.specs import NamedSharding, placements_for

# cache keys holding (..., S, B, K, hd) attention caches
_KV_KEYS = ("k", "v", "xk", "xv")

REPLICATED = "replicated-heads"
HEAD_SHARDED = "head-sharded"
SEQ_SHARDED = "sequence-sharded(flash-decode)"


def _batch_entry(plan: ShardingPlan):
    """The spec entry of the batch dim: None, one axis, or a tuple."""
    batch = tuple(plan.batch_axes) or None
    if isinstance(batch, tuple) and len(batch) == 1:
        batch = batch[0]
    return batch


def kv_cache_pspec(cfg: ModelConfig, plan: ShardingPlan, *,
                   model_degree: int, lead_dims: int = 1
                   ) -> tuple[tuple, str]:
    """The spec of a (*lead, S, B, K, hd) cache, one entry a dim (None, a
    mesh axis or a tuple of axes), and the strategy's name."""
    batch = _batch_entry(plan)
    model_axes = tuple(plan.rules.get("kv", ()))
    ma = (model_axes if len(model_axes) > 1
          else (model_axes[0] if model_axes else None))
    lead = (None,) * lead_dims
    if ma is None or model_degree <= 1:
        return (*lead, None, batch, None, None), REPLICATED
    if cfg.n_kv_heads % model_degree == 0:
        return (*lead, None, batch, ma, None), HEAD_SHARDED
    return (*lead, ma, batch, None, None), SEQ_SHARDED


def _cache_specs(cfg: ModelConfig, plan: ShardingPlan, sizes: dict,
                 cache_tree, *, model_degree: int) -> tuple[dict, str]:
    """The spec of every leaf of a cache tree on a mesh of axis ``sizes``
    (name -> size), and the strategy.  Keys in ``_KV_KEYS`` of rank 5 or
    more get the kv policy (lead dims from the rank); a spec whose split
    dim does not divide falls back to the batch alone (batch on the dim
    third from the end).  Other leaves of rank 2 or more are (L, B, ...)
    recurrent, shift or conv states: batch on dim 1, or replicated where
    that does not divide.  Scalars (and the int "len") are replicated."""
    batch = _batch_entry(plan)
    strategy = kv_cache_pspec(cfg, plan, model_degree=model_degree)[1]

    def axis_size(part) -> int:
        if part is None:
            return 1
        n = 1
        for a in ((part,) if isinstance(part, str) else part):
            n *= sizes.get(a, 1)
        return n

    def divides(spec: tuple, shape) -> bool:
        return all(axis_size(part) <= 1 or dim % axis_size(part) == 0
                   for dim, part in zip(shape, spec))

    def walk(node):
        out = {}
        for key, val in node.items():
            if isinstance(val, dict):
                out[key] = walk(val)
                continue
            rank = len(val.shape) if isinstance(val, torch.Tensor) else 0
            if key in _KV_KEYS and rank >= 5:
                spec = kv_cache_pspec(cfg, plan, model_degree=model_degree,
                                      lead_dims=rank - 4)[0]
                if not divides(spec, val.shape):
                    parts = [None] * rank
                    parts[rank - 3] = batch
                    spec = tuple(parts)
            elif rank >= 2:
                spec = (None, batch, *([None] * (rank - 2)))
                if not divides(spec, val.shape):
                    spec = ()
            else:
                spec = ()
            out[key] = spec
        return out

    return walk(cache_tree), strategy


def cache_shardings(cfg: ModelConfig, plan: ShardingPlan, mesh, cache_tree,
                    *, model_degree: int) -> tuple[dict, str]:
    """``NamedSharding`` tree (DTensor placements on ``mesh``) for a cache
    tree, and the strategy: ``_cache_specs`` on the mesh's sizes."""
    specs, strategy = _cache_specs(cfg, plan, mesh_sizes(mesh), cache_tree,
                                   model_degree=model_degree)

    def to_sharding(node):
        if isinstance(node, dict):
            return {k: to_sharding(v) for k, v in node.items()}
        return NamedSharding(mesh, placements_for(node, mesh))

    return to_sharding(specs), strategy
