"""Model substrate: the config dataclass, the logical sharding axes and
the parameter-tree builder.

Own copy of ``repro.models.common`` (the JAX package's module imports
JAX, so the port keeps its own).  ``ModelConfig`` has the same fields and
the same derived sizes, so a config of one package compares equal, field
by field, to the other's.  Parameters are nested dicts of tensors under
the same ``/`` paths and drawn by the same laws as ``TreeBuilder.leaf``.

Every parameter carries a *logical axis spec* (a tuple of logical axis
names, one per dim) in a parallel tree, the family module's
``specs(cfg)``.  A ``ShardingPlan`` maps logical names to mesh axes; its
``spec_for`` gives the reference's ``PartitionSpec`` as a plain tuple,
which ``repro_torch.sharding`` turns into DTensor placements.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

Params = Any          # nested dict of tensors
Specs = Any           # same structure, leaves = tuple[str | None, ...]


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name ("bfloat16", "float32", ...) -> ``torch.dtype``."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config covers every assigned family via optional fields."""

    arch_id: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    # attention flavor
    window: int | None = None        # sliding-window size (Mixtral SWA, local)
    rope_theta: float = 10000.0
    # norms / activations
    norm: str = "rms"                # rms | layernorm | nonparam
    act: str = "swiglu"              # swiglu | gelu
    # hybrid (recurrentgemma): layer pattern, e.g. ("rglru","rglru","attn")
    block_pattern: tuple[str, ...] = ()
    rglru_dim: int = 0               # recurrence width (0 -> d_model)
    # vlm: insert a cross-attn layer every k self-attn layers
    cross_attn_every: int = 0
    n_frontend_tokens: int = 0       # stub modality tokens (vlm/audio)
    # enc-dec (whisper)
    encoder_layers: int = 0
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # per-layer rematerialization: "none" | "full" ("full" wraps every
    # layer of the forward in activation checkpointing, ``maybe_remat``)
    remat: str = "none"
    # kept for field-by-field equality with the reference config; the
    # port's layer loop is a Python loop and never reads it
    scan_unroll: bool = False
    # mesh axes the activation batch dim is sharded over; when non-empty,
    # every family's layers pin their (B,S,D) activations to that
    # placement (``layers.constrain_batch``) on DTensor activations
    batch_axes: tuple = ()
    # sequence parallelism: shard the SEQ dim of layer-boundary
    # activations over these axes (``layers.seq_boundary``)
    seq_axes: tuple = ()
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 (pad ids are never targets)."""
        return -(-self.vocab // 256) * 256

    @property
    def is_subquadratic(self) -> bool:
        """Supports 500k-token decode: recurrent state or bounded window."""
        return (self.family in ("ssm", "hybrid")
                or self.window is not None)

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def param_torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def param_count(self) -> int:
        """Exact count from the parameter tree built on the meta device."""
        from repro_torch.models import zoo
        tree = zoo.init(self, device="meta")
        return int(sum(t.numel() for t in tree_leaves(tree)))

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only the routed experts)."""
        total = self.param_count()
        if not self.moe_experts:
            return total
        expert = 3 * self.d_model * self.d_ff  # gate/up/down per expert
        inactive = (self.moe_experts - self.moe_top_k) * expert * self.n_layers
        return total - inactive


# ---------------------------------------------------------------------------
# Logical sharding axes
# ---------------------------------------------------------------------------

# Canonical logical axis names used by every model family:
#   "embed"   d_model dim            "ff"     mlp hidden dim
#   "heads"   q-head dim             "kv"     kv-head dim
#   "vocab"   vocabulary dim         "expert" MoE expert dim
#   "layers"  stacked layer dim      None     replicated
LOGICAL_AXES = ("embed", "ff", "heads", "kv", "vocab", "expert", "layers",
                "conv", "state", "table_d")

SpecEntry = str | tuple[str, ...] | None


@dataclasses.dataclass
class ShardingPlan:
    """logical axis -> tuple of mesh axes.  The tunable object: the
    shard-degree autotuner rewrites entries (``sharding.plan_from_degrees``).

    ``batch_axes``/``seq_axes`` control activation shardings."""

    rules: dict[str, tuple[str, ...]]
    batch_axes: tuple[str, ...] = ("data",)
    seq_axes: tuple[str, ...] = ()

    def spec_for(self, logical: tuple[str | None, ...]
                 ) -> tuple[SpecEntry, ...]:
        """One entry a dim: None (replicated), a mesh axis name, or a
        tuple of names (major first), as ``tuple(PartitionSpec(...))`` of
        the reference's."""
        parts: list[SpecEntry] = []
        used: set[str] = set()
        for name in logical:
            axes = self.rules.get(name, ()) if name else ()
            # a mesh axis may appear at most once per spec: first
            # occurrence wins (MoE (expert, embed, ff) keeps expert
            # parallelism on the model axis and leaves ff unsharded;
            # rwkv (embed, embed) square weights shard one dim)
            axes = tuple(a for a in axes if a not in used)
            used.update(axes)
            if len(axes) == 0:
                parts.append(None)
            elif len(axes) == 1:
                parts.append(axes[0])
            else:
                parts.append(tuple(axes))
        return tuple(parts)

    def tree_specs(self, logical_tree: Specs) -> Any:
        return map_specs(self.spec_for, logical_tree)


def map_specs(fn, logical_tree: Specs) -> Any:
    """Apply ``fn`` to every logical-axes tuple of a specs tree (a nested
    dict; an empty tuple is a scalar's spec)."""
    if isinstance(logical_tree, dict):
        return {k: map_specs(fn, v) for k, v in logical_tree.items()}
    return fn(logical_tree)


def default_plan() -> ShardingPlan:
    """Uniform max shard degree on the model axis for every op class (the
    analogue of TF's one intra-op parallelism for all operations), FSDP
    on the data axis over the embed dim."""
    return ShardingPlan(rules={
        "embed": ("data",),       # FSDP: gather at use
        "ff": ("model",),
        "heads": ("model",),
        "kv": ("model",),
        "vocab": ("model",),      # unembed projection
        "expert": ("model",),
        "layers": (),
        "conv": (),
        "state": (),
        # the input embedding table keeps a 1-D vocab sharding
        "table_d": (),
    })


def replicated_plan() -> ShardingPlan:
    return ShardingPlan(rules={k: () for k in LOGICAL_AXES},
                        batch_axes=(), seq_axes=())


# ---------------------------------------------------------------------------
# Param tree construction
# ---------------------------------------------------------------------------

class TreeBuilder:
    """Collects parameters and their logical axes under '/'-separated
    paths.

    Same laws as the reference ``TreeBuilder.leaf``: normal draws scaled
    by 1/sqrt(fan_in) (fan_in = shape[-2], or shape[-1] for vectors) unless
    a scale is given, zeros or ones on request.  Draws come from
    ``generator``, which must live on ``device``.  On the ``meta`` device
    nothing is drawn or allocated: only shapes and dtypes exist.
    ``build()`` returns the params; ``specs`` holds the logical-axes tree
    of the same structure."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: torch.Generator | None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.generator = generator
        self.params: dict = {}
        self.specs: dict = {}

    def leaf(self, path: str, shape: tuple[int, ...],
             logical: tuple[str | None, ...], *,
             init: str = "normal", scale: float | None = None) -> None:
        if len(shape) != len(logical):
            raise ValueError(f"{path}: shape {shape} and logical axes "
                             f"{logical} differ in rank")
        dtype = self.cfg.param_torch_dtype
        if self.device.type == "meta":
            arr = torch.empty(shape, dtype=dtype, device="meta")
        elif init == "zeros":
            arr = torch.zeros(shape, dtype=dtype, device=self.device)
        elif init == "ones":
            arr = torch.ones(shape, dtype=dtype, device=self.device)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
            arr = torch.randn(shape, generator=self.generator,
                              dtype=torch.float32, device=self.device)
            arr = arr.mul_(s).to(dtype)
        node, snode = self.params, self.specs
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            snode = snode.setdefault(p, {})
        node[parts[-1]] = arr
        snode[parts[-1]] = tuple(logical)

    def build(self) -> Params:
        return self.params


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a tensor placed on a device mesh)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def tree_leaves(tree: Params) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


def unstack(tree: Params, n: int) -> list[Params]:
    """The ``n`` layers of a tree of stacked (leading-dim) params, as views.
    One ``unbind`` a leaf, so autograd stacks the layers' gradients of a
    leaf once (indexing layer by layer would add a full-size zero-padded
    gradient a layer)."""
    per_leaf = tree_map(lambda _, t: t.unbind(0), tree)
    return [tree_map(lambda _, ts: ts[i], per_leaf) for i in range(n)]


def tree_get(tree: Params, path: str) -> Any:
    """The leaf (or subtree) of ``tree`` at the ``/`` path ``path``."""
    for part in path.split("/"):
        tree = tree[part]
    return tree


def tree_map(fn, tree: Params, path: str = "") -> Params:
    """Apply ``fn(path, leaf)`` to every leaf, keeping the dict structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    return fn(path, tree)


# leaves the forward pass reads in float32, never in the activation dtype
# (the reference reads each with ``.astype(float32)``)
_FLOAT32_LEAVES = (
    "log_a",      # the RG-LRU decay rate (softplus in fp32)
    "w0",         # RWKV6 decay bias and
    "w_lora_b",   # decay LoRA (exp(-exp(w0 + lora)) in fp32)
    "u",          # RWKV6 current-token bonus (the WKV6 kernel takes fp32)
    "ln_x",       # RWKV6 group-norm scale (applied in fp32)
    "router",     # MoE router (logits and softmax in fp32)
    "gate_attn",  # vlm cross-attention gates (tanh in fp32)
    "gate_mlp",
)


def cast_matrices(params: Params, dtype: torch.dtype) -> Params:
    """Cast every weight except the norm scales and ``_FLOAT32_LEAVES``
    to ``dtype``, once.

    The forward pass casts each weight to the activation dtype where it
    uses it (``w.to(dt)``, as the reference does with ``astype``), so a
    tree cast once to that dtype gives the same numbers while the per-step
    casts become no-ops.  Norm scales and ``_FLOAT32_LEAVES`` stay in
    their own dtype: the model reads them in float32, and a bf16 copy of
    ``log_a``, ``w0`` or ``w_lora_b`` would move every decay rate, a bf16
    ``router`` would route tokens to other experts and a bf16 vlm gate
    would change ``tanh(gate)``."""
    def cast(path: str, t: torch.Tensor) -> torch.Tensor:
        name = path.split("/")[-1]
        if name.endswith("norm") or name in _FLOAT32_LEAVES:
            return t
        return t.to(dtype)
    return tree_map(cast, params)
