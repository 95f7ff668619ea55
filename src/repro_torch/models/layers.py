"""Shared layers: norms, RoPE, attention, MLPs, the MoE block, the RG-LRU
and RWKV6 recurrences.

Port of ``repro.models.layers`` (norms through MLPs, the MoE block, the
RG-LRU functions and the RWKV6 decode step).  Each function keeps the reference's
dtype behaviour: norms and RoPE compute in float32 and cast back,
attention scores accumulate in float32 and the probabilities are cast to
the activation dtype before the PV product; the RG-LRU gates are float32
sigmoids and its carry is float32.

On CUDA, prefill self-attention goes through the hand-written flash
attention kernel and the prefill RG-LRU scan through the hand-written
RG-LRU kernel; everything else runs the dense math below (the MoE block
too: the reference computes it outside any Pallas kernel).  The RWKV6
prefill recurrence goes to the WKV6 kernel from ``models/rwkv6.py``; its
decode step is here.  The kernels are forward-only: where autograd needs
a gradient through one, its backward recomputes the differentiable torch
version of the same function (``kernels._grad.KernelFn``: here
``_attention_torch``, in the recurrences' ``ops.py`` their plain scans), as
the reference differentiates its jnp math.

Sharded activations are DTensors (``torch.distributed.tensor``):
``constrain_batch`` and ``seq_boundary`` pin their batch (and sequence)
dims to mesh axes, as the reference's sharding constraints do, and
attention on DTensors runs on each rank's local tensors (no kernel takes
a DTensor).
"""

from __future__ import annotations

import functools
import math
from collections.abc import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.hw.cost import counts_meta
from repro_torch.kernels._grad import KernelFn, needs_grad
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rglru import rglru, rglru_plain
from repro_torch.models.common import is_dtensor


def _batch_placements(mesh, ndim: int, batch_axes: tuple,
                      seq_axes: tuple) -> tuple:
    """One placement a mesh dim: Shard(0) on the batch axes, Shard(1) on
    the sequence axes (a tensor of 2 dims or more), Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    unknown = [a for a in (*batch_axes, *seq_axes) if a not in names]
    if unknown:
        raise ValueError(f"axes {unknown} are not axes of the mesh {names}")
    return tuple(Shard(0) if n in batch_axes
                 else Shard(1) if n in seq_axes and ndim >= 2
                 else Replicate() for n in names)


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with its partial sums reduced (Partial -> Replicate on
    those mesh dims), its other placements kept."""
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in x.placements))


def constrain_batch(x: torch.Tensor, batch_axes: tuple,
                    seq_axes: tuple = ()) -> torch.Tensor:
    """Pin the (batch[, seq]) dims' sharding of a (B,S,...) activation:
    a DTensor ``redistribute`` to Shard(0) on ``batch_axes`` (and Shard(1)
    on ``seq_axes``, sequence parallelism), replicated on its mesh's other
    axes.  A no-op when both are empty (single-device paths) and on a
    plain tensor, which holds the whole activation."""
    if (not batch_axes and not seq_axes) or not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, _batch_placements(
        x.device_mesh, x.ndim, tuple(batch_axes), tuple(seq_axes)))


class _SeqBoundary(torch.autograd.Function):
    """Identity whose forward pins the primal's placement and whose
    backward passes the cotangent on as it comes."""

    @staticmethod
    def forward(ctx, x, batch_axes, seq_axes):
        return constrain_batch(x, batch_axes, seq_axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def seq_boundary(x: torch.Tensor, batch_axes: tuple, seq_axes: tuple
                 ) -> torch.Tensor:
    """Sequence-parallel boundary: constrain the PRIMAL to (batch,
    seq-sharded) but leave the COTANGENT unconstrained, as the reference's
    custom VJP does (pinning the cotangent too forces seq-sharded
    weight-gradient contractions that conflict with the tensor-parallel
    sharding on the same mesh axis).  A no-op as ``constrain_batch``."""
    if (not batch_axes and not seq_axes) or not is_dtensor(x):
        return x
    return _SeqBoundary.apply(x, tuple(batch_axes), tuple(seq_axes))


def require_unsharded(cfg, family: str) -> None:
    """Raise unless ``cfg`` asks for no activation sharding: only the
    dense family runs sharded."""
    if cfg.batch_axes or cfg.seq_axes:
        raise NotImplementedError(
            f"{family}: a sharded batch (batch_axes {cfg.batch_axes}, "
            f"seq_axes {cfg.seq_axes}) runs only in the dense family so "
            "far; see ROADMAP.md")


def maybe_remat(body: Callable, remat: str) -> Callable:
    """``body`` under per-layer activation checkpointing when ``remat`` is
    "full" (the reference's ``maybe_remat`` around each scan body): its
    activations are recomputed in the backward, not kept."""
    if remat == "full":
        return functools.partial(checkpoint, body, use_reentrant=False)
    return body


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor | None, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    if scale is not None:
        y = y * (1.0 + scale.float())
    return y.to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor | None,
               bias: torch.Tensor | None, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


def nonparam_layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm (no scale/bias)."""
    return layer_norm(x, None, None, eps)


def apply_norm(kind: str, x: torch.Tensor, p: dict | None) -> torch.Tensor:
    if kind == "rms":
        return rms_norm(x, p["scale"] if p else None)
    if kind == "layernorm":
        return layer_norm(x, p["scale"] if p else None,
                          p.get("bias") if p else None)
    if kind == "nonparam":
        return nonparam_layer_norm(x)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# RoPE (split halves, float32)
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> cos/sin (..., S, head_dim//2), float32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., S, H, D). cos/sin: (..., S, D/2) broadcast over heads."""
    dt = x.dtype
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(dt)


# ---------------------------------------------------------------------------
# Attention (GQA, causal, sliding window)
# ---------------------------------------------------------------------------

def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B,S,K,D) -> (B,S,K*n_rep,D)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _attention_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool, window: int | None, q_offset: int,
                     softcap: float) -> torch.Tensor:
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    k = repeat_kv(k, h // kh)
    v = repeat_kv(v, h // kh)
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    logits = torch.where(mask[None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# above this many score elements per (B,H) pair, the dense path runs in
# q-chunks so the (B,H,Sq,Sk) transient stays bounded (as the reference)
_CHUNK_THRESHOLD = 1 << 26
_Q_CHUNK = 1024

SelfAttention = Callable[..., torch.Tensor]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              q_offset: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """q: (B,Sq,H,D), k/v: (B,Sk,K,D) with H % K == 0.  Returns (B,Sq,H,D).

    On CUDA, self-attention (Sq == Sk, ``q_offset`` 0, no softcap) runs
    the flash attention kernel, through ``KernelFn`` (backward: the dense
    math's) where autograd needs its gradient; so does a meta tensor under
    a ``hw.cost.CostCounter``, so that the dry-run counts the card's
    path.  Everything else runs the dense math, in q-chunks above
    ``_CHUNK_THRESHOLD`` score elements.  DTensors go rank by rank
    (``_attention_sharded``) through the same choice on their local
    tensors."""
    sq, sk = q.shape[1], k.shape[1]
    if is_dtensor(q):
        return _attention_sharded(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset, softcap=softcap)
    if (q.is_cuda or counts_meta(q)) and sq == sk and q_offset == 0 \
            and not softcap:
        if needs_grad(q, k, v):
            return KernelFn.apply(flash_attention, _attention_torch,
                                  {"causal": causal, "window": window},
                                  q, k, v)
        return flash_attention(q, k, v, causal=causal, window=window)
    return _attention_torch(q, k, v, causal=causal, window=window,
                            q_offset=q_offset, softcap=softcap)


def _attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       **kw) -> torch.Tensor:
    """Attention of DTensors, rank by rank: ``attention`` on each rank's
    own batch rows and heads, so a rank computes what one card computes
    (on CUDA the flash kernel forward and the dense math's backward).
    q, k and v go to one placement (Shard(0) and Shard(2) where q has
    them, Replicate elsewhere; k and v then hold the kv heads of the
    rank's q heads, K dividing as H does), each rank computes on its
    local tensors, and the output keeps that placement.  Attention mixes
    neither rows nor heads, so nothing is exchanged."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    placements = tuple(p if p in (Shard(0), Shard(2)) else Replicate()
                       for p in q.placements)
    local = [t.redistribute(mesh, placements).to_local() for t in (q, k, v)]
    # contiguous: the global stride given below is the contiguous one
    o = attention(*local, **kw).contiguous()
    shape = (*q.shape[:3], v.shape[3])
    return DTensor.from_local(
        o, mesh, placements, run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def _attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool, window: int | None, q_offset: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """The dense math, in q-chunks above ``_CHUNK_THRESHOLD`` score
    elements."""
    sq, sk = q.shape[1], k.shape[1]
    if sq * sk < _CHUNK_THRESHOLD or sq <= _Q_CHUNK or sq % _Q_CHUNK:
        return _attention_dense(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, softcap=softcap)
    outs = [_attention_dense(q[:, st:st + _Q_CHUNK], k, v, causal=causal,
                             window=window, q_offset=q_offset + st,
                             softcap=softcap)
            for st in range(0, sq, _Q_CHUNK)]
    return torch.cat(outs, dim=1)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    softcap: float = 0.0) -> torch.Tensor:
    """Unmasked attention of q (B,Sq,H,D) over k/v (B,Sk,K,D), as the
    reference's: ``attention`` with ``causal=False`` (the dense math where
    Sq != Sk)."""
    return attention(q, k, v, causal=False, window=None, softcap=softcap)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     window: int | None = None) -> torch.Tensor:
    """Single-token decode: q (B,1,H,D), caches (B,S,K,D) with valid
    prefix ``cache_len``.  Position of q is cache_len-1 (the newest token
    is already written into the cache)."""
    b, s, kh, d = k_cache.shape
    h = q.shape[2]
    kq = repeat_kv(k_cache, h // kh)
    vq = repeat_kv(v_cache, h // kh)
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kq.float()) * scale
    kpos = torch.arange(s, device=q.device)[None, None, None, :]
    n = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1, 1, 1)
    valid = kpos < n
    if window is not None:
        valid &= kpos >= n - window
    logits = torch.where(valid, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vq)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    gate = x @ p["w_gate"].to(dt)
    up = x @ p["w_up"].to(dt)
    act = F.silu(gate.float()).to(dt) * up
    return act @ p["w_down"].to(dt)


def mlp_gelu(p: dict, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = x @ p["w_up"].to(dt)
    if "b_up" in p:
        h = h + p["b_up"].to(dt)
    h = F.gelu(h.float(), approximate="tanh").to(dt)
    out = h @ p["w_down"].to(dt)
    if "b_down" in p:
        out = out + p["b_down"].to(dt)
    return out


def apply_mlp(kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    return mlp_swiglu(p, x) if kind == "swiglu" else mlp_gelu(p, x)


# ---------------------------------------------------------------------------
# MoE (GShard-style capacity dispatch; top-1 and top-2)
# ---------------------------------------------------------------------------

# dispatch-group size: a longer sequence is split into groups of this many
# tokens (the reference's 4096), so capacity does not grow with S
MOE_GROUP = 4096


def moe_capacity(s: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Slots per expert in a group of ``s`` tokens: ceil(int(f*S*k) / E),
    at least 4 and at most ``s`` (so 1 at decode)."""
    capacity = max(4, -(-int(capacity_factor * s * top_k) // n_experts))
    return min(capacity, s)


def moe_route(p: dict, x: torch.Tensor, top_k: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router's fp32 softmax probs (B,S,E) and its top-k gate values
    and expert indices (B,S,k).  A stable descending sort breaks ties by
    the lower index, as ``lax.top_k`` does (``torch.topk`` does not); the
    gate values keep the gradient of the probs they were taken from."""
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, vals[..., :top_k], idx[..., :top_k]


def moe_block(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> (out, aux_loss).  Experts stacked on dim 0 of
    p['w_gate'|'w_up'|'w_down']: (E, D, F) / (E, F, D); p['router'] (D, E)
    read in fp32.

    The reference's GShard GROUPED dispatch: each batch row (or each
    ``MOE_GROUP``-token piece of a longer one) is a group with its own
    capacity, and dense one-hot dispatch/combine tensors (B, S, E, C) move
    tokens to the experts' buffers.  A token's slot-j route goes to the
    expert's next buffer position after every earlier route to that
    expert (all of slot j-1's, kept or dropped); a route at or past
    capacity is dropped and the token keeps only its residual there.  Aux
    is the Switch load-balancing loss of slot 0, in fp32."""
    b, s, d = x.shape
    dt = x.dtype
    if s > MOE_GROUP:
        if s % MOE_GROUP:
            raise ValueError(f"moe_block: S={s} above {MOE_GROUP} must be a "
                             f"multiple of it")
        out, aux = moe_block(p, x.reshape(b * (s // MOE_GROUP), MOE_GROUP, d),
                             n_experts=n_experts, top_k=top_k,
                             capacity_factor=capacity_factor)
        return out.reshape(b, s, d), aux
    capacity = moe_capacity(s, n_experts, top_k, capacity_factor)
    probs, gate_vals, gate_idx = moe_route(p, x, top_k)
    me = probs.mean(dim=1)                                         # (B,E)
    ce = F.one_hot(gate_idx[..., 0], n_experts).float().mean(dim=1)
    aux = n_experts * torch.mean(torch.sum(me * ce, dim=-1))

    slots = torch.arange(capacity, device=x.device)
    combine = torch.zeros((b, s, n_experts, capacity), dtype=torch.float32,
                          device=x.device)
    dispatch = torch.zeros((b, s, n_experts, capacity), dtype=torch.bool,
                           device=x.device)
    occupancy = torch.zeros((b, n_experts), dtype=torch.long,
                            device=x.device)
    for slot in range(top_k):
        onehot = F.one_hot(gate_idx[..., slot], n_experts)        # (B,S,E)
        pos = torch.cumsum(onehot, dim=1) - 1 + occupancy[:, None, :]
        pos = torch.where(onehot > 0, pos, -1)
        occupancy = occupancy + onehot.sum(dim=1)
        # a kept route's buffer position; -1 and positions past capacity
        # match no slot
        oh_cap = pos[..., None] == slots                          # (B,S,E,C)
        combine = combine + oh_cap * gate_vals[..., slot, None, None]
        dispatch |= oh_cap

    expert_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(dt), x)
    gate = torch.einsum("ebcd,edf->ebcf", expert_in, p["w_gate"].to(dt))
    up = torch.einsum("ebcd,edf->ebcf", expert_in, p["w_up"].to(dt))
    act = F.silu(gate.float()).to(dt) * up
    expert_out = torch.einsum("ebcf,efd->ebcd", act, p["w_down"].to(dt))
    out = torch.einsum("bsec,ebcd->bsd", combine.to(dt), expert_out)
    return out, aux


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma)
# ---------------------------------------------------------------------------

RglruScan = Callable[[torch.Tensor, torch.Tensor],
                    tuple[torch.Tensor, torch.Tensor]]


def rglru_scan(a: torch.Tensor, x: torch.Tensor,
               h0: torch.Tensor | None = None, *,
               scan: RglruScan | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + sqrt(1-a_t^2) * x_t, elementwise.

    a, x: (B,S,R) with a in (0,1).  Returns (h (B,S,R) in x's dtype,
    h_last (B,R) float32).  From h = 0 (prefill) the scan runs ``scan``,
    by default the RG-LRU wrapper (the kernel on CUDA, the exact
    sequential scan on the CPU); with a carried ``h0`` (decode) it runs
    the plain scan from ``h0``, which is the reference's fold of ``h0``
    into step 0.  The reference's associative scan sums in another order:
    the two agree to about 1e-5 in float32."""
    if h0 is not None:
        return rglru_plain(a, x, h0)
    return (scan or rglru)(a, x)


def _rglru_decay(p: dict, x: torch.Tensor, c: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The float32 input gate and the float32 decay a of the RG-LRU."""
    dt = x.dtype
    gate_x = torch.sigmoid((x @ p["w_gx"].to(dt)).float())
    gate_a = torch.sigmoid((x @ p["w_ga"].to(dt)).float())
    log_a = -c * gate_a * F.softplus(p["log_a"].float())
    return gate_x, torch.exp(log_a)


def rglru_block(p: dict, x: torch.Tensor, h0: torch.Tensor | None = None,
                c: float = 8.0, *, scan: RglruScan | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Griffin's recurrent block core: input/recurrence gates + RG-LRU.

    x: (B,S,R).  p: log_a (R,) float32, w_gx/w_ga (R,R).  The decay a is
    cast to x's dtype before the scan and the gated input is rounded to
    it, as in the reference."""
    dt = x.dtype
    gate_x, a = _rglru_decay(p, x, c)
    gated_x = (x.float() * gate_x).to(dt)
    return rglru_scan(a.to(dt), gated_x, h0, scan=scan)


def rglru_step(p: dict, x_t: torch.Tensor, h_prev: torch.Tensor,
               c: float = 8.0) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step: x_t (B,R), h_prev (B,R) -> (out, h_new), with the
    decay and gated input kept in float32 (the reference's step form)."""
    gate_x, a = _rglru_decay(p, x_t, c)
    xg = x_t.float() * gate_x
    h = a * h_prev.float() + torch.sqrt(
        torch.clamp(1.0 - a * a, min=1e-12)) * xg
    return h.to(x_t.dtype), h


# ---------------------------------------------------------------------------
# RWKV6 decode step (prefill runs the WKV6 kernel or its plain version)
# ---------------------------------------------------------------------------

def rwkv6_step(r_t: torch.Tensor, k_t: torch.Tensor, v_t: torch.Tensor,
               w_t: torch.Tensor, u: torch.Tensor, state: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step. r_t..w_t: (B,H,D); state (B,H,D,D) float32."""
    rf, kf, vf, wf = (t.float() for t in (r_t, k_t, v_t, w_t))
    uf = u.float()
    kv = torch.einsum("bhd,bhv->bhdv", kf, vf)
    out = torch.einsum("bhd,bhdv->bhv", rf, state + uf[None, :, :, None] * kv)
    new_state = state * wf[..., None] + kv
    return out.to(r_t.dtype), new_state
