"""Decoder-only transformer LM: the ``dense`` and ``moe`` families (GQA,
optional SWA, optional MoE).

Port of ``repro.models.transformer`` for the dense configs (olmo-1b,
granite-3-8b, codeqwen1.5-7b, llama3-405b) and the MoE ones (mixtral-8x7b:
top-2 and SWA; llama4-scout-17b-a16e: top-1).  The reference scans over
stacked layer params; here a Python loop indexes the same stacked
``layers/*`` tensors.

Interfaces (as the reference's):
  init(cfg, generator, device)               -> params
  forward(cfg, params, batch)                -> (logits, aux)
  init_cache(cfg, batch, max_len, device)    -> cache
  prefill(cfg, params, tokens, max_len)      -> (logits_last, cache)
  decode_step(cfg, params, cache, token, pos)-> (logits, cache)

``aux`` is the sum over layers of the MoE blocks' load-balancing losses
(zero for the dense family); ``zoo.loss_fn`` adds it with its weight.

KV cache layout: k/v (L, S_max, B, K, hd) + "len" (a Python int).
``decode_step`` writes the new (L, B, K, hd) row into the cache tensors IN
PLACE (the reference returns a fresh cache); it returns the same dict with
"len" advanced.  A cache placed on a mesh (``serving.kvcache``) is written
by ``layers.cache_write`` (each rank its own slice) and read by
``layers.decode_attention`` rank by rank.

``self_attn`` (forward/prefill) replaces the prefill self-attention with
another function of the same signature, e.g. the kernel's plain version,
so one run can hold the kernel path against it.  ``cfg.remat == "full"``
checkpoints each layer (``layers.maybe_remat``), as the reference does
around its scan body.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig, TreeBuilder, unstack


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _build(cfg: ModelConfig, generator: torch.Generator | None,
           device: torch.device) -> TreeBuilder:
    """Same paths, shapes, logical axes and init laws as the reference's
    ``_build``."""
    tb = TreeBuilder(cfg, device, generator)
    d, hd = cfg.d_model, cfg.hd
    nl = cfg.n_layers
    tb.leaf("embed/table", (cfg.padded_vocab, d), ("vocab", "table_d"),
            scale=0.02)
    tb.leaf("layers/attn_norm", (nl, d), ("layers", None), init="zeros")
    tb.leaf("layers/mlp_norm", (nl, d), ("layers", None), init="zeros")
    tb.leaf("layers/wq", (nl, d, cfg.n_heads * hd),
            ("layers", "embed", "heads"))
    tb.leaf("layers/wk", (nl, d, cfg.n_kv_heads * hd),
            ("layers", "embed", "kv"))
    tb.leaf("layers/wv", (nl, d, cfg.n_kv_heads * hd),
            ("layers", "embed", "kv"))
    tb.leaf("layers/wo", (nl, cfg.n_heads * hd, d),
            ("layers", "heads", "embed"))
    if cfg.moe_experts:
        e = cfg.moe_experts
        tb.leaf("layers/router", (nl, d, e), ("layers", "embed", None))
        tb.leaf("layers/w_gate", (nl, e, d, cfg.d_ff),
                ("layers", "expert", "embed", "ff"))
        tb.leaf("layers/w_up", (nl, e, d, cfg.d_ff),
                ("layers", "expert", "embed", "ff"))
        tb.leaf("layers/w_down", (nl, e, cfg.d_ff, d),
                ("layers", "expert", "ff", "embed"))
    else:
        tb.leaf("layers/w_gate", (nl, d, cfg.d_ff), ("layers", "embed", "ff"))
        tb.leaf("layers/w_up", (nl, d, cfg.d_ff), ("layers", "embed", "ff"))
        tb.leaf("layers/w_down", (nl, cfg.d_ff, d), ("layers", "ff", "embed"))
    tb.leaf("final_norm", (d,), (None,), init="zeros")
    if not cfg.tie_embeddings:
        tb.leaf("unembed", (d, cfg.padded_vocab), ("embed", "vocab"),
                scale=0.02)
    return tb


def init(cfg: ModelConfig, generator: torch.Generator | None,
         device: torch.device) -> dict:
    return _build(cfg, generator, device).build()


def specs(cfg: ModelConfig) -> dict:
    """The logical-axes tree of ``init``'s params (built on ``meta``)."""
    return _build(cfg, None, torch.device("meta")).specs


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _norm(cfg: ModelConfig, x: torch.Tensor, scale: torch.Tensor
          ) -> torch.Tensor:
    if cfg.norm == "nonparam":
        return L.nonparam_layer_norm(x)
    if cfg.norm == "layernorm":
        return L.layer_norm(x, 1.0 + scale, None)
    return L.rms_norm(x, scale)


def unembed(cfg: ModelConfig, params: dict, x: torch.Tensor
             ) -> torch.Tensor:
    dt = x.dtype
    unemb = (params["embed"]["table"].to(dt).T if cfg.tie_embeddings
             else params["unembed"].to(dt))
    logits = L.tp_matmul(x, unemb, "column")        # vocab-split
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _mlp(cfg: ModelConfig, lp: dict, h: torch.Tensor, *,
         reduce: bool = True
         ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The block's MLP: the MoE block and its aux loss, or the dense MLP
    and None (``reduce=False``: a sharded dense output's partial sum left
    to the caller)."""
    if cfg.moe_experts:
        return L.moe_block(lp, h, n_experts=cfg.moe_experts,
                           top_k=cfg.moe_top_k,
                           capacity_factor=cfg.moe_capacity_factor)
    return L.apply_mlp(cfg.act, lp, h, reduce=reduce), None


def embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tokens (B,S) -> (x (B,S,D) in the activation dtype, RoPE cos, sin);
    a sharded table is read by ``layers.embed_rows``."""
    x = L.embed_rows(params["embed"]["table"], tokens).to(
        cfg.activation_dtype)
    cos, sin = L.rope_angles(torch.arange(tokens.shape[1],
                                          device=tokens.device),
                             cfg.hd, cfg.rope_theta)
    return x, cos, sin


def attention_half(cfg: ModelConfig, lp: dict, x: torch.Tensor,
                   cos: torch.Tensor, sin: torch.Tensor,
                   self_attn: L.SelfAttention
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A block's first half: self-attention and its residual.  x: (B,S,D).
    Returns (x', k, v).  With ``cfg.seq_axes`` (sequence parallelism, on
    DTensors) the norm's output is gathered into the seq-unsharded
    tensor-parallel region and the block's output goes back to the
    seq-sharded boundary before the residual add, as the reference's
    ``_layer``."""
    dt = x.dtype
    hd = cfg.hd
    h = _norm(cfg, x, lp["attn_norm"])
    if cfg.seq_axes:
        h = L.constrain_batch(h, cfg.batch_axes, ())   # gather into TP
    q, k, v = (L.split_heads(L.tp_matmul(h, lp[w].to(dt), "column"), n, hd)
               for w, n in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                            ("wv", cfg.n_kv_heads)))
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    o = self_attn(q, k, v, causal=True, window=cfg.window)
    o = L.tp_matmul(L.merge_heads(o), lp["wo"].to(dt), "row",
                    reduce=not cfg.seq_axes)
    if cfg.seq_axes:
        o = L.seq_boundary(o, cfg.batch_axes, cfg.seq_axes)  # RS back
    return x + o, k, v


def mlp_half(cfg: ModelConfig, lp: dict, x: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """A block's second half: the MLP (or MoE block) and its residual.
    Returns (x', aux), aux None in a dense block."""
    h = _norm(cfg, x, lp["mlp_norm"])
    if cfg.seq_axes:
        h = L.constrain_batch(h, cfg.batch_axes, ())
    m, aux = _mlp(cfg, lp, h, reduce=not cfg.seq_axes)
    if cfg.seq_axes:
        m = L.seq_boundary(m, cfg.batch_axes, cfg.seq_axes)
    return x + m, aux


def last_logits(cfg: ModelConfig, params: dict, x: torch.Tensor
                ) -> torch.Tensor:
    """The final norm and the logits of the last position: (B,S,D) ->
    (B,V), as ``prefill`` returns them."""
    x = _norm(cfg, x, params["final_norm"])[:, -1:]
    return unembed(cfg, params, x)[:, -1]


def _layer(cfg: ModelConfig, lp: dict, x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor, self_attn: L.SelfAttention
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor | None]:
    """One transformer block. x: (B,S,D). Returns (x', k, v, aux), aux
    None in a dense block.  With ``cfg.batch_axes`` or ``cfg.seq_axes``
    the residual stream is pinned at the layer boundary
    (``layers.seq_boundary``), as the reference's ``_layer``."""
    x = L.seq_boundary(x, cfg.batch_axes, cfg.seq_axes)
    x, k, v = attention_half(cfg, lp, x, cos, sin, self_attn)
    x, aux = mlp_half(cfg, lp, x)
    return x, k, v, aux


def forward(cfg: ModelConfig, params: dict, batch: dict,
            collect_cache: bool = False, last_only: bool = False, *,
            self_attn: L.SelfAttention | None = None):
    """batch: {"tokens": (B,S) int}. Returns (logits, aux_loss[, kv]).

    ``last_only``: unembed only the final position (prefill path)."""
    x, cos, sin = embed(cfg, params, batch["tokens"])
    attn = self_attn or L.attention
    layer = L.maybe_remat(_layer, cfg.remat)
    ks, vs, auxes = [], [], []
    for lp in unstack(params["layers"], cfg.n_layers):
        x, k, v, layer_aux = layer(cfg, lp, x, cos, sin, attn)
        if collect_cache:
            ks.append(k.transpose(0, 1))
            vs.append(v.transpose(0, 1))
        if layer_aux is not None:
            auxes.append(layer_aux)
    aux = (torch.stack(auxes).sum() if auxes else
           torch.zeros((), dtype=torch.float32, device=x.device))
    if cfg.seq_axes:
        # the sequence gathered into the unembed, as each block gathers
        # it into its projections: torch 2.11's DTensor flattens no (B, S)
        # pair with S split for the logits' GEMM
        x = L.constrain_batch(x, cfg.batch_axes, ())
    x = _norm(cfg, x, params["final_norm"])
    if last_only:
        x = x[:, -1:]
    logits = unembed(cfg, params, x)
    if collect_cache:
        return logits, aux, (torch.stack(ks), torch.stack(vs))  # (L,S,B,K,hd)
    return logits, aux


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> dict:
    shape = (cfg.n_layers, max_len, batch, cfg.n_kv_heads, cfg.hd)
    dt = cfg.activation_dtype
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device), "len": 0}


def cache_max_len(cfg: ModelConfig, seq_len: int) -> int:
    """SWA archs bound the live cache by the window size."""
    if cfg.window is not None:
        return min(seq_len, cfg.window)
    return seq_len


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            max_len: int, *, self_attn: L.SelfAttention | None = None
            ) -> tuple[torch.Tensor, dict]:
    """Run the full prompt; build the cache. Returns (last-token logits,
    cache).  If max_len < prompt length (SWA), keep the trailing window."""
    s = tokens.shape[1]
    logits, _, (kc, vc) = forward(cfg, params, {"tokens": tokens},
                                  collect_cache=True, last_only=True,
                                  self_attn=self_attn)
    if max_len >= s:
        kc, vc = L.pad_dim(kc, 1, max_len), L.pad_dim(vc, 1, max_len)
    else:
        kc = kc[:, s - max_len:].contiguous()
        vc = vc[:, s - max_len:].contiguous()
    return logits[:, -1], {"k": kc, "v": vc, "len": min(s, max_len)}


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                token: torch.Tensor, pos) -> tuple[torch.Tensor, dict]:
    """token: (B,) int; pos: absolute position (for RoPE).  Writes the new
    k/v at slot len % max_len (ring buffer for SWA), in place."""
    b = token.shape[0]
    dt = cfg.activation_dtype
    hd = cfg.hd
    max_len = cache["k"].shape[1]
    n = int(cache["len"])
    slot = n % max_len
    n_valid = min(n + 1, max_len)
    x = L.embed_rows(params["embed"]["table"], token).to(dt)[:, None]
    cos, sin = L.rope_angles(
        torch.as_tensor(pos, device=token.device).reshape(1), hd,
        cfg.rope_theta)
    for i, lp in enumerate(unstack(params["layers"], cfg.n_layers)):
        h = _norm(cfg, x, lp["attn_norm"])
        q, k, v = (L.split_heads(L.tp_matmul(h, lp[w].to(dt), "column"),
                                 n, hd)
                   for w, n in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                                ("wv", cfg.n_kv_heads)))
        q = L.apply_rope(q, cos[None], sin[None])
        k = L.apply_rope(k, cos[None], sin[None])
        L.cache_write(cache["k"], (i, slot), k[:, 0])   # in place
        L.cache_write(cache["v"], (i, slot), v[:, 0])
        o = L.decode_attention(
            q, cache["k"][i].transpose(0, 1), cache["v"][i].transpose(0, 1),
            n_valid, window=None)   # ring buffer already bounds the window
        x = x + L.tp_matmul(o.reshape(b, 1, cfg.n_heads * hd),
                            lp["wo"].to(dt), "row")
        x = x + _mlp(cfg, lp, _norm(cfg, x, lp["mlp_norm"]))[0]
    x = _norm(cfg, x, params["final_norm"])
    logits = unembed(cfg, params, x)[:, 0]
    cache["len"] = n + 1
    return logits, cache
