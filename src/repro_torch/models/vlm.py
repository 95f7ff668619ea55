"""Llama-3.2-Vision-style VLM backbone: the ``vlm`` family.

Port of ``repro.models.vlm``: a dense GQA decoder with a gated
cross-attention layer after every ``cross_attn_every - 1`` self-attention
layers.  The vision frontend is a stub, as in the reference: the batch's
``frontend`` holds precomputed patch embeddings (B, n_frontend_tokens,
d_model), which every cross layer projects to its own k/v.

40 layers with cross every 5 are 8 super-blocks of (4 self + 1 cross).
The reference scans two levels (supers, then the stacked self layers);
here two Python loops index the same stacked ``supers/self/*`` (ns, sps,
...) and ``supers/cross/*`` (ns, ...) tensors, and the self layers are
``transformer._layer`` (the reference reuses ``T._layer``).  The gates
``gate_attn`` and ``gate_mlp`` are read in float32 (``tanh`` of them, cast
to the activation dtype), so ``cast_matrices`` keeps them float32.

Interfaces (as the reference's):
  init(cfg, generator, device)                         -> params
  forward(cfg, params, batch)                          -> (logits, aux)
  init_cache(cfg, batch, max_len, device)              -> cache
  prefill(cfg, params, tokens, max_len, frontend=None) -> (logits, cache)
  decode_step(cfg, params, cache, token, pos)          -> (logits, cache)

Cache: self k/v (ns, sps, S_max, B, K, hd), cross xk/xv (ns, B, T, K, hd)
and "len" (a Python int).  ``decode_step`` writes the new self k/v rows
in place, as ``transformer.decode_step`` does, and reads the cross k/v
through ``layers.decode_attention`` (a placed cache rank by rank).
Sharded, each self layer is ``transformer._layer`` and each cross layer
pins its input to the batch (and sequence) split, as the reference's.  ``self_attn``
(forward/prefill) replaces the self-attention, as in ``transformer``;
cross-attention (Sq != Sk) runs ``layers.cross_attention``.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig, TreeBuilder, unstack


def layout(cfg: ModelConfig) -> tuple[int, int]:
    """(n_supers, self_per_super)."""
    per = cfg.cross_attn_every
    if per <= 1 or cfg.n_layers % per:
        raise ValueError(f"vlm: {cfg.n_layers} layers do not split into "
                         f"super-blocks of {per}")
    return cfg.n_layers // per, per - 1


def _build(cfg: ModelConfig, generator: torch.Generator | None,
           device: torch.device) -> TreeBuilder:
    """Same paths, shapes, logical axes and init laws as the reference's
    ``_build``."""
    tb = TreeBuilder(cfg, device, generator)
    ns, sps = layout(cfg)
    d, hd = cfg.d_model, cfg.hd
    tb.leaf("embed/table", (cfg.padded_vocab, d), ("vocab", "table_d"),
            scale=0.02)
    tb.leaf("supers/self/attn_norm", (ns, sps, d), ("layers", "layers", None),
            init="zeros")
    tb.leaf("supers/self/mlp_norm", (ns, sps, d), ("layers", "layers", None),
            init="zeros")
    tb.leaf("supers/self/wq", (ns, sps, d, cfg.n_heads * hd),
            ("layers", "layers", "embed", "heads"))
    tb.leaf("supers/self/wk", (ns, sps, d, cfg.n_kv_heads * hd),
            ("layers", "layers", "embed", "kv"))
    tb.leaf("supers/self/wv", (ns, sps, d, cfg.n_kv_heads * hd),
            ("layers", "layers", "embed", "kv"))
    tb.leaf("supers/self/wo", (ns, sps, cfg.n_heads * hd, d),
            ("layers", "layers", "heads", "embed"))
    tb.leaf("supers/self/w_gate", (ns, sps, d, cfg.d_ff),
            ("layers", "layers", "embed", "ff"))
    tb.leaf("supers/self/w_up", (ns, sps, d, cfg.d_ff),
            ("layers", "layers", "embed", "ff"))
    tb.leaf("supers/self/w_down", (ns, sps, cfg.d_ff, d),
            ("layers", "layers", "ff", "embed"))
    tb.leaf("supers/cross/norm", (ns, d), ("layers", None), init="zeros")
    tb.leaf("supers/cross/wq", (ns, d, cfg.n_heads * hd),
            ("layers", "embed", "heads"))
    tb.leaf("supers/cross/wk", (ns, d, cfg.n_kv_heads * hd),
            ("layers", "embed", "kv"))
    tb.leaf("supers/cross/wv", (ns, d, cfg.n_kv_heads * hd),
            ("layers", "embed", "kv"))
    tb.leaf("supers/cross/wo", (ns, cfg.n_heads * hd, d),
            ("layers", "heads", "embed"))
    tb.leaf("supers/cross/gate_attn", (ns,), ("layers",), init="zeros")
    tb.leaf("supers/cross/gate_mlp", (ns,), ("layers",), init="zeros")
    tb.leaf("supers/cross/mlp_norm", (ns, d), ("layers", None), init="zeros")
    tb.leaf("supers/cross/w_gate", (ns, d, cfg.d_ff),
            ("layers", "embed", "ff"))
    tb.leaf("supers/cross/w_up", (ns, d, cfg.d_ff), ("layers", "embed", "ff"))
    tb.leaf("supers/cross/w_down", (ns, cfg.d_ff, d),
            ("layers", "ff", "embed"))
    tb.leaf("final_norm", (d,), (None,), init="zeros")
    tb.leaf("unembed", (d, cfg.padded_vocab), ("embed", "vocab"), scale=0.02)
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

def _gate(g: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return torch.tanh(g.float()).to(dt)


def _cross_block(cfg: ModelConfig, lp: dict, x: torch.Tensor,
                 img_k: torch.Tensor, img_v: torch.Tensor,
                 attend=L.cross_attention) -> torch.Tensor:
    """Gated cross-attention and gated MLP (Llama 3.2).  img_k/v:
    (B,T,K,hd).  ``attend`` is ``layers.cross_attention``, or in decode
    ``layers.decode_attention`` over all T positions (the same math,
    which reads a placed cache rank by rank)."""
    x = L.constrain_batch(x, cfg.batch_axes, cfg.seq_axes)
    dt = x.dtype
    b, s, _ = x.shape
    hd = cfg.hd
    h = L.rms_norm(x, lp["norm"])
    q = L.split_heads(h @ lp["wq"].to(dt), cfg.n_heads, hd)
    o = attend(q, img_k, img_v)
    o = o.reshape(b, s, cfg.n_heads * hd) @ lp["wo"].to(dt)
    x = x + _gate(lp["gate_attn"], dt) * o
    m = L.mlp_swiglu(lp, L.rms_norm(x, lp["mlp_norm"]))
    return x + _gate(lp["gate_mlp"], dt) * m


def _img_kv(cfg: ModelConfig, lp: dict, img: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The frontend embeddings projected to one cross layer's k/v."""
    dt = img.dtype
    k = L.split_heads(img @ lp["wk"].to(dt), cfg.n_kv_heads, cfg.hd)
    v = L.split_heads(img @ lp["wv"].to(dt), cfg.n_kv_heads, cfg.hd)
    return k, v


def _super(cfg: ModelConfig, lp: dict, x: torch.Tensor, img: torch.Tensor,
           cos: torch.Tensor, sin: torch.Tensor, attn: L.SelfAttention):
    """One super-block: its self layers, then its cross layer.  Returns
    (x', self ks, self vs, cross k, cross v); ks/vs stacked (sps, S, B, K,
    hd)."""
    _, sps = layout(cfg)
    ks, vs = [], []
    for slp in unstack(lp["self"], sps):
        x, k, v, _ = T._layer(cfg, slp, x, cos, sin, attn)
        ks.append(k.transpose(0, 1))
        vs.append(v.transpose(0, 1))
    ik, iv = _img_kv(cfg, lp["cross"], img)
    x = _cross_block(cfg, lp["cross"], x, ik, iv)
    return x, torch.stack(ks), torch.stack(vs), ik, iv


def _run(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
         img: torch.Tensor, attn: L.SelfAttention, remat: str):
    """Embedding and every super-block; returns the final hidden states
    (before the final norm) and each super's (ks, vs, xk, xv)."""
    dt = cfg.activation_dtype
    ns, _ = layout(cfg)
    x = L.embed_rows(params["embed"]["table"], tokens).to(dt)
    cos, sin = L.rope_angles(torch.arange(tokens.shape[1],
                                          device=tokens.device),
                             cfg.hd, cfg.rope_theta)
    body = L.maybe_remat(_super, remat)
    kvs = []
    for lp in unstack(params["supers"], ns):
        x, *kv = body(cfg, lp, x, img, cos, sin, attn)
        kvs.append(kv)
    return x, kvs


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            self_attn: L.SelfAttention | None = None):
    """batch: tokens (B,S) and frontend (B, T_img, d_model).  Returns
    (logits, aux), aux a float32 zero."""
    img = batch["frontend"].to(cfg.activation_dtype)
    x, _ = _run(cfg, params, batch["tokens"], img, self_attn or L.attention,
                cfg.remat)
    x = L.rms_norm(x, params["final_norm"])
    logits = x @ params["unembed"].to(x.dtype)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def cache_max_len(cfg: ModelConfig, seq_len: int) -> int:
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> dict:
    ns, sps = layout(cfg)
    dt = cfg.activation_dtype
    kv = (ns, sps, max_len, batch, cfg.n_kv_heads, cfg.hd)
    xkv = (ns, batch, cfg.n_frontend_tokens, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(kv, dtype=dt, device=device),
            "v": torch.zeros(kv, dtype=dt, device=device),
            "xk": torch.zeros(xkv, dtype=dt, device=device),
            "xv": torch.zeros(xkv, dtype=dt, device=device), "len": 0}


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            max_len: int, frontend: torch.Tensor | None = None, *,
            self_attn: L.SelfAttention | None = None
            ) -> tuple[torch.Tensor, dict]:
    """Run the prompt with the frontend (zeros if None); build the cache.
    Returns (last-token logits, cache)."""
    b, s = tokens.shape
    if max_len < s:
        raise ValueError(f"vlm.prefill: max_len {max_len} < prompt {s}")
    dt = cfg.activation_dtype
    img = (frontend if frontend is not None else torch.zeros(
        (b, cfg.n_frontend_tokens, cfg.d_model), device=tokens.device)
           ).to(dt)
    x, kvs = _run(cfg, params, tokens, img, self_attn or L.attention, "none")
    kc, vc, xk, xv = (torch.stack(t) for t in zip(*kvs))
    x = L.rms_norm(x[:, -1], params["final_norm"])
    logits = x @ params["unembed"].to(dt)
    return logits, {"k": L.pad_dim(kc, 2, max_len),
                    "v": L.pad_dim(vc, 2, max_len), "xk": xk, "xv": xv,
                    "len": s}


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                token: torch.Tensor, pos) -> tuple[torch.Tensor, dict]:
    """token: (B,) int; pos: absolute position (for RoPE).  Writes the new
    self k/v at slot ``len``, in place."""
    b = token.shape[0]
    dt = cfg.activation_dtype
    hd = cfg.hd
    ns, sps = layout(cfg)
    n = int(cache["len"])

    def cross(q, k, v):
        return L.decode_attention(q, k, v, k.shape[1])

    x = L.embed_rows(params["embed"]["table"], token).to(dt)[:, None]
    cos, sin = L.rope_angles(
        torch.as_tensor(pos, device=token.device).reshape(1), hd,
        cfg.rope_theta)
    for i, lp in enumerate(unstack(params["supers"], ns)):
        for j, slp in enumerate(unstack(lp["self"], sps)):
            h = L.rms_norm(x, slp["attn_norm"])
            q = L.split_heads(h @ slp["wq"].to(dt), cfg.n_heads, hd)
            k = L.split_heads(h @ slp["wk"].to(dt), cfg.n_kv_heads, hd)
            v = L.split_heads(h @ slp["wv"].to(dt), cfg.n_kv_heads, hd)
            q = L.apply_rope(q, cos[None], sin[None])
            k = L.apply_rope(k, cos[None], sin[None])
            L.cache_write(cache["k"], (i, j, n), k[:, 0])   # in place
            L.cache_write(cache["v"], (i, j, n), v[:, 0])
            o = L.decode_attention(q, cache["k"][i, j].transpose(0, 1),
                                   cache["v"][i, j].transpose(0, 1), n + 1)
            x = x + o.reshape(b, 1, cfg.n_heads * hd) @ slp["wo"].to(dt)
            x = x + L.mlp_swiglu(slp, L.rms_norm(x, slp["mlp_norm"]))
        x = _cross_block(cfg, lp["cross"], x, cache["xk"][i], cache["xv"][i],
                         attend=cross)
    x = L.rms_norm(x[:, 0], params["final_norm"])
    logits = x @ params["unembed"].to(dt)
    cache["len"] = n + 1
    return logits, cache
