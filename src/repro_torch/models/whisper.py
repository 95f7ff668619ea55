"""Whisper-small-style encoder-decoder (arXiv:2212.04356): the ``audio``
family.

Port of ``repro.models.whisper``.  Only the transformer backbone is
modelled, as in the reference: the batch's ``frontend`` holds precomputed
frame embeddings (B, n_frontend_tokens=1500, d_model) in place of the
mel and conv stack.

Encoder: bidirectional self-attention, sinusoidal positions, LayerNorm
and a GELU (tanh) MLP.  Decoder: causal self-attention, cross-attention
over the encoder output, learned positions (``pos_embed``, 4096 rows) and
an unembedding tied to ``embed/table``.  The norms are
``layers.layer_norm(x, scale)`` with scales initialised to ones, not
``transformer._norm``'s ``1 + scale``; there is no RoPE.

Interfaces (as the reference's):
  init(cfg, generator, device)                         -> params
  encode(cfg, params, frames)                          -> (B,T,d)
  forward(cfg, params, batch)                          -> (logits, aux)
  init_cache(cfg, batch, max_len, device)              -> cache
  prefill(cfg, params, tokens, max_len, frontend=None) -> (logits, cache)
  decode_step(cfg, params, cache, token, pos)          -> (logits, cache)

Cache: decoder self k/v (nd, S_max, B, K, hd), cross xk/xv (nd, T, B, K,
hd) and "len" (a Python int); the encoder runs once, at prefill, and
``decode_step`` writes the new self k/v rows in place and reads every
cached k/v through ``layers.decode_attention`` (a placed cache rank by
rank).  Sharded, each encoder and decoder layer pins its input to the
batch (and sequence) split, as the reference's.  ``self_attn``
(encode/forward/prefill) replaces both self-attentions (the encoder's is
non-causal); cross-attention runs ``layers.cross_attention``.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig, TreeBuilder, unstack

N_POSITIONS = 4096     # rows of the decoder's learned position table


def _attn_leaves(tb: TreeBuilder, prefix: str, n: int, cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.hd
    tb.leaf(f"{prefix}/wq", (n, d, cfg.n_heads * hd),
            ("layers", "embed", "heads"))
    tb.leaf(f"{prefix}/wk", (n, d, cfg.n_kv_heads * hd),
            ("layers", "embed", "kv"))
    tb.leaf(f"{prefix}/wv", (n, d, cfg.n_kv_heads * hd),
            ("layers", "embed", "kv"))
    tb.leaf(f"{prefix}/wo", (n, cfg.n_heads * hd, d),
            ("layers", "heads", "embed"))


def _mlp_leaves(tb: TreeBuilder, prefix: str, n: int, cfg: ModelConfig):
    tb.leaf(f"{prefix}/w_up", (n, cfg.d_model, cfg.d_ff),
            ("layers", "embed", "ff"))
    tb.leaf(f"{prefix}/w_down", (n, cfg.d_ff, cfg.d_model),
            ("layers", "ff", "embed"))


def _build(cfg: ModelConfig, generator: torch.Generator | None,
           device: torch.device) -> TreeBuilder:
    """Same paths, shapes, logical axes and init laws as the reference's
    ``_build``."""
    tb = TreeBuilder(cfg, device, generator)
    d = cfg.d_model
    ne, nd = cfg.encoder_layers, cfg.n_layers
    tb.leaf("embed/table", (cfg.padded_vocab, d), ("vocab", "table_d"),
            scale=0.02)
    tb.leaf("pos_embed", (N_POSITIONS, d), (None, "embed"), scale=0.01)
    tb.leaf("enc/attn_norm", (ne, d), ("layers", None), init="ones")
    tb.leaf("enc/mlp_norm", (ne, d), ("layers", None), init="ones")
    _attn_leaves(tb, "enc", ne, cfg)
    _mlp_leaves(tb, "enc", ne, cfg)
    tb.leaf("enc_final_norm", (d,), (None,), init="ones")
    tb.leaf("dec/self_norm", (nd, d), ("layers", None), init="ones")
    tb.leaf("dec/cross_norm", (nd, d), ("layers", None), init="ones")
    tb.leaf("dec/mlp_norm", (nd, d), ("layers", None), init="ones")
    _attn_leaves(tb, "dec/self", nd, cfg)
    _attn_leaves(tb, "dec/cross", nd, cfg)
    _mlp_leaves(tb, "dec", nd, cfg)
    tb.leaf("final_norm", (d,), (None,), init="ones")
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

def _norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return L.layer_norm(x, scale, None)


def _heads(x: torch.Tensor, w: torch.Tensor, n: int, hd: int
           ) -> torch.Tensor:
    return L.split_heads(L.tp_matmul(x, w.to(x.dtype), "column"), n, hd)


def _out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return L.tp_matmul(L.merge_heads(o), w.to(o.dtype), "row")


def _self(cfg: ModelConfig, lp: dict, h: torch.Tensor,
          attn: L.SelfAttention, causal: bool):
    """Self-attention of the normed ``h``: (output, k, v)."""
    q = _heads(h, lp["wq"], cfg.n_heads, cfg.hd)
    k = _heads(h, lp["wk"], cfg.n_kv_heads, cfg.hd)
    v = _heads(h, lp["wv"], cfg.n_kv_heads, cfg.hd)
    return _out(attn(q, k, v, causal=causal, window=None), lp["wo"]), k, v


def _sinusoid(s: int, d: int, device: torch.device) -> torch.Tensor:
    """(S, d) float32: sin then cos of pos * exp(-i / (half-1) * ln 1e4)."""
    half = d // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=device)
                      / (half - 1) * torch.log(torch.tensor(
                          10000.0, device=device)))
    ang = torch.arange(s, device=device).float()[:, None] * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def _enc_layer(cfg: ModelConfig, lp: dict, x: torch.Tensor,
               attn: L.SelfAttention) -> torch.Tensor:
    x = L.constrain_batch(x, cfg.batch_axes, cfg.seq_axes)
    o, _, _ = _self(cfg, lp, _norm(x, lp["attn_norm"]), attn, causal=False)
    x = x + o
    return x + L.mlp_gelu(lp, _norm(x, lp["mlp_norm"]))


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor, *,
           self_attn: L.SelfAttention | None = None) -> torch.Tensor:
    """frames: (B,T,d) stub embeddings -> encoder states (B,T,d)."""
    dt = cfg.activation_dtype
    s = frames.shape[1]
    x = frames.to(dt) + _sinusoid(s, cfg.d_model, frames.device)[None].to(dt)
    layer = L.maybe_remat(_enc_layer, cfg.remat)
    for lp in unstack(params["enc"], cfg.encoder_layers):
        x = layer(cfg, lp, x, self_attn or L.attention)
    return _norm(x, params["enc_final_norm"])


def _dec_layer(cfg: ModelConfig, lp: dict, x: torch.Tensor,
               enc: torch.Tensor, attn: L.SelfAttention):
    """One decoder block; returns (x', k, v, xk, xv)."""
    x = L.constrain_batch(x, cfg.batch_axes, cfg.seq_axes)
    o, k, v = _self(cfg, lp["self"], _norm(x, lp["self_norm"]), attn,
                    causal=True)
    x = x + o
    cp = lp["cross"]
    q = _heads(_norm(x, lp["cross_norm"]), cp["wq"], cfg.n_heads, cfg.hd)
    xk = _heads(enc, cp["wk"], cfg.n_kv_heads, cfg.hd)
    xv = _heads(enc, cp["wv"], cfg.n_kv_heads, cfg.hd)
    x = x + _out(L.cross_attention(q, xk, xv), cp["wo"])
    x = x + L.mlp_gelu(lp, _norm(x, lp["mlp_norm"]))
    return x, k, v, xk, xv


def _embed(params: dict, tokens: torch.Tensor, positions: torch.Tensor,
           dt: torch.dtype) -> torch.Tensor:
    pe = params["pos_embed"]
    return (L.embed_rows(params["embed"]["table"], tokens).to(dt)
            + L.embed_rows(pe, positions % pe.shape[0]).to(dt))


def _unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: x @ embed/tableᵀ over the padded vocab."""
    return L.tp_matmul(x, params["embed"]["table"].to(x.dtype).T, "column")


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            self_attn: L.SelfAttention | None = None):
    """batch: tokens (B,S_dec) and frontend (B,T_enc,d).  Returns (logits,
    aux), aux a float32 zero."""
    tokens = batch["tokens"]
    attn = self_attn or L.attention
    enc = encode(cfg, params, batch["frontend"], self_attn=attn)
    x = _embed(params, tokens, torch.arange(tokens.shape[1],
                                            device=tokens.device),
               cfg.activation_dtype)
    layer = L.maybe_remat(_dec_layer, cfg.remat)
    for lp in unstack(params["dec"], cfg.n_layers):
        x = layer(cfg, lp, x, enc, attn)[0]
    logits = _unembed(params, _norm(x, params["final_norm"]))
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def cache_max_len(cfg: ModelConfig, seq_len: int) -> int:
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> dict:
    dt = cfg.activation_dtype
    nd = cfg.n_layers
    kv = (nd, max_len, batch, cfg.n_kv_heads, cfg.hd)
    xkv = (nd, cfg.n_frontend_tokens, batch, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(kv, dtype=dt, device=device),
            "v": torch.zeros(kv, dtype=dt, device=device),
            "xk": torch.zeros(xkv, dtype=dt, device=device),
            "xv": torch.zeros(xkv, dtype=dt, device=device), "len": 0}


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            max_len: int, frontend: torch.Tensor | None = None, *,
            self_attn: L.SelfAttention | None = None
            ) -> tuple[torch.Tensor, dict]:
    """Encode the frames (zeros if None) and run the decoder prompt; build
    the cache.  Returns (last-token logits, cache)."""
    b, s = tokens.shape
    if max_len < s:
        raise ValueError(f"whisper.prefill: max_len {max_len} < prompt {s}")
    dt = cfg.activation_dtype
    attn = self_attn or L.attention
    frames = (frontend if frontend is not None else torch.zeros(
        (b, cfg.n_frontend_tokens, cfg.d_model), device=tokens.device)
              ).to(dt)
    enc = encode(cfg, params, frames, self_attn=attn)
    x = _embed(params, tokens, torch.arange(s, device=tokens.device), dt)
    kvs = []
    for lp in unstack(params["dec"], cfg.n_layers):
        x, *kv = _dec_layer(cfg, lp, x, enc, attn)
        kvs.append([t.transpose(0, 1) for t in kv])
    kc, vc, xk, xv = (torch.stack(t) for t in zip(*kvs))
    logits = _unembed(params, _norm(x[:, -1], params["final_norm"]))
    return logits, {"k": L.pad_dim(kc, 1, max_len),
                    "v": L.pad_dim(vc, 1, max_len), "xk": xk, "xv": xv,
                    "len": s}


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                token: torch.Tensor, pos) -> tuple[torch.Tensor, dict]:
    """token: (B,) int; pos: absolute position (row of ``pos_embed``, mod
    its 4096 rows).  Writes the new self k/v at slot ``len``, in place."""
    b = token.shape[0]
    dt = cfg.activation_dtype
    hd = cfg.hd
    n = int(cache["len"])
    x = _embed(params, token[:, None],
               torch.as_tensor(pos, device=token.device).reshape(1, 1), dt)
    for i, lp in enumerate(unstack(params["dec"], cfg.n_layers)):
        sp, cp = lp["self"], lp["cross"]
        h = _norm(x, lp["self_norm"])
        q = _heads(h, sp["wq"], cfg.n_heads, hd)
        L.cache_write(cache["k"], (i, n),
                      _heads(h, sp["wk"], cfg.n_kv_heads, hd)[:, 0])
        L.cache_write(cache["v"], (i, n),
                      _heads(h, sp["wv"], cfg.n_kv_heads, hd)[:, 0])
        o = L.decode_attention(q, cache["k"][i].transpose(0, 1),
                               cache["v"][i].transpose(0, 1), n + 1)
        x = x + _out(o, sp["wo"])
        q2 = _heads(_norm(x, lp["cross_norm"]), cp["wq"], cfg.n_heads, hd)
        o2 = L.decode_attention(q2, cache["xk"][i].transpose(0, 1),
                                cache["xv"][i].transpose(0, 1),
                                cache["xk"].shape[1])   # every frame
        x = x + _out(o2, cp["wo"])
        x = x + L.mlp_gelu(lp, _norm(x, lp["mlp_norm"]))
    logits = _unembed(params, _norm(x[:, 0], params["final_norm"]))
    cache["len"] = n + 1
    return logits, cache
