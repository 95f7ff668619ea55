"""RecurrentGemma / Griffin (arXiv:2402.19427): RG-LRU + local-attention
hybrid, ``hybrid`` family.

Port of ``repro.models.recurrentgemma``.  Block kinds:
* recurrent: x -> {Wx -> conv1d(4) -> RG-LRU} * gelu(Wy) -> Wo
* local attention: MQA (kv=1) with sliding window + RoPE
Every block is followed by a GeGLU MLP; RMSNorm pre-norms throughout.
26 layers = 8 super-blocks of (rglru, rglru, attn) + 2 tail rglru blocks;
the reference scans over the stacked params of each group, here a Python
loop indexes them.

Interfaces (as the reference's):
  init(cfg, generator, device)               -> params
  forward(cfg, params, batch)                -> (logits, aux)
  init_cache(cfg, batch, max_len, device)    -> cache
  prefill(cfg, params, tokens, max_len)      -> (logits_last, cache)
  decode_step(cfg, params, cache, token, pos)-> (logits, cache)

Serving state: per recurrent block a float32 (B,R) RG-LRU carry ``h`` and
a (B,3,R) conv tail ``conv`` (``rec1``/``rec2`` of shape (n_supers,...),
``tail`` (n_tail,...)); per attention block a window-sized ring buffer
k/v (n_supers, S_max, B, K, hd); "len" is a Python int.  ``decode_step``
writes every state IN PLACE (the reference returns a fresh cache) and
returns the same dict with "len" advanced; a cache placed on a mesh
(``serving.kvcache``) is written by ``layers.cache_write``, each rank its
own slice.  Sharded, each block pins its input to the batch (and
sequence) split (``layers.constrain_batch``), as the reference's; the
conv, the RG-LRU scan and attention run rank by rank on local tensors.

On CUDA, prefill runs the flash attention kernel in the attention blocks
and the RG-LRU kernel in the recurrent blocks; decode (S=1, state carried
in ``h0``) is plain PyTorch.  ``self_attn`` and ``rglru_fn``
(forward/prefill) replace the two prefill kernels with other functions of
the same signatures, e.g. their plain versions, so one run can hold the
kernel path against them.  ``cfg.remat == "full"`` checkpoints each
super-block and each tail block of forward and prefill
(``layers.maybe_remat``), the reference's scan bodies.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.common import (ModelConfig, TreeBuilder, is_dtensor,
                                       unstack)
from repro_torch.models.transformer import unembed

CONV_W = 4


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _rec_leaves(tb: TreeBuilder, prefix: str, n: int, cfg: ModelConfig):
    d = cfg.d_model
    r = cfg.rglru_dim or cfg.d_model
    tb.leaf(f"{prefix}/norm", (n, d), ("layers", None), init="zeros")
    tb.leaf(f"{prefix}/wx", (n, d, r), ("layers", "embed", "ff"))
    tb.leaf(f"{prefix}/wy", (n, d, r), ("layers", "embed", "ff"))
    tb.leaf(f"{prefix}/conv_w", (n, CONV_W, r), ("layers", "conv", "ff"))
    tb.leaf(f"{prefix}/conv_b", (n, r), ("layers", "ff"), init="zeros")
    tb.leaf(f"{prefix}/log_a", (n, r), ("layers", "ff"), init="zeros")
    tb.leaf(f"{prefix}/w_gx", (n, r, r), ("layers", "ff", "ff"))
    tb.leaf(f"{prefix}/w_ga", (n, r, r), ("layers", "ff", "ff"))
    tb.leaf(f"{prefix}/wo", (n, r, d), ("layers", "ff", "embed"))
    _mlp_leaves(tb, prefix, n, cfg)


def _attn_leaves(tb: TreeBuilder, prefix: str, n: int, cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.hd
    tb.leaf(f"{prefix}/norm", (n, d), ("layers", None), init="zeros")
    tb.leaf(f"{prefix}/wq", (n, d, cfg.n_heads * hd),
            ("layers", "embed", "heads"))
    tb.leaf(f"{prefix}/wk", (n, d, cfg.n_kv_heads * hd),
            ("layers", "embed", "kv"))
    tb.leaf(f"{prefix}/wv", (n, d, cfg.n_kv_heads * hd),
            ("layers", "embed", "kv"))
    tb.leaf(f"{prefix}/wo", (n, cfg.n_heads * hd, d),
            ("layers", "heads", "embed"))
    _mlp_leaves(tb, prefix, n, cfg)


def _mlp_leaves(tb: TreeBuilder, prefix: str, n: int, cfg: ModelConfig):
    d = cfg.d_model
    tb.leaf(f"{prefix}/mlp_norm", (n, d), ("layers", None), init="zeros")
    tb.leaf(f"{prefix}/w_gate", (n, d, cfg.d_ff), ("layers", "embed", "ff"))
    tb.leaf(f"{prefix}/w_up", (n, d, cfg.d_ff), ("layers", "embed", "ff"))
    tb.leaf(f"{prefix}/w_down", (n, cfg.d_ff, d), ("layers", "ff", "embed"))


def n_supers(cfg: ModelConfig) -> tuple[int, int]:
    per = len(cfg.block_pattern)        # 3
    return cfg.n_layers // per, cfg.n_layers % per


def _build(cfg: ModelConfig, generator: torch.Generator | None,
           device: torch.device) -> TreeBuilder:
    """Same paths, shapes, logical axes and init laws as the reference's
    ``_build``."""
    tb = TreeBuilder(cfg, device, generator)
    ns, tail = n_supers(cfg)
    tb.leaf("embed/table", (cfg.padded_vocab, cfg.d_model),
            ("vocab", "table_d"), scale=0.02)
    _rec_leaves(tb, "supers/rec1", ns, cfg)
    _rec_leaves(tb, "supers/rec2", ns, cfg)
    _attn_leaves(tb, "supers/attn", ns, cfg)
    if tail:
        _rec_leaves(tb, "tail", tail, cfg)
    tb.leaf("final_norm", (cfg.d_model,), (None,), init="zeros")
    if not cfg.tie_embeddings:
        tb.leaf("unembed", (cfg.d_model, cfg.padded_vocab),
                ("embed", "vocab"), scale=0.02)
    return tb


def init(cfg: ModelConfig, generator: torch.Generator | None,
         device: torch.device) -> dict:
    return _build(cfg, generator, device).build()


def specs(cfg: ModelConfig) -> dict:
    """The logical-axes tree of ``init``'s params (built on ``meta``)."""
    return _build(cfg, None, torch.device("meta")).specs


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor | None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d, width CONV_W. x (B,S,R), w (CONV_W,R).
    ``tail``: (B,CONV_W-1,R) carried history. Returns (y, new_tail)."""
    if is_dtensor(x):
        # the conv mixes along the sequence only: rank by rank, rows and
        # channels kept split, a split sequence gathered
        return L.on_ranks(_causal_conv, (x, w, b, tail),
                          ("bsr", "cr", "r", "btr"), ("bsr", "btr"),
                          keep="br")
    if tail is None:
        tail = torch.zeros((x.shape[0], CONV_W - 1, x.shape[2]),
                           dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i].to(x.dtype) for i in range(CONV_W))
    return y + b.to(x.dtype), xp[:, -(CONV_W - 1):]


def _geglu(lp: dict, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    g = F.gelu(L.tp_matmul(x, lp["w_gate"].to(dt), "column").float(),
               approximate="tanh").to(dt)
    up = L.tp_matmul(x, lp["w_up"].to(dt), "column")
    return L.tp_matmul(g * up, lp["w_down"].to(dt), "row")


def _rec_block(cfg: ModelConfig, lp: dict, x: torch.Tensor,
               h0: torch.Tensor | None = None,
               conv_tail: torch.Tensor | None = None, *,
               rglru_fn: L.RglruScan | None = None):
    """Returns (x', (h_last float32 (B,R), conv tail (B,3,R)))."""
    x = L.constrain_batch(x, cfg.batch_axes, cfg.seq_axes)
    dt = x.dtype
    h = L.rms_norm(x, lp["norm"])
    gate = F.gelu(L.tp_matmul(h, lp["wy"].to(dt), "column").float(),
                  approximate="tanh").to(dt)
    u = L.tp_matmul(h, lp["wx"].to(dt), "column")
    u, new_tail = _causal_conv(u, lp["conv_w"], lp["conv_b"], conv_tail)
    rec, h_last = L.rglru_block(lp, u, h0, scan=rglru_fn)
    x = x + L.tp_matmul(rec * gate, lp["wo"].to(dt), "row")
    h2 = L.rms_norm(x, lp["mlp_norm"])
    x = x + _geglu(lp, h2)
    return x, (h_last, new_tail)


def _qkv(cfg: ModelConfig, lp: dict, x: torch.Tensor, cos: torch.Tensor,
         sin: torch.Tensor):
    dt = x.dtype
    hd = cfg.hd
    h = L.rms_norm(x, lp["norm"])
    q, k, v = (L.split_heads(L.tp_matmul(h, lp[w].to(dt), "column"), n, hd)
               for w, n in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                            ("wv", cfg.n_kv_heads)))
    return L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin), v


def _attn_out(cfg: ModelConfig, lp: dict, x: torch.Tensor, o: torch.Tensor
              ) -> torch.Tensor:
    x = x + L.tp_matmul(L.merge_heads(o), lp["wo"].to(x.dtype), "row")
    h2 = L.rms_norm(x, lp["mlp_norm"])
    return x + _geglu(lp, h2)


def _attn_block(cfg: ModelConfig, lp: dict, x: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor,
                self_attn: L.SelfAttention):
    """Returns (x', (k, v)) with k/v as (S,B,K,hd)."""
    x = L.constrain_batch(x, cfg.batch_axes, cfg.seq_axes)
    q, k, v = _qkv(cfg, lp, x, cos, sin)
    o = self_attn(q, k, v, causal=True, window=cfg.window)
    return _attn_out(cfg, lp, x, o), (k.transpose(0, 1), v.transpose(0, 1))


def _trunk(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
           self_attn: L.SelfAttention | None,
           rglru_fn: L.RglruScan | None):
    """Embedding through the final norm.  Returns (x (B,S,D), states):
    per super-block (rec1 state, rec2 state, k, v), per tail block its
    recurrent state."""
    s = tokens.shape[1]
    dt = cfg.activation_dtype
    x = L.embed_rows(params["embed"]["table"], tokens).to(dt)
    cos, sin = L.rope_angles(torch.arange(s, device=tokens.device), cfg.hd,
                             cfg.rope_theta)
    attn = self_attn or L.attention
    ns, n_tail = n_supers(cfg)
    super_block = L.maybe_remat(_super_block, cfg.remat)
    rec_block = L.maybe_remat(_rec_block, cfg.remat)
    supers, tails = [], []
    for lp in unstack(params["supers"], ns):
        x, st = super_block(cfg, lp, x, cos, sin, attn, rglru_fn)
        supers.append(st)
    for lp in unstack(params.get("tail", {}), n_tail):
        x, st = rec_block(cfg, lp, x, rglru_fn=rglru_fn)
        tails.append(st)
    return L.rms_norm(x, params["final_norm"]), supers, tails


def _super_block(cfg: ModelConfig, lp: dict, x: torch.Tensor,
                 cos: torch.Tensor, sin: torch.Tensor,
                 self_attn: L.SelfAttention, rglru_fn: L.RglruScan | None):
    """(rglru, rglru, attn).  Returns (x', (rec1 state, rec2 state, k, v))."""
    x, st1 = _rec_block(cfg, lp["rec1"], x, rglru_fn=rglru_fn)
    x, st2 = _rec_block(cfg, lp["rec2"], x, rglru_fn=rglru_fn)
    x, (k, v) = _attn_block(cfg, lp["attn"], x, cos, sin, self_attn)
    return x, (st1, st2, k, v)


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            self_attn: L.SelfAttention | None = None,
            rglru_fn: L.RglruScan | None = None):
    """batch: {"tokens": (B,S) int}. Returns (logits, aux_loss)."""
    x, _, _ = _trunk(cfg, params, batch["tokens"], self_attn, rglru_fn)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(cfg, params, x), aux


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def cache_max_len(cfg: ModelConfig, seq_len: int) -> int:
    return min(seq_len, cfg.window or seq_len)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> dict:
    ns, n_tail = n_supers(cfg)
    r = cfg.rglru_dim or cfg.d_model
    dt = cfg.activation_dtype
    kv = (ns, max_len, batch, cfg.n_kv_heads, cfg.hd)

    def rec_state(n):
        return {"h": torch.zeros((n, batch, r), dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros((n, batch, CONV_W - 1, r), dtype=dt,
                                    device=device)}

    cache = {"rec1": rec_state(ns), "rec2": rec_state(ns),
             "k": torch.zeros(kv, dtype=dt, device=device),
             "v": torch.zeros(kv, dtype=dt, device=device), "len": 0}
    if n_tail:
        cache["tail"] = rec_state(n_tail)
    return cache


def _stack_states(states: list) -> dict:
    return {"h": torch.stack([h for h, _ in states]),
            "conv": torch.stack([c for _, c in states])}


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            max_len: int, *, self_attn: L.SelfAttention | None = None,
            rglru_fn: L.RglruScan | None = None
            ) -> tuple[torch.Tensor, dict]:
    """Run the full prompt; build the cache.  Returns (last-token logits,
    cache).  If max_len < prompt length, the ring buffer keeps the
    trailing ``max_len`` keys and values."""
    s = tokens.shape[1]
    x, supers, tails = _trunk(cfg, params, tokens, self_attn, rglru_fn)
    kc = torch.stack([k for _, _, k, _ in supers])     # (ns,S,B,K,hd)
    vc = torch.stack([v for _, _, _, v in supers])
    if max_len >= s:
        kc, vc = L.pad_dim(kc, 1, max_len), L.pad_dim(vc, 1, max_len)
    else:
        kc = kc[:, s - max_len:].contiguous()
        vc = vc[:, s - max_len:].contiguous()
    cache = {"rec1": _stack_states([st1 for st1, _, _, _ in supers]),
             "rec2": _stack_states([st2 for _, st2, _, _ in supers]),
             "k": kc, "v": vc, "len": min(s, max_len)}
    if tails:
        cache["tail"] = _stack_states(tails)
    return unembed(cfg, params, x[:, -1]), cache


def _rec_step(cfg: ModelConfig, lp: dict, x: torch.Tensor, state: dict,
              i: int) -> torch.Tensor:
    """One token through recurrent block ``i`` of a group; its carry and
    conv tail in ``state`` are updated in place."""
    x, (h, conv) = _rec_block(cfg, lp, x, h0=state["h"][i],
                              conv_tail=state["conv"][i])
    L.cache_write(state["h"], (i,), h)
    L.cache_write(state["conv"], (i,), conv)
    return x


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                token: torch.Tensor, pos) -> tuple[torch.Tensor, dict]:
    """token: (B,) int; pos: absolute position (for RoPE).  Writes the new
    k/v at ring slot len % max_len and every recurrent state, in place."""
    max_len = cache["k"].shape[1]
    n = int(cache["len"])
    slot = n % max_len
    n_valid = min(n + 1, max_len)
    x = L.embed_rows(params["embed"]["table"], token).to(
        cfg.activation_dtype)[:, None]
    cos, sin = L.rope_angles(
        torch.as_tensor(pos, device=token.device).reshape(1), cfg.hd,
        cfg.rope_theta)
    ns, n_tail = n_supers(cfg)
    for i, lp in enumerate(unstack(params["supers"], ns)):
        x = _rec_step(cfg, lp["rec1"], x, cache["rec1"], i)
        x = _rec_step(cfg, lp["rec2"], x, cache["rec2"], i)
        q, k, v = _qkv(cfg, lp["attn"], x, cos[None], sin[None])
        L.cache_write(cache["k"], (i, slot), k[:, 0])   # in place
        L.cache_write(cache["v"], (i, slot), v[:, 0])
        o = L.decode_attention(
            q, cache["k"][i].transpose(0, 1), cache["v"][i].transpose(0, 1),
            n_valid)    # the ring buffer already bounds the window
        x = _attn_out(cfg, lp["attn"], x, o)
    for i, lp in enumerate(unstack(params.get("tail", {}), n_tail)):
        x = _rec_step(cfg, lp, x, cache["tail"], i)
    x = L.rms_norm(x[:, 0], params["final_norm"])
    cache["len"] = n + 1
    return unembed(cfg, params, x), cache
