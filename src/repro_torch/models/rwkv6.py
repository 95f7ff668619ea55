"""RWKV6 "Finch" (arXiv:2404.05892): attention-free LM with
data-dependent decay, ``ssm`` family.

Port of ``repro.models.rwkv6``.  Per layer: a time-mix block (token-shift
ddlerp -> r/k/v/w/g projections, WKV6 matrix-state recurrence, per-head
group norm and SiLU-gated output) and a channel-mix block (token-shift,
squared-ReLU FFN).  The reference scans over the stacked layer params;
here a Python loop indexes them.

Interfaces (as the reference's):
  init(cfg, generator, device)               -> params
  forward(cfg, params, batch)                -> (logits, aux)
  init_cache(cfg, batch, max_len, device)    -> cache
  prefill(cfg, params, tokens, max_len)      -> (logits_last, cache)
  decode_step(cfg, params, cache, token, pos)-> (logits, cache)

Serving state, O(1) in sequence length: per layer the (B,H,D,D) float32
matrix state ``tm_state`` and the previous token's activations of both
token shifts (``tm_prev``, ``cm_prev``); "len" is a Python int.
``decode_step`` writes every state IN PLACE (the reference returns a
fresh cache) and returns the same dict with "len" advanced; a cache
placed on a mesh (``serving.kvcache``) is written by
``layers.cache_write``, each rank its own rows.  Sharded, each layer pins
its input to the batch (and sequence) split, as the reference's
``_layer``; the token shifts and WKV6 run rank by rank.

Forward and prefill run the WKV6 wrapper with the reference's clip floor
(``WKV_FLOOR``): on CUDA it launches the kernel, on the CPU it runs the
kernel's plain version, the exact per-step scan.  Decode (S=1, state
carried in) runs one step of the recurrence (``layers.rwkv6_step``) on w
clipped at the same floor.  ``wkv_fn`` (forward/prefill) replaces the
kernel with another function of its signature, e.g. its plain version, so
one run can hold the kernel path against it.  ``cfg.remat == "full"``
checkpoints each layer of forward and prefill (``layers.maybe_remat``).
"""

from __future__ import annotations

from collections.abc import Callable

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6 import wkv6
from repro_torch.models import layers as L
from repro_torch.models.common import (ModelConfig, TreeBuilder, is_dtensor,
                                       unstack)
from repro_torch.models.transformer import unembed

LORA_R = 32          # low-rank size of the ddlerp/decay LoRAs
WKV_FLOOR = 1e-8     # the reference's clip of w (its chunked form's)

WkvFn = Callable[..., tuple[torch.Tensor, torch.Tensor]]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _build(cfg: ModelConfig, generator: torch.Generator | None,
           device: torch.device) -> TreeBuilder:
    """Same paths, shapes, logical axes and init laws as the reference's
    ``_build``."""
    tb = TreeBuilder(cfg, device, generator)
    d, nl = cfg.d_model, cfg.n_layers
    n_heads = cfg.n_heads
    hd = d // n_heads
    if n_heads * hd != d:
        raise ValueError(f"rwkv6: d_model {d} is not a multiple of "
                         f"n_heads {n_heads}")

    tb.leaf("embed/table", (cfg.padded_vocab, d), ("vocab", "table_d"),
            scale=0.02)
    # time-mix
    tb.leaf("layers/tm_norm", (nl, d), ("layers", None), init="zeros")
    tb.leaf("layers/tm_mu", (nl, 5, d), ("layers", None, None), init="zeros")
    tb.leaf("layers/tm_lora_a", (nl, d, 5 * LORA_R),
            ("layers", "embed", None))
    tb.leaf("layers/tm_lora_b", (nl, 5, LORA_R, d),
            ("layers", None, None, None), init="zeros")
    for name in ("wr", "wk", "wv", "wg"):
        tb.leaf(f"layers/{name}", (nl, d, d), ("layers", "embed", "heads"))
    tb.leaf("layers/wo", (nl, d, d), ("layers", "heads", "embed"))
    tb.leaf("layers/w0", (nl, d), ("layers", None), init="zeros")
    tb.leaf("layers/w_lora_a", (nl, d, LORA_R), ("layers", "embed", None))
    tb.leaf("layers/w_lora_b", (nl, LORA_R, d), ("layers", None, None),
            init="zeros")
    tb.leaf("layers/u", (nl, n_heads, hd), ("layers", "heads", None),
            init="zeros")
    tb.leaf("layers/ln_x", (nl, d), ("layers", None), init="ones")
    # channel-mix
    tb.leaf("layers/cm_norm", (nl, d), ("layers", None), init="zeros")
    tb.leaf("layers/cm_mu", (nl, 2, d), ("layers", None, None), init="zeros")
    tb.leaf("layers/cm_wk", (nl, d, cfg.d_ff), ("layers", "embed", "ff"))
    tb.leaf("layers/cm_wv", (nl, cfg.d_ff, d), ("layers", "ff", "embed"))
    tb.leaf("layers/cm_wr", (nl, d, d), ("layers", "embed", "embed"))

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
# blocks
# ---------------------------------------------------------------------------

def _shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """Token shift: x[t-1]; position 0 gets ``prev`` (carried state) or 0.
    On DTensors rank by rank, rows and channels kept split."""
    if is_dtensor(x):
        return L.on_ranks(_shift, (x, prev), ("bsd", "bd"), "bsd", keep="bd")
    pad = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _wkv(r, k, v, w, u, state0, wkv_fn: WkvFn | None):
    """The WKV6 recurrence of one layer on (B,H,S,D) heads: the whole
    prompt from a zero state, or one decode step from ``state0``.  On
    DTensors rank by rank (``layers.on_ranks``): rows and heads keep their
    split, a split sequence is gathered, and the same wrapper (on CUDA
    the kernel) runs on the local tensors."""
    if is_dtensor(r):
        return L.on_ranks(_wkv_local, (r, k, v, w, u, state0, wkv_fn),
                          ("bhsd", "bhsd", "bhsd", "bhsd", "hd", "bhde",
                           None), ("bhsd", "bhde"), keep="bh")
    if state0 is None:
        return (wkv_fn or wkv6)(r, k, v, w, u, floor=WKV_FLOOR)
    out, state = L.rwkv6_step(r[:, :, 0], k[:, :, 0], v[:, :, 0],
                              torch.clamp(w[:, :, 0].float(), WKV_FLOOR, 1.0),
                              u, state0)
    return out[:, :, None], state


def _wkv_local(r, k, v, w, u, state0, wkv_fn: WkvFn | None):
    """``_wkv`` of one rank's local tensors, r, k, v and w in one layout:
    the WKV6 wrapper reads all four through one set of strides, and
    ``on_ranks`` gives a new contiguous (B,H,S,D) tensor for an input it
    had to redistribute (w, which DTensor leaves split along the
    sequence over "model" after its LoRA, gathered and split by heads)
    beside views of the (B,S,H,D) projections for the rest."""
    if any(t.stride() != r.stride() for t in (k, v, w)):
        r, k, v, w = (t.contiguous() for t in (r, k, v, w))
    return _wkv(r, k, v, w, u, state0, wkv_fn)


def _time_mix(cfg: ModelConfig, lp: dict, x: torch.Tensor,
              state0: torch.Tensor | None, prev0: torch.Tensor | None,
              wkv_fn: WkvFn | None = None):
    """x: (B,S,D). Returns (out, final_state, last_x)."""
    b, s, d = x.shape
    dt = x.dtype
    n_heads = cfg.n_heads
    hd = d // n_heads
    xs = _shift(x, prev0)
    delta = xs - x
    # ddlerp: 5 interpolation amounts from a shared LoRA
    lora = L.tp_matmul(x, lp["tm_lora_a"].to(dt), "column")
    lora = torch.tanh(lora.float()).to(dt).reshape(b, s, 5, LORA_R)
    amt = lp["tm_mu"].to(dt)[None, None] + torch.einsum(
        "bskr,krd->bskd", lora, lp["tm_lora_b"].to(dt))
    mixed = x[:, :, None, :] + delta[:, :, None, :] * amt     # (B,S,5,D)
    xw, xk, xv, xr, xg = mixed.unbind(2)

    r, k, v, g = (L.tp_matmul(z, lp[w].to(dt), "column")
                  for z, w in ((xr, "wr"), (xk, "wk"), (xv, "wv"),
                               (xg, "wg")))
    wl = L.tp_matmul(xw, lp["w_lora_a"].to(dt), "column")
    wl = L.tp_matmul(torch.tanh(wl.float()),
                     L.split_like(lp["w_lora_b"].float(), lp["wr"]), "column")
    logw = -torch.exp(torch.clamp(lp["w0"].float()[None, None] + wl,
                                  -10.0, 4.0))
    w = torch.exp(logw)                                       # decay in (0,1)

    def heads(z):               # (B,S,D) -> (B,H,S,D) view, no copy
        return L.split_heads(z, n_heads, hd).transpose(1, 2)

    out, final_state = _wkv(heads(r), heads(k), heads(v), heads(w.to(dt)),
                            lp["u"].float(), state0, wkv_fn)
    # per-head group norm
    og = out.transpose(1, 2).float()                         # (B,S,H,D)
    og = og * torch.rsqrt(torch.mean(og * og, dim=-1, keepdim=True) + 1e-6)
    out = (og.reshape(b, s, d) * lp["ln_x"].float()).to(dt)
    out = out * F.silu(g.float()).to(dt)
    return L.tp_matmul(out, lp["wo"].to(dt), "row"), final_state, x[:, -1]


def _channel_mix(lp: dict, x: torch.Tensor, prev0: torch.Tensor | None):
    dt = x.dtype
    xs = _shift(x, prev0)
    delta = xs - x
    mu = lp["cm_mu"].to(dt)
    xk = x + delta * mu[0][None, None]
    xr = x + delta * mu[1][None, None]
    k = L.tp_matmul(xk, lp["cm_wk"].to(dt), "column")
    k = torch.square(F.relu(k.float())).to(dt)
    r = torch.sigmoid(L.tp_matmul(xr, lp["cm_wr"].to(dt), "column").float())
    out = L.tp_matmul(k, lp["cm_wv"].to(dt), "row")
    return (out.float() * r).to(dt), x[:, -1]


def _layer(cfg: ModelConfig, lp: dict, x: torch.Tensor, tm_state=None,
           tm_prev=None, cm_prev=None, wkv_fn: WkvFn | None = None):
    x = L.constrain_batch(x, cfg.batch_axes, cfg.seq_axes)
    h = L.rms_norm(x, lp["tm_norm"])
    tm_out, tm_state_new, tm_last = _time_mix(cfg, lp, h, tm_state, tm_prev,
                                              wkv_fn)
    x = x + tm_out
    h2 = L.rms_norm(x, lp["cm_norm"])
    cm_out, cm_last = _channel_mix(lp, h2, cm_prev)
    x = x + cm_out
    return x, (tm_state_new, tm_last, cm_last)


def _trunk(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
           wkv_fn: WkvFn | None):
    """Embedding through the final norm.  Returns (x (B,S,D), per-layer
    (tm_state, tm_last, cm_last))."""
    x = L.embed_rows(params["embed"]["table"], tokens).to(
        cfg.activation_dtype)
    layer = L.maybe_remat(_layer, cfg.remat)
    states = []
    for lp in unstack(params["layers"], cfg.n_layers):
        x, st = layer(cfg, lp, x, wkv_fn=wkv_fn)
        states.append(st)
    return L.rms_norm(x, params["final_norm"]), states


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            wkv_fn: WkvFn | None = None):
    """batch: {"tokens": (B,S) int}. Returns (logits, aux_loss)."""
    x, _ = _trunk(cfg, params, batch["tokens"], wkv_fn)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(cfg, params, x), aux


# ---------------------------------------------------------------------------
# serving: recurrent state instead of a KV cache
# ---------------------------------------------------------------------------

def cache_max_len(cfg: ModelConfig, seq_len: int) -> int:
    return 1      # O(1) state


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> dict:
    d, nl, nh = cfg.d_model, cfg.n_layers, cfg.n_heads
    hd = d // nh
    dt = cfg.activation_dtype
    return {
        "tm_state": torch.zeros((nl, batch, nh, hd, hd), dtype=torch.float32,
                                device=device),
        "tm_prev": torch.zeros((nl, batch, d), dtype=dt, device=device),
        "cm_prev": torch.zeros((nl, batch, d), dtype=dt, device=device),
        "len": 0,
    }


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            max_len: int, *, wkv_fn: WkvFn | None = None
            ) -> tuple[torch.Tensor, dict]:
    """Run the full prompt; build the recurrent state (``max_len`` is not
    needed: the state does not grow).  Returns (last-token logits,
    cache)."""
    x, states = _trunk(cfg, params, tokens, wkv_fn)
    cache = {name: torch.stack([st[n] for st in states])
             for n, name in enumerate(("tm_state", "tm_prev", "cm_prev"))}
    cache["len"] = tokens.shape[1]
    return unembed(cfg, params, x[:, -1]), cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                token: torch.Tensor, pos) -> tuple[torch.Tensor, dict]:
    """token: (B,) int.  Writes every layer's state in place."""
    x = L.embed_rows(params["embed"]["table"], token).to(
        cfg.activation_dtype)[:, None]
    for i, lp in enumerate(unstack(params["layers"], cfg.n_layers)):
        x, (st, tm_last, cm_last) = _layer(
            cfg, lp, x, tm_state=cache["tm_state"][i],
            tm_prev=cache["tm_prev"][i], cm_prev=cache["cm_prev"][i])
        L.cache_write(cache["tm_state"], (i,), st)
        L.cache_write(cache["tm_prev"], (i,), tm_last)
        L.cache_write(cache["cm_prev"], (i,), cm_last)
    x = L.rms_norm(x[:, 0], params["final_norm"])
    cache["len"] += 1
    return unembed(cfg, params, x), cache
