"""Batched serving engine: static-wave batching over a fixed slot set.

Port of ``repro.serving.engine`` (``Request``, ``WaveStats``,
``ServeEngine`` and ``wave_op_graph``).  Requests are served in WAVES of up to ``n_slots``: one
batched prefill of the prompts LEFT-padded to the wave's longest, then
lock-step decode until every slot is done.  Left-padding alone is not
exact for shorter prompts (causal attention has no pad mask), so each
distinct shorter length gets one exact, unpadded re-prefill that supplies
its first token, as in the reference.  Decode runs eagerly, one
``decode_step`` per lock-step token; the cache is updated in place.
Every prefill's batch comes from ``_batch_for``: the tokens and, for the
vlm and audio families, a zero frontend, as in the reference.

The engine follows its params' device.  ``prefill_calls`` counts model
prefills (wave prefills and exact re-prefills), which is how many times
each layer's prefill self-attention ran.  ``prefill_s``/``decode_s`` sum
host wall time of the two phases; each phase ends in a copy of the
chosen tokens to the host, which waits for the device.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core.graph import GraphBuilder, OpGraph
from repro_torch.models import zoo
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int = 32
    eos_id: int | None = None
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class WaveStats:
    n_requests: int
    prompt_len: int
    decode_steps: int
    slot_token_capacity: int         # n_slots * decode_steps
    useful_tokens: int
    wall_s: float

    @property
    def slot_utilization(self) -> float:
        return self.useful_tokens / max(self.slot_token_capacity, 1)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: dict, *, n_slots: int,
                 max_len: int, pad_id: int = 0):
        self.cfg = cfg
        self.params = params
        self.device = params["embed"]["table"].device
        self.n_slots = n_slots
        self.max_len = max_len
        self.pad_id = pad_id
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self.stats: list[WaveStats] = []
        self.prefill_calls = 0
        self.prefill_s = 0.0
        self.decode_s = 0.0

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    # ------------------------------------------------------------------
    def _batch_for(self, prompts: np.ndarray) -> dict:
        batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64,
                                           device=self.device)}
        if zoo.needs_frontend(self.cfg):
            batch["frontend"] = torch.zeros(
                (prompts.shape[0], self.cfg.n_frontend_tokens,
                 self.cfg.d_model), dtype=self.cfg.activation_dtype,
                device=self.device)
        return batch

    def _prefill(self, prompts: np.ndarray, cache_len: int):
        self.prefill_calls += 1
        return zoo.prefill(self.cfg, self.params, self._batch_for(prompts),
                           cache_len)

    def _exact_short_logits(self, wave: list[Request], plen: int,
                            tokens: np.ndarray) -> None:
        """Overwrite ``tokens[i]`` for every request shorter than ``plen``
        with the argmax of an exact unpadded prefill (one per distinct
        shorter length)."""
        by_len: dict[int, list[int]] = {}
        for i, r in enumerate(wave):
            # zero-token requests never emit the corrected token
            if len(r.prompt) < plen and r.max_new_tokens > 0:
                by_len.setdefault(len(r.prompt), []).append(i)
        for length, slots in by_len.items():
            sub = np.stack([wave[i].prompt for i in slots]).astype(np.int32)
            # only the logits are kept: size the cache for this length
            logits, _ = self._prefill(sub, zoo.cache_max_len(self.cfg,
                                                             length))
            exact = torch.argmax(logits, dim=-1).cpu().numpy()
            for j, i in enumerate(slots):
                tokens[i] = exact[j]

    def _run_wave(self, wave: list[Request]) -> None:
        t0 = time.perf_counter()
        plen = max(len(r.prompt) for r in wave)
        prompts = np.full((self.n_slots, plen), self.pad_id, np.int32)
        for i, r in enumerate(wave):
            prompts[i, plen - len(r.prompt):] = r.prompt   # left-pad
        max_new = max(r.max_new_tokens for r in wave)
        cache_len = zoo.cache_max_len(
            self.cfg, min(self.max_len, plen + max_new))
        logits, cache = self._prefill(prompts, cache_len)
        tokens = torch.argmax(logits, dim=-1).cpu().numpy()   # writable
        self._exact_short_logits(wave, plen, tokens)
        for i, r in enumerate(wave):
            if r.max_new_tokens <= 0:
                # a request for 0 tokens gets 0 tokens
                r.done = True
                continue
            r.output.append(int(tokens[i]))
            if r.eos_id is not None and r.output[-1] == r.eos_id:
                r.done = True
        t1 = time.perf_counter()
        self.prefill_s += t1 - t0

        steps = 0
        useful = sum(1 for r in wave if r.max_new_tokens > 0)
        pos = plen
        while steps < max_new - 1 and not all(
                r.done or len(r.output) >= r.max_new_tokens for r in wave):
            logits, cache = zoo.decode_step(
                self.cfg, self.params, cache,
                torch.as_tensor(tokens, dtype=torch.int64,
                                device=self.device), pos)
            tokens = torch.argmax(logits, dim=-1).cpu().numpy()
            for i, r in enumerate(wave):
                if r.done or len(r.output) >= r.max_new_tokens:
                    continue
                r.output.append(int(tokens[i]))
                useful += 1
                if r.eos_id is not None and r.output[-1] == r.eos_id:
                    r.done = True
            steps += 1
            pos += 1
        self.decode_s += time.perf_counter() - t1

        for r in wave:
            r.done = True
            self.finished.append(r)
        # the prefill-produced token counts as one generation step, unless
        # the whole wave asked for 0 tokens
        gen_steps = steps + (1 if max_new > 0 else 0)
        self.stats.append(WaveStats(
            n_requests=len(wave), prompt_len=plen, decode_steps=gen_steps,
            slot_token_capacity=self.n_slots * gen_steps,
            useful_tokens=useful, wall_s=time.perf_counter() - t0))

    # ------------------------------------------------------------------
    def run(self) -> list[Request]:
        while self.queue:
            wave = [self.queue.popleft()
                    for _ in range(min(self.n_slots, len(self.queue)))]
            self._run_wave(wave)
        return self.finished

    @property
    def mean_slot_utilization(self) -> float:
        if not self.stats:
            return 0.0
        return sum(w.slot_utilization for w in self.stats) / len(self.stats)

    def pending_waves(self) -> list[list[Request]]:
        """The wave partition ``run()`` would execute, without consuming
        the queue — the unit a runtime pool schedules as one job."""
        reqs = list(self.queue)
        return [reqs[i:i + self.n_slots]
                for i in range(0, len(reqs), self.n_slots)]

    def submit_waves_to_pool(self, pool, *, priority: float = 1.0,
                             arrival_gap: float = 0.0,
                             latency_target: float | None = None) -> list:
        """Submit every pending wave to a
        ``repro_torch.multitenant.RuntimePool`` as one job each (wave i
        arrives at ``i * arrival_gap``), so serving
        waves co-schedule against training steps and other tenants on the
        shared machine.  ``latency_target`` maps the serving SLO onto pool
        deadlines — each wave's deadline is its arrival time plus the
        target, which is what arms the pool's slack-aware ordering and
        (when enabled) deadline-driven preemption for these jobs.  Returns
        the created jobs; the engine's real queue is left untouched."""
        from repro_torch.service.spec import (ATTACHED_GRAPH, JobSpec,
                                              submit_spec)
        jobs = []
        for i, wave in enumerate(self.pending_waves()):
            g = wave_op_graph(self.cfg, wave, n_slots=self.n_slots,
                              name=f"{self.cfg.arch_id}-wave{i}")
            # same wire schema as the CLI and the daemon inbox; the
            # wave's graph only exists in-process, so it rides along as
            # an attached graph rather than a rebuildable workload name
            spec = JobSpec(workload=ATTACHED_GRAPH, name=g.name,
                           priority=priority,
                           submit_time=i * arrival_gap,
                           latency_budget=latency_target)
            jobs.append(submit_spec(pool, spec, graph=g))
        return jobs


def wave_op_graph(cfg: ModelConfig, wave: list[Request], *,
                  n_slots: int | None = None,
                  name: str | None = None) -> OpGraph:
    """Analytic op graph of one serving wave (batched prefill + lock-step
    decode), in the same IR the paper's runtime schedules.

    Per-layer prefill ops carry the wave's (n_requests, prompt_len) token
    block; decode is one small op per lock-step token.  Flops/bytes use
    the standard transformer estimates (attn 8*d^2 + mlp ~6*d*d_ff per
    token-layer), so the pool's perfmodel sees prefill as big tunable ops
    and decode as the Strategy-4 "small op" population — exactly the mix
    that benefits from co-scheduling against a training tenant.

    ``n_slots``: the engine computes full n_slots-row batches even for a
    partial final wave (padding rows are real machine load), so cost
    terms use the padded batch when given."""
    if not wave:
        raise ValueError("wave_op_graph: empty wave (no requests)")
    n = max(len(wave), n_slots or 0)
    plen = max(len(r.prompt) for r in wave)
    # worst-case lock-step decode length, exactly as _run_wave bounds its
    # loop (max_len sizes the KV cache there, it does not cap the steps)
    max_new = max(r.max_new_tokens for r in wave)
    d = float(cfg.d_model)
    dff = float(cfg.d_ff)
    layer_params = 4 * d * d + 3 * d * dff      # attn qkvo + swiglu mlp
    b = GraphBuilder(name or f"{cfg.arch_id}-wave")
    tok = float(n * plen)
    prev = b.add("wave_embed", (n, plen, cfg.d_model),
                 flops=2 * tok * d, bytes_moved=tok * d * 4,
                 parallel_fraction=0.85, tunable=False)
    for li in range(cfg.n_layers):
        attn = b.add("wave_prefill_attn", (n, plen, cfg.d_model),
                     deps=[prev],
                     flops=tok * (8 * d * d) + 4 * tok * plen * d,
                     bytes_moved=tok * d * 8,
                     parallel_fraction=0.97,
                     name=f"wave_prefill_attn/{li}")
        prev = b.add("wave_prefill_mlp", (n, plen, cfg.d_model),
                     deps=[attn],
                     flops=tok * 6 * d * dff, bytes_moved=tok * d * 6,
                     parallel_fraction=0.98,
                     name=f"wave_prefill_mlp/{li}")
    # the prefill logits produce the wave's first token (unembed once)…
    prev = b.add("wave_unembed", (n, 1, cfg.d_model), deps=[prev],
                 flops=2 * n * d * cfg.vocab, bytes_moved=n * d * 4,
                 parallel_fraction=0.95, tunable=False)
    # …then lock-step decode: each step touches every weight once for n
    # tokens INCLUDING the logits projection the engine runs per step —
    # bandwidth-bound small ops chained by the autoregressive dependency.
    # max_new - 1 steps, not max_new: the first generated token came from
    # prefill above (see ServeEngine._run_wave).
    step_params = cfg.n_layers * layer_params + d * cfg.vocab
    step_flops = 2.0 * n * step_params
    step_bytes = step_params * 2.0                 # stream weights (bf16)
    for s in range(max(max_new - 1, 0)):
        prev = b.add("wave_decode_step", (n, 1, cfg.d_model), deps=[prev],
                     flops=step_flops, bytes_moved=step_bytes,
                     working_set=step_bytes,
                     parallel_fraction=0.80,
                     name=f"wave_decode_step/{s}")
    return b.build()


def prefill_payload_graph(cfg: ModelConfig, params: dict,
                          prompts: list[np.ndarray]) -> OpGraph:
    """Independent prefills as one graph with real payloads, for
    ``core.RealGraphExecutor``.

    One chain a prompt: the ops of ``wave_op_graph(cfg, [request])`` for
    a wave of that one request with ``max_new_tokens=1`` (no decode ops),
    their classes, shapes, flops and bytes unchanged, with payloads that
    call the model's own functions: ``wave_embed`` the embedding (tokens
    to the params' device), ``wave_prefill_attn/i`` and
    ``wave_prefill_mlp/i`` the two halves of layer i
    (``transformer.attention_half`` through ``layers.attention``, then
    ``transformer.mlp_half``) and
    ``wave_unembed`` the final norm and the last position's logits.  A
    chain's last op returns the (1, V) logits ``transformer.prefill``
    gives for that prompt.  Dense and MoE families only (the families of
    ``transformer.py``)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.common import unstack

    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"prefill_payload_graph: family {cfg.family!r} "
                         "is not a transformer.py family")
    layers = unstack(params["layers"], cfg.n_layers)
    dev = params["embed"]["table"].device

    def embed(prompt):
        def run(deps):
            tokens = torch.as_tensor(prompt, dtype=torch.int64,
                                     device=dev)[None]
            return T.embed(cfg, params, tokens)
        return run

    def attention(li, dep):
        def run(deps):
            x, cos, sin = deps[dep]
            x = T.attention_half(cfg, layers[li], x, cos, sin,
                                 L.attention)[0]
            return x, cos, sin
        return run

    def mlp(li, dep):
        def run(deps):
            x, cos, sin = deps[dep]
            return T.mlp_half(cfg, layers[li], x)[0], cos, sin
        return run

    def logits(dep):
        return lambda deps: T.last_logits(cfg, params, deps[dep][0])

    b = GraphBuilder(f"{cfg.arch_id}-prefills")
    for i, prompt in enumerate(prompts):
        chain = wave_op_graph(cfg, [Request(rid=i, prompt=prompt,
                                            max_new_tokens=1)])
        uids: dict[int, int] = {}
        for u in chain.topo_order():
            op = chain.ops[u]
            deps = [uids[d] for d in op.deps]
            layer = op.name.partition("/")[2]
            if op.op_class == "wave_embed":
                payload = embed(prompt)
            elif op.op_class == "wave_prefill_attn":
                payload = attention(int(layer), deps[0])
            elif op.op_class == "wave_prefill_mlp":
                payload = mlp(int(layer), deps[0])
            elif op.op_class == "wave_unembed":
                payload = logits(deps[0])
            else:
                raise ValueError(f"prefill_payload_graph: no payload for "
                                 f"{op.op_class}")
            uids[u] = b.add(
                op.op_class, op.input_shape, flops=op.flops,
                bytes_moved=op.bytes_moved, working_set=op.working_set,
                parallel_fraction=op.parallel_fraction, deps=deps,
                name=f"{op.name}@{i}", payload=payload, tunable=op.tunable)
    return b.build()
