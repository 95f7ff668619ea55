#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, one JSON line each:
  1. card    the device name and ``nvidia-smi`` name and power limit;
  2. build   nvcc builds every CUDA kernel from the checkout's sources;
             for every library each kernel's registers, stack and spills
             from ``ptxas -v``, and for the flash library the count of
             ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) instructions in
             its SASS (``cuobjdump -sass``): a missing tool, a spill in
             any library or a serialised wgmma fails the run;
  3. kernel  each kernel against its plain version on the card, bf16 and
             fp32: flash attention (``attention_plain``) at the olmo-1b
             prefill shape, a GQA shape, a ragged length, a window, D=16,
             S=1, every tile class of the bf16 TMA/wgmma kernel (S=192, not
             a multiple of its 128 query rows; S=37, under one 64-key tile;
             a window of 40, under one k-tile; D=64 MQA; D=256 causal with
             no window), the recurrentgemma-2b prefill shape (D=256, MQA
             10/1, window 2048, S=2600), the mixtral-8x7b prefill shape
             (B=4, S=4093, GQA 32/8, window 4096), S=6000 under that
             window (the window binds) and, non-causal, the whisper-small
             encoder (B=4, S=1500, H=K=12, D=64), S=37 at D=128 and S=192
             at D=128 with GQA 32/8; RG-LRU (``rglru_plain``) at the
             recurrentgemma-2b prefill shape, its longest B=1 re-prefill
             (S=2382), a ragged S=300, S=1, a=1e-6 and R=130 (copied
             element by element); WKV6 (``wkv6_plain``) at the rwkv6-1.6b
             prefill shape, its longest B=1 re-prefill (S=3318), the
             slice's second-wave shape (S=4093, prime), a ragged S=300, a
             prime S=509, S=1, D=16, D=32 (B*H below and at 128: both
             geometries), strong decay w in [1e-4, 0.2] and a floor case
             (exact zeros and decays below 1e-8 with ``floor`` 1e-8).
             RG-LRU's h and h_last and WKV6's final state must equal the
             plain versions' exactly;
  3b. grad  each kernel's autograd Function (the kernel forward, the
             recomputed VJP of its plain version in the backward), bf16
             and fp32: flash at the olmo-1b head shape (B=2, S=256),
             RG-LRU at B=2, S=128, R=2560, WKV6 at B=2, H=32, S=128, D=64
             in the model's strides; every input gets a gradient (not
             None) within the kernel tolerances of autograd through the
             plain version on the same card;
  4. kernel_time  each kernel's time, its plain version's, a PyTorch call
             that computes the same function where one exists (a yardstick
             the port never calls), the least time the card could take
             (bound: the kernel's ``cost`` in its ``ops.py``, which the
             dry-run counts too, over ``hw.spec``'s peaks) and the host
             time of one wrapper call, at the main paths' shapes: for the recurrences at the B=4 wave prefill and
             the B=1 re-prefill, for WKV6 also both of its geometries; for
             flash attention also the time with L2 flushed before each
             launch (``cold_ms``), and the non-causal whisper-small encoder
             beside ``scaled_dot_product_attention(is_causal=False)``;
  5. slice   olmo-1b at full width (random weights from seed 0, bf16
             activations) served by ``ServeEngine``: 8 requests of 64-512
             prompt tokens on 4 slots, 16 new tokens each;
  5b. runtime  the port's copy of the paper's runtime (``repro_torch.core``).
             ``runtime_sim``: ``examples/quickstart.py``'s flow for
             resnet50, dcgan and inception_v3 (the recommendation at 1 x 68
             threads, the manual best uniform configuration, the runtime's
             step, speedup, mean co-run and profiling steps), all times
             the simulated KNL's (``SimMachine``), not the card's.
             ``runtime_exec``: four independent olmo-1b prefills at full
             width (bf16, weights from seed 0; one request a chain of 512,
             384, 256 and 128 tokens) as one graph of 136 ops, each chain
             the ops of ``wave_op_graph`` for its request with payloads
             that call the model's own functions
             (``serving.prefill_payload_graph``); planned on the sim by
             ``ConcurrencyRuntime`` with EWMA feedback, run by
             ``RealGraphExecutor`` at 1 and 4 workers (a CUDA stream each,
             timed by CUDA events): wall time (and the witness's), summed
             device ms, the most
             ops whose event intervals overlap, flash's launches (64) and
             the streams it ran on (``torch.profiler``; at least 2 at 4
             workers), the plan store's observations (136), device ms by
             op class beside the sim's prediction, and the logits against
             the witness (the same payloads in topological order on the
             caller's stream): bit for bit, or else within the bf16 rule
             with the unequal elements counted.  Then one fp32 run at 4
             workers within 1e-3 of the largest |logit| of
             ``transformer.prefill``.  Each line reads
             ``memory_allocated`` just before its executor is built and
             after its results are dropped, and fails if the second is
             higher (the executor frees the cuBLAS workspaces of its
             worker streams).
             ``service_exec``: the same four prompts as four jobs of the
             pool daemon (``service.PoolDaemon``, up to 3 jobs active, EWMA
             feedback, payload feedback, 4 workers on the card), each its
             request's 34 ops (``prefill_payload_graph``) attached to a
             ``JobSpec``; beside them a simulated resnet50 training job
             (no payloads) and a fifth prefill cancelled before any step;
             then ``drain`` and ``close``.  It fails unless each job's
             logits equal the witness's bit for bit (else within the bf16
             rule, the unequal elements counted), flash launched exactly
             64 times and none of the cancelled job's payloads ran, every
             payload op of the four jobs was observed once, the job store
             on disk holds six entries in their final states, and
             ``memory_allocated`` after ``close`` (results dropped) is no
             higher than before the daemon was built; the line gives the
             wall, the sim's makespan (simulated KNL), the summed device
             ms and the checkpoints written;
  6. slice   recurrentgemma-2b at full width, the same way: 8 requests on
             4 slots, 16 new tokens each, ``max_len`` 4096, a first wave
             of 64-512 prompt tokens and a second of 1500-2600 (one above
             the 2048 window, one not a multiple of 64);
  7. slice   rwkv6-1.6b at full width, the same way: 8 requests on 4
             slots, 16 new tokens each, ``max_len`` 8192, a first wave of
             64-512 prompt tokens and a second of 1500-4000 plus one of
             prime length 4093 (the reference's chunk rule falls to 1 and
             the kernel's ragged tail runs).  ``zoo.init`` keeps the
             reference's inits, which leave ``tm_mu``, ``tm_lora_b``,
             ``w0``, ``w_lora_b``, ``u`` and ``cm_mu`` at zero (every decay
             e^-1, no token shift); before serving they are drawn from the
             same generator: ``w0`` ~ U(-8, 3.5) (some decays below the
             1e-8 clip), ``w_lora_b`` ~ N(0, 0.1), ``tm_lora_b`` ~ N(0,
             0.02), ``tm_mu`` and ``cm_mu`` ~ U(0, 1), ``u`` ~ N(0, 0.5).
             Its compared prefills also hold every WKV6 call against
             ``wkv6_plain`` on that call's own inputs (``HeldPerCall``).
  8. slice   granite-3-8b at full width and depth (40 layers, GQA 32 on
             8 kv heads, 8.37e9 params), the same way: 8 requests of 64-1024
             prompt tokens on 4 slots, 16 new tokens each; its bf16
             logits within sqrt(2) times the plain path's own bf16 error
             (two independent bf16 roundings of one size, 40 layers deep),
             and each flash call of its compared prefills against
             ``attention_plain`` on that call's own inputs;
  9. slice   mixtral-8x7b at full width cut to 8 of its 32 layers (MoE
             top-2 of 8 experts, window 4096, 11.87e9 params), the same
             way: ``max_len`` 8192, a first wave of 64-1024 prompt tokens
             and a second of 1500-4092 plus one of 4093 (the compared wave:
             one MoE group a row, and decode wraps the window's ring buffer
             after 3 tokens).  Each leaf is cast to bf16 as it is drawn
             (``cast_as_you_go``).  Its compared prefills record every MoE
             layer's routing (``RouteLog``): the line counts the tokens
             whose top-2 experts differ between the kernel and plain paths,
             each with its margin;
  10. slice  llama-3.2-vision-11b at full width and depth (40 layers: 32
             self layers through flash, GQA 32/8, and 8 gated cross layers;
             9.78e9 params), the same way: 8 requests of 64-1024 prompt
             tokens on 4 slots, 16 new tokens each, ``max_len`` 2048.  Its
             cross gates, zero at init, are drawn from U(-1, 1) and kept
             fp32 through the cast; one seeded frontend of 1600 tokens goes
             to every row of every prefill (``engine_with_frontend``), so
             an exact re-prefill sees its wave's image.  No prompt is 1600
             tokens long (that would send the cross-attention to flash);
             bf16 logits held as granite-3-8b's, and each flash call too;
  11. slice  whisper-small at full width and depth (12 encoder and 12
             decoder layers), the same way with one seeded frontend of
             1500 frames: 8 requests of 16-432 decoder tokens, 16 new each,
             ``max_len`` 448 (whisper's own cap on the decoder); 24 flash
             launches a prefill (the encoder's 12 non-causal), none in
             decode; each flash call held on its own inputs;
  12. train  olmo-1b at full width trained by ``make_train_step``:
             random fp32 weights from seed 0, bf16 activations, AdamW
             (fp32 moments, lr 1e-4 from its first step), ``remat=True``,
             2 microbatches, 4 steps on one fixed ``SyntheticLM`` batch of
             B=4, S=2048: each step's time after a sync, the median of
             steps 2-4, training tokens/s, the share of the bf16 peak that
             6 * params * tokens a step reaches, the loss of each step
             (finite, falling), peak memory and flash's launches on the
             path (zeroed just before: exactly 16 layers x 2 microbatches
             x (forward + remat recompute) x 4 steps = 256); then a fifth
             step under ``torch.profiler`` (``train_kernels``: device time
             by group of kernels, the largest kernels);
  13. train_grad  one fp32 microbatch of olmo-1b at full width (B=1,
             S=512, TF32 off): the loss's gradients through the kernel
             path against the same with ``self_attn=attention_plain``,
             per leaf within 1e-3 of the leaf's largest |g|; with bf16
             activations held as the slices hold bf16 logits;
  14. train_moe  mixtral-8x7b at full width cut to 1 layer, trained the
             same way (1 microbatch of B=2, S=2048, 3 steps, same lr and
             warm-up): step times, tokens/s, the bf16 peak share of
             6 * active params * tokens, the losses, ce and aux of one
             ``loss_fn`` call after the steps, the router's gradient norm
             (non-zero), peak memory and flash's launches (1 layer x 2 x 3
             steps = 6), then a traced step; then the same steps once more
             from the same weights with ``attention_plain`` in place of the
             kernel (``plain_attention_witness``: its losses, grad norms,
             ce and aux), to rule the kernel in or out of what the routing
             does.  2 layers do not fit: the step holds the old and the new
             state at once (see ``MOE_TRAIN_LAYERS``);
  14b. multidevice  the sharded train step on the production backend at
             world size 1: a child process (``--multidevice``) brings up
             NCCL on the card with a (1, 1) ("data", "model") mesh, places
             the train phase's olmo-1b state (same seed, batch, B=4,
             S=2048, 2 microbatches, remat, lr) by ``default_plan`` as
             DTensors and takes 3 AdamW steps with the batch over "data":
             the losses held within 5e-3 of the train phase's first 3
             (the reference's own sharded-against-single bound), the
             median step beside the unsharded one, one more step under
             ``torch.profiler`` (its device ms beside the train phase's
             traced step, and the device's share of its wall), peak
             memory, the collectives a step (``CommDebugMode``), each
             kernel's launches on this path (flash: the train phase's
             count for 3 steps, a rank's attention being one card's; the
             recurrences none), a save and ``restore(shardings=...)`` of
             the sharded state read back bit for bit, and
             ``ring_ag_matmul`` on the olmo-1b MLP up-projection
             (8192x2048 @ 2048x8192, bf16) against ``torch.matmul``, bit
             for bit, both timed by CUDA events; then every other family
             on the same mesh, each run unsharded and then sharded from
             the same seed in the child (a ``multidevice_family`` line
             each): the train_moe phase's mixtral-8x7b step (1 layer,
             B=2, S=2048, 2 steps; experts on "model"), and prefill plus
             8 decode steps of 4 rows, the cache placed by
             ``serving.kvcache.cache_shardings`` (``replicated-heads`` at
             degree 1), for olmo-1b, recurrentgemma-2b (prompts of 2600,
             past its window), rwkv6-1.6b, whisper-small (a 1500-frame
             frontend) and llama-3.2-vision-11b cut to 10 layers: its
             losses or logits bit for bit equal to the unsharded run's (or
             within the slices' bf16 bound, the gap written), the same
             launches of every kernel (flash, RG-LRU and WKV6 each on a
             sharded path), 0 collectives in every step, both runs' host
             wall and peak memory.  It runs after train_moe, so that this
             process holds little of the card;
  15. dryrun  every (arch x shape) cell of the reference's matrix (10
             archs x 4 shapes; 7 skipped for the reference's reason)
             counted on the meta device at full depth by
             ``repro_torch.launch.dryrun`` against the card's spec
             (``H100Spec.from_device``): a line a cell with its flops by
             class, bytes, peak, the roofline terms and whether it fits
             the card, and a summary (cells counted, skipped, fitting,
             seconds);
  16. dryrun_vs_card  the shapes this call ran, counted the same way,
             beside the card's measurements: the olmo-1b train phase,
             train_moe and the olmo-1b served prefill (B=4, S=512, 6
             calls): predicted peak against ``max_memory_allocated`` (less
             what was allocated before the phase; within 10 %), counted
             flops by class against 6·N·T, and the measured median step
             against the roofline's ``step_s_overlapped`` (the share of it
             the step reaches at most 1.05).  One more row comes from the
             multidevice child: the sharded olmo-1b step it ran, counted
             on its (1, 1) mesh by the DTensor path (one rank's ops and
             every dispatched collective), beside the card: peak within
             10 %, share at most 1.05, and 0 collectives counted, equal
             to the child's ``CommDebugMode`` count;
  17. dryrun_mesh  a child process (``--dryrun-mesh``) over a fake
             process group of its own counts every cell of the matrix on
             the reference's 16x16 mesh (one rank's share; 256 ranks) at
             ``depth_plan``'s depths where it gives any, against the
             card's spec, and on 2x16x16 (512 ranks) every arch's
             decode_32k and long_500k cells (``DRYRUN_MULTI_SHAPES``): a
             ``dryrun_mesh_cell`` line a cell (roofline terms, dominant
             term, one rank's peak and whether it fits the card,
             collectives by kind, the step's ici and dci link bytes and
             their time, the kv strategy, one rank's flops, 6·N·T over
             one rank's flops times the ranks, the GEMMs run replicated,
             seconds) and a summary whose ``ok`` needs every cell
             counted or skipped with the reference's reason and none in
             error, no GEMM run replicated in the dense family's train
             and prefill cells on 16x16, and each dense train cell's
             flops and peak within 1 % of torch 2.13's count on a CPU.
Each slice zeroes every kernel's launch counter just before it serves and
reads them just after; then runs its 8 prefill calls once more (the same
waves, one new token each, so no decode) under ``torch.profiler`` and
prints a ``slice_kernels`` line: per kernel its launches, summed device
time and share of all device time in those calls, and all of it by group
of kernels (``KERNEL_GROUPS``); and holds a wave's prefill logits (and,
for rwkv6-1.6b, its ``tm_state``; for rwkv6-1.6b and granite-3-8b also
each kernel call on its own inputs) against the same prefill through the
kernels' plain versions, in fp32 and in bf16.  Then the
``{"kernels": [...]}`` line (flash's launches by path, the olmo-1b
runtime's and service's and the olmo-1b and
mixtral-8x7b train paths' included; each kernel's largest error against
its plain version, its tolerance ``|err| <= atol + rtol * |ref|`` and the
largest ratio of the error to that bound; flash's times also at D=256, at
the mixtral-8x7b prefill and at the whisper-small encoder, for the
recurrences their B=1 numbers, ``at_b1``), the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises: the script
exits non-zero with its traceback.  Without CUDA it exits 2 and prints no
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

TOL = {"bfloat16": 2e-2, "float32": 2e-5}
RGLRU_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# (atol, rtol): test_kernels.py's WKV6 tolerances in fp32 (5e-4 and 5e-3
# under strong decay), the kernel tests' 2e-2 in bf16
WKV6_TOL = {"bfloat16": (2e-2, 2e-2), "float32": (3e-4, 1e-3)}
WKV6_STRONG_TOL = {"bfloat16": (2e-2, 2e-2), "float32": (5e-4, 5e-3)}
# prefill logits (and rwkv6's matrix state), kernel path vs plain path,
# relative to the largest value.  In fp32 the two paths differ only by the
# kernels' fp32 errors (at most about 1e-6 a call on the checked shapes;
# the WKV6 kernel carries the plain version's state bit for bit and sums
# only r^T S in another order): 1e-3 holds them to the same function at
# full width.  In bf16 both compute attention and the
# recurrence in fp32 and round their outputs to bf16, so they differ where
# that rounding flips, and the bf16 layers carry the flips on: after 26
# layers of recurrentgemma-2b with random weights that reaches a few bf16
# ulps of the largest logit whatever the kernels do (a different summation
# order alone does it).  So the bf16 gap must be within the kernel tests'
# bf16 tolerance relative to the largest logit, or else no larger than the
# bf16 plain path's own error against the fp32 plain path, capped at
# OWN_FRAC of the largest value; and the greedy token must agree wherever
# the plain path's top-2 margin is above twice that tolerance.  The cap
# keeps the own-error clause from passing anything: in rwkv6-1.6b the bf16
# plain logits are further from fp32 than the largest logit (decays within
# 2^-9 of 1 round to 1 in bf16, another model), so there the clause can
# only catch a gross fault, and ``HeldPerCall`` holds each WKV6 call of the
# compared prefills at the kernel tolerance instead.
LOGIT_RTOL = {"float32": 1e-3, "bfloat16": TOL["bfloat16"]}
OWN_FRAC = 0.25

# (name, B, S, H, K, D, window, causal)
KERNEL_SHAPES = [
    ("olmo-1b prefill", 4, 512, 16, 16, 128, None, True),
    ("granite GQA", 2, 512, 32, 8, 128, None, True),
    ("ragged S=300", 2, 300, 16, 16, 128, None, True),
    ("window 64", 2, 512, 16, 16, 128, 64, True),
    ("D=16", 2, 128, 4, 4, 16, None, True),
    ("S=1", 4, 1, 16, 16, 128, None, True),
    ("S=192, not a multiple of 128", 2, 192, 16, 16, 128, None, True),
    ("S=37, under one k-tile", 2, 37, 16, 16, 128, None, True),
    ("window 40, under one k-tile", 2, 512, 16, 16, 128, 40, True),
    ("D=64 MQA", 1, 200, 8, 1, 64, None, True),
    ("D=256 causal", 2, 640, 8, 1, 256, None, True),
    ("recurrentgemma-2b prefill", 4, 2600, 10, 1, 256, 2048, True),
    ("mixtral-8x7b prefill", 4, 4093, 32, 8, 128, 4096, True),
    ("window 4096 binds, S=6000", 1, 6000, 32, 8, 128, 4096, True),
    # non-causal: every key visible to every query (whisper's encoder)
    ("whisper-small encoder", 4, 1500, 12, 12, 64, None, False),
    ("S=37 non-causal, under one k-tile", 2, 37, 16, 16, 128, None, False),
    ("S=192 non-causal, GQA 32/8", 2, 192, 32, 8, 128, None, False),
]
# the flash shapes that are timed: the main paths'
FLASH_TIMED = ("olmo-1b prefill", "recurrentgemma-2b prefill",
               "mixtral-8x7b prefill", "whisper-small encoder")
# the recurrences' timed shapes: the B=4 wave prefill and the longest B=1
# exact re-prefill that the slice runs (the served paths mostly run B=1)
RGLRU_TIMED = ("recurrentgemma-2b prefill", "recurrentgemma-2b re-prefill")
WKV6_TIMED = ("rwkv6-1.6b prefill", "rwkv6-1.6b re-prefill")
# the grad phase's shapes: flash (B, S, H, K, D) at the olmo-1b head shape,
# RG-LRU (B, S, R), WKV6 (B, H, S, D)
GRAD_SHAPES = {"flash_attention": (2, 256, 16, 16, 128),
               "rglru": (2, 128, 2560), "wkv6": (2, 32, 128, 64)}
# the olmo-1b train phase: B=4 sequences of S=2048 in 2 microbatches, 4
# steps on one fixed batch; AdamW at 1e-4 from its first step (a warm-up of
# one step), cosine to 1e-5 at step 4.  Adam's first step moves every
# weight by about lr: at 1e-3 with no warm-up the loss of this model rose
# over the 4 steps; at 1e-4 it rises at step 2 and ends below step 1's
# (PERF.md, section 6)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 4, 2048, 2, 4
TRAIN_LR = 1e-4
# the multidevice phase: the train phase's setup sharded on a (1, 1) mesh
# for this many steps; losses within the reference's sharded-against-single
# bound (tests/test_multidevice.py); the child's time limit
MULTI_STEPS, MULTI_LOSS_TOL, MULTI_TIMEOUT_S = 3, 5e-3, 600
# the multidevice phase's other families, each sharded on the same (1, 1)
# mesh and held against the same run unsharded in the child: the train_moe
# phase's mixtral-8x7b step for this many steps, and prefill plus this many
# decode steps of B rows for each served arch: (prompt length, max_len,
# depth or None for the full depth); the vlm is cut to 10 of 40 layers (2
# super-blocks of 4 self and 1 cross) to keep the phase in its time
MULTI_MOE_STEPS, MULTI_SERVE_BATCH, MULTI_DECODE_STEPS = 2, 4, 8
MULTI_SERVE = {"olmo-1b": (512, 1024, None),
               "recurrentgemma-2b": (2600, 4096, None),
               "rwkv6-1.6b": (2048, 8192, None),
               "whisper-small": (256, 448, None),
               "llama-3.2-vision-11b": (1024, 2048, 10)}
# the mixtral-8x7b train phase: full width, B=2 sequences of S=2048 in one
# microbatch, 3 steps on one fixed batch, the olmo phase's lr and warm-up.
# Depth 1 of 32: the step keeps the old state while it builds the new one
# (params, mu and nu twice) and holds the gradients and their clipped copy,
# so 2 layers (3.165e9 params: 38 GB of fp32 state) would peak near 101 GB
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_STEPS = 1, 2, 3
# the mixtral-8x7b serving slice's depth: 8 of 32 layers (11.87e9 params,
# 23.7 GB in bf16; the full 32 would be 93.4 GB)
MOE_SERVE_LAYERS = 8
# the train_grad check: one fp32 microbatch of olmo-1b, B=1, S=512
TRAIN_GRAD_SEQ = 512
L2_FLUSH_BYTES = 128 << 20    # written between cold launches; L2 is 50 MB
HOLD_CYCLES = 50_000_000      # about 25 ms of the card spinning (see hold)
# (name, B, S, R, constant a or None for a ~ U(0.001, 0.9995))
RGLRU_SHAPES = [
    ("recurrentgemma-2b prefill", 4, 2048, 2560, None),
    ("recurrentgemma-2b re-prefill", 1, 2382, 2560, None),
    ("ragged S=300", 4, 300, 2560, None),
    ("S=1", 4, 1, 2560, None),
    ("a=1e-6", 1, 64, 2560, 1e-6),
    ("R=130, copied element by element", 1, 37, 130, None),
]
# (name, B, H, S, D, decays, floor); decays "model": w = exp(-exp(x)) with
# x ~ U(-8, 3.5), as the rwkv6-1.6b slice's w0 gives them; a pair: w ~
# U(lo, hi); "floor": a third of w exactly 0, the rest in [0, 1e-8)
WKV6_SHAPES = [
    ("rwkv6-1.6b prefill", 4, 32, 2048, 64, "model", 1e-8),
    ("rwkv6-1.6b re-prefill", 1, 32, 3318, 64, "model", 1e-8),
    ("rwkv6-1.6b wave S=4093", 4, 32, 4093, 64, "model", 1e-8),
    ("ragged S=300", 2, 32, 300, 64, "model", 1e-8),
    ("prime S=509", 2, 32, 509, 64, "model", 1e-8),
    ("S=1", 4, 32, 1, 64, "model", 1e-8),
    ("D=16", 2, 4, 256, 16, "model", 1e-8),
    ("D=32", 2, 8, 256, 32, "model", 1e-8),
    ("D=32, B*H=128", 4, 32, 96, 32, "model", 1e-8),
    ("strong decay", 2, 8, 512, 64, (1e-4, 0.2), 1e-38),
    ("floor", 2, 8, 512, 64, "floor", 1e-8),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def hold() -> None:
    """Keep the card busy for about 25 ms, so that the launches the host
    queues next run back to back on the card: the events around them then
    time the card, not the host's pace of launching (a wrapper call takes
    tens of microseconds of host time, longer than some kernels)."""
    import torch
    torch.cuda._sleep(HOLD_CYCLES)


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean device time of ``fn`` from CUDA events around ``iters`` launches
    queued behind ``hold``, after a warm-up.  A function whose host time
    outlasts the hold (the plain versions' Python loops) is timed at the
    host's pace, as before."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    hold()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` with a cold L2: before each launch a
    buffer of ``L2_FLUSH_BYTES`` is written, and each launch is timed by
    its own pair of events; all of it is queued behind ``hold``."""
    import torch
    buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    fn()
    torch.cuda.synchronize()
    hold()
    for start, end in events:
        buf.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def host_us(fn, iters: int = 100) -> float:
    """Host time of one call of ``fn``, in microseconds, while the card is
    held (so the launch queue never pushes back)."""
    import torch
    fn()
    torch.cuda.synchronize()
    hold()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return t


def bound(cost: dict) -> dict:
    """The least time the card could take for a kernel call of ``cost``
    (its ``kernels/*/ops.py``'s ``cost``, the dry-run's count of it): the
    larger of the operations over their class's peak rate and the bytes
    over the memory rate (``hw.spec``'s data-sheet H100)."""
    from repro_torch.hw import H100
    op_ms = cost["flops"] / H100.peak(cost["peak_class"]) * 1e3
    byte_ms = H100.memory_time(cost["bytes"]) * 1e3
    return {"bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" if op_ms > byte_ms else "bytes",
            "flops": cost["flops"], "bytes": cost["bytes"]}


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def err_ratio(out, ref, atol: float, rtol: float) -> float:
    """The largest |out - ref| / (atol + rtol * |ref|): at most 1 where
    ``out`` is within tolerance everywhere; inf where it is not finite."""
    import torch
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        return float("inf")
    return float(((out - ref).abs() / (atol + rtol * ref.abs())).max())


def held(out, ref, atol: float, rtol: float) -> dict:
    """``out`` against ``ref``: the largest error, the tolerance and the
    largest error ratio."""
    return {"max_abs_err": float((out.float() - ref.float()).abs().max()),
            "tol": {"atol": atol, "rtol": rtol},
            "max_err_ratio": err_ratio(out, ref, atol, rtol)}


def worse(a: dict, b: dict) -> dict:
    """Two ``held`` results of one check merged: the larger of each."""
    return {"max_abs_err": max(a["max_abs_err"], b["max_abs_err"]),
            "tol": a["tol"],
            "max_err_ratio": max(a["max_err_ratio"], b["max_err_ratio"])}


def kernel_label(mangled: str) -> str:
    """``fa_fwd_wgmma<128>`` or ``wkv6_fwd<BF16,64,8>`` from a mangled
    kernel name: the name and its type, integer and bool template
    arguments (the kernels live in an anonymous namespace)."""
    if not mangled.startswith("_ZN"):
        return mangled
    i, name = 3, None
    while i < len(mangled) and mangled[i].isdigit():  # <length><identifier>
        m = re.match(r"\d+", mangled[i:])
        n = int(m.group(0))
        i += len(m.group(0))
        name = mangled[i:i + n]
        i += n
    if name is None or not mangled[i:].startswith("I"):
        return mangled
    targs = mangled[i + 1:].split("Ev", 1)[0]
    args = [t or n or b for t, n, b in re.findall(
        r"\d(BF16|F32)E|Li(\d+)E|Lb([01])E", targs)]
    return f"{name}<{','.join(args)}>"


def build_evidence(name: str) -> dict:
    """What the build shows of library ``name``: per kernel, its
    registers, stack and spill bytes (from the ``ptxas -v`` output that
    ``_build`` keeps) and ptxas's C75xx warnings (serialised wgmma,
    ignored ``setmaxnreg``).  For the flash library also each kernel's
    ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) instructions (from
    ``cuobjdump -sass``; raises if the tool is missing).  ``ok`` is false
    if a kernel spills or ptxas warned, and for flash also if the wgmma
    kernels have no wgmma or TMA load."""
    from repro_torch.kernels import _build
    lib, log = _build.built(name)
    kernels, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = kernels.setdefault(kernel_label(m.group(1)), {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and current is not None:
            current.update(stack_bytes=int(m.group(1)),
                           spill_store_bytes=int(m.group(2)),
                           spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
    warnings = [line.strip() for line in log.splitlines()
                if re.search(r"\(C75\d\d\)", line)]
    out = {"kernels": kernels, "ptxas_warnings": warnings,
           "ok": bool(kernels) and not warnings and all(
               k.get("registers", 0) > 0
               and k["spill_store_bytes"] == k["spill_load_bytes"] == 0
               for k in kernels.values())}
    if name != "flash_attention":
        return out
    sass = subprocess.run([_build.tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        label = kernel_label(chunk.split("\n", 1)[0])
        if label in kernels:
            kernels[label]["HGMMA"] = len(re.findall(r"\bHGMMA\.", chunk))
            kernels[label]["UTMALDG"] = len(re.findall(r"\bUTMALDG\b", chunk))
    out["HGMMA"] = sum(k.get("HGMMA", 0) for k in kernels.values())
    out["UTMALDG"] = sum(k.get("UTMALDG", 0) for k in kernels.values())
    wgmma = {n: k for n, k in kernels.items() if n.startswith("fa_fwd_wgmma")}
    out["ok"] = out["ok"] and sorted(wgmma) == [
        "fa_fwd_wgmma<128>", "fa_fwd_wgmma<256>", "fa_fwd_wgmma<64>"] and all(
        k["HGMMA"] > 0 and k["UTMALDG"] > 0 for k in wgmma.values())
    return out


def check_flash(gen, dev) -> dict:
    import torch

    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention)
    max_err = {}
    for name, b, s, h, kh, d, window, causal in KERNEL_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dn = dtype_name(dtype)
            q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
            k = torch.randn((b, s, kh, d), generator=gen, device=dev).to(dtype)
            v = torch.randn((b, s, kh, d), generator=gen, device=dev).to(dtype)
            out = flash_attention(q, k, v, causal=causal, window=window)
            ref = attention_plain(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            h_ = held(out, ref, TOL[dn], TOL[dn])
            check = {"phase": "kernel", "kernel": "flash_attention",
                     "shape": name, "B": b, "S": s, "H": h, "K": kh, "D": d,
                     "window": window, "causal": causal, "dtype": dn, **h_,
                     "ok": h_["max_err_ratio"] <= 1.0}
            emit(check)
            assert check["ok"], check
            max_err[(name, dn)] = h_
    return max_err


def rglru_inputs(gen, dev, b, s, r, a_const, dtype):
    import torch
    if a_const is None:
        a = 0.001 + 0.9985 * torch.rand((b, s, r), generator=gen, device=dev)
    else:
        a = torch.full((b, s, r), a_const, device=dev)
    x = torch.randn((b, s, r), generator=gen, device=dev)
    return a.to(dtype), x.to(dtype)


def check_rglru(gen, dev) -> dict:
    import torch

    from repro_torch.kernels.rglru import rglru, rglru_plain
    max_err = {}
    for name, b, s, r, a_const in RGLRU_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dn = dtype_name(dtype)
            a, x = rglru_inputs(gen, dev, b, s, r, a_const, dtype)
            h, h_last = rglru(a, x)
            ref, ref_last = rglru_plain(a, x)
            torch.cuda.synchronize()
            tol = RGLRU_TOL[dn]
            h_ = worse(held(h, ref, tol, tol), held(h_last, ref_last, tol, tol))
            # the kernel rounds as the plain version does: h and h_last
            # equal it exactly, not only within the tolerance
            check = {"phase": "kernel", "kernel": "rglru", "shape": name,
                     "B": b, "S": s, "R": r, "a": a_const or "U(0.001,0.9995)",
                     "dtype": dn, **h_,
                     "ok": (h.dtype == dtype and h_last.dtype == torch.float32
                            and h_["max_err_ratio"] <= 1.0
                            and h_["max_abs_err"] == 0.0)}
            emit(check)
            assert check["ok"], check
            max_err[(name, dn)] = h_
    return max_err


def time_flash(gen, dev, name, max_err) -> dict:
    """Times at the ``KERNEL_SHAPES`` entry ``name`` in the main path's
    dtype (bf16): warm (``ms``, the kernel row's number) and with L2
    flushed (``cold_ms``); the yardstick is
    ``scaled_dot_product_attention`` on the same inputs (GQA through
    ``enable_gqa``; a window that binds, shorter than S, through a boolean
    mask)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention import ops as flash_ops
    _, b, s, h, kh, d, window, causal = next(sh for sh in KERNEL_SHAPES
                                             if sh[0] == name)
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device=dev)
               .to(torch.bfloat16) for n in (h, kh, kh))

    def kernel():
        return flash_attention(q, k, v, causal=causal, window=window)

    ms = cuda_ms(kernel)
    cold = cold_ms(kernel)
    launch_host_us = host_us(kernel)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    fp32_ms = cuda_ms(lambda: flash_attention(q32, k32, v32, causal=causal,
                                              window=window), iters=5)
    del q32, k32, v32
    plain_ms = cuda_ms(lambda: attention_plain(q, k, v, causal=causal,
                                               window=window), iters=5)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if window is None or window >= s:
        # a window no shorter than S masks nothing beyond causality: the
        # causal call (flash backend) computes the same function
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=kh != h))
    else:
        pos = torch.arange(s, device=dev)
        mask = (pos[None, :] <= pos[:, None]) & \
            (pos[None, :] > pos[:, None] - window)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=kh != h))
    return {"ms": ms, "cold_ms": cold, "launch_host_us": launch_host_us,
            "fp32_ms": fp32_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            **bound(flash_ops.cost(b, s, h, kh, d, causal=causal,
                                   window=window, dtype=q.dtype)),
            **max_err[(name, "bfloat16")],
            "at": f"{name} B={b} S={s} H={h} K={kh} D={d} window={window} "
                  f"bf16 {'causal' if causal else 'non-causal'}"}


def time_rglru(gen, dev, name, max_err) -> dict:
    """Times at the ``RGLRU_SHAPES`` entry ``name`` in bf16, and the host
    time of one wrapper call.  No single PyTorch call computes this
    recurrence, so there is no yardstick."""
    import torch

    from repro_torch.kernels.rglru import ops as rglru_ops
    from repro_torch.kernels.rglru import rglru, rglru_plain
    _, b, s, r, a_const = next(sh for sh in RGLRU_SHAPES if sh[0] == name)
    a, x = rglru_inputs(gen, dev, b, s, r, a_const, torch.bfloat16)
    ms = cuda_ms(lambda: rglru(a, x))
    launch_host_us = host_us(lambda: rglru(a, x))
    a32, x32 = a.float(), x.float()
    fp32_ms = cuda_ms(lambda: rglru(a32, x32))
    plain_ms = cuda_ms(lambda: rglru_plain(a, x), iters=3, warmup=1)
    return {"ms": ms, "launch_host_us": launch_host_us, "fp32_ms": fp32_ms,
            "plain_ms": plain_ms, "library_ms": None,
            **bound(rglru_ops.cost(b, s, r, a.dtype)),
            **max_err[(name, "bfloat16")],
            "at": f"{name} B={b} S={s} R={r} bf16"}


def wkv6_inputs(gen, dev, b, h, s, d, decays, dtype):
    """r, k, v, w as the model passes them: (B,S,H,D) activations viewed
    as (B,H,S,D); u (H,D) float32."""
    import torch
    r, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev)
               .to(dtype).transpose(1, 2) for _ in range(3))
    x = torch.rand((b, s, h, d), generator=gen, device=dev)
    if decays == "model":
        w = torch.exp(-torch.exp(-8.0 + 11.5 * x))
    elif decays == "floor":
        w = 1e-8 * x
        w[..., ::3] = 0.0
    else:
        lo, hi = decays
        w = lo + (hi - lo) * x
    u = 0.5 * torch.randn((h, d), generator=gen, device=dev)
    return r, k, v, w.to(dtype).transpose(1, 2), u


def check_wkv6(gen, dev) -> dict:
    import torch

    from repro_torch.kernels.rwkv6 import wkv6, wkv6_plain
    max_err = {}
    for name, b, h, s, d, decays, floor in WKV6_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dn = dtype_name(dtype)
            args = wkv6_inputs(gen, dev, b, h, s, d, decays, dtype)
            out, state = wkv6(*args, floor=floor)
            ref, ref_state = wkv6_plain(*args, floor=floor)
            torch.cuda.synchronize()
            atol, rtol = (WKV6_STRONG_TOL if decays != "model"
                          else WKV6_TOL)[dn]
            h_out = held(out, ref, atol, rtol)
            h_state = held(state, ref_state, atol, rtol)
            h_ = worse(h_out, h_state)
            check = {"phase": "kernel", "kernel": "wkv6", "shape": name,
                     "B": b, "H": h, "S": s, "D": d, "decays": str(decays),
                     "floor": floor, "dtype": dn, **h_,
                     "out_max_abs_err": h_out["max_abs_err"],
                     "state_max_abs_err": h_state["max_abs_err"],
                     "state_abs_max": float(ref_state.abs().max()),
                     # the state is rounded as the plain version rounds
                     # it: equal exactly, not only within the tolerance
                     "ok": (out.dtype == dtype
                            and state.dtype == torch.float32
                            and h_["max_err_ratio"] <= 1.0
                            and h_state["max_abs_err"] == 0.0)}
            emit(check)
            assert check["ok"], check
            max_err[(name, dn)] = h_
    return max_err


def time_wkv6(gen, dev, name, max_err) -> dict:
    """Times at the ``WKV6_SHAPES`` entry ``name`` in bf16, inputs in the
    model's layout, and the host time of one wrapper call.  No single
    PyTorch call computes this recurrence, so there is no yardstick."""
    import torch

    from repro_torch.kernels.rwkv6 import ops as wkv6_ops
    from repro_torch.kernels.rwkv6 import wkv6, wkv6_plain
    _, b, h, s, d, decays, floor = next(sh for sh in WKV6_SHAPES
                                        if sh[0] == name)
    args = wkv6_inputs(gen, dev, b, h, s, d, decays, torch.bfloat16)
    ms = cuda_ms(lambda: wkv6(*args, floor=floor))
    launch_host_us = host_us(lambda: wkv6(*args, floor=floor))
    # every geometry of the kernel (the wrapper picks one by B, H and D),
    # which all carry the same state
    geometry_ms = {f"{g[0]}x{g[1]}": cuda_ms(
        lambda: wkv6_ops.launch(*args, floor=floor, geom=g))
        for g in wkv6_ops.GEOMETRIES}
    states = [wkv6_ops.launch(*args, floor=floor, geom=g)[1]
              for g in wkv6_ops.GEOMETRIES]
    assert all(torch.equal(states[0], st) for st in states[1:])
    args32 = [t.float() for t in args]
    fp32_ms = cuda_ms(lambda: wkv6(*args32, floor=floor))
    plain_ms = cuda_ms(lambda: wkv6_plain(*args, floor=floor), iters=3,
                       warmup=1)
    return {"ms": ms, "launch_host_us": launch_host_us, "fp32_ms": fp32_ms,
            "plain_ms": plain_ms, "library_ms": None,
            "geometry": "{}x{}".format(*wkv6_ops.geometry(b, h, d)),
            "geometry_ms": geometry_ms,
            **bound(wkv6_ops.cost(b, h, s, d, args[0].dtype)),
            **max_err[(name, "bfloat16")],
            "at": f"{name} B={b} H={h} S={s} D={d} bf16, (B,S,H,D) strides"}


def draw_rwkv6_leaves(params: dict, gen) -> None:
    """Draw the leaves that ``zoo.init`` leaves at zero (the reference's
    init), in place, from ``gen``: with them at zero every decay is e^-1
    and both token shifts vanish."""
    lp = params["layers"]
    lp["w0"].uniform_(-8.0, 3.5, generator=gen)
    lp["w_lora_b"].normal_(0.0, 0.1, generator=gen)
    lp["tm_lora_b"].normal_(0.0, 0.02, generator=gen)
    lp["tm_mu"].uniform_(0.0, 1.0, generator=gen)
    lp["cm_mu"].uniform_(0.0, 1.0, generator=gen)
    lp["u"].normal_(0.0, 0.5, generator=gen)


def held_to_plain(name: str, out, plain, out32, plain32, *,
                  own_factor: float = 1.0) -> dict:
    """One prefill output, kernel path against plain path: in fp32 within
    1e-3 of the largest plain value; in bf16 within 2e-2 of it or, failing
    that, no further than ``own_factor`` times the bf16 plain path's own
    error against fp32, and never further than OWN_FRAC of the largest
    plain value."""
    out, plain = out.float(), plain.float()
    err32 = float((out32 - plain32).abs().max())
    tol32 = LOGIT_RTOL["float32"] * float(plain32.abs().max())
    err = float((out - plain).abs().max())
    largest = float(plain.abs().max())
    tol = LOGIT_RTOL["bfloat16"] * largest
    own = float((plain - plain32).abs().max())
    own_cap = OWN_FRAC * largest
    own_bound = own_factor * own
    return {f"fp32_{name}_max_abs_err_vs_plain": err32,
            f"fp32_{name}_tol": tol32,
            f"{name}_max_abs_err_vs_plain": err, f"{name}_tol": tol,
            f"plain_bf16_{name}_err_vs_fp32": own,
            f"{name}_own_factor": own_factor,
            f"{name}_own_clause_cap": own_cap,
            "ok": err32 <= tol32 and err <= max(tol, min(own_bound, own_cap))}


class HeldPerCall:
    """A ``wkv_fn`` for the compared kernel-path prefills: it launches the
    kernel and holds each call's output and final state against
    ``wkv6_plain`` on the same inputs.  The bf16 kernel is so held at the
    wave's own length, on the inputs the model gives it, before 24 layers
    compound the bf16 rounding: at the kernel phase's tolerance.  fp32 is
    held within 1e-3 of the call's largest value, the slice's fp32 rule:
    the model's states reach thousands, and at that size the order of the
    64-term sums of r^T S alone moves an fp32 output by more than the
    kernel tests' 3e-4, which were set for inputs of order one."""

    arg = "wkv_fn"        # the prefill keyword it is passed as

    def __init__(self):
        self.calls = 0
        self.worst = {}   # "dtype/array" -> ``held`` of its worst call

    def record(self, key: str, got, want, atol: float, rtol: float) -> None:
        """Keep ``held(got, want)`` under ``key`` if it is the worst yet."""
        h_ = {**held(got, want, atol, rtol), "call": self.calls,
              "abs_max": float(want.float().abs().max())}
        if h_["max_err_ratio"] >= self.worst.get(
                key, {"max_err_ratio": -1.0})["max_err_ratio"]:
            self.worst[key] = h_

    def __call__(self, r, k, v, w, u, *, floor):
        from repro_torch.kernels.rwkv6 import wkv6, wkv6_plain
        out, state = wkv6(r, k, v, w, u, floor=floor)
        ref, ref_state = wkv6_plain(r, k, v, w, u, floor=floor)
        dn = dtype_name(r.dtype)
        for name, got, want in (("out", out, ref), ("state", state,
                                                    ref_state)):
            largest = float(want.float().abs().max())
            atol, rtol = (WKV6_TOL[dn] if dn == "bfloat16" else
                          (LOGIT_RTOL[dn] * largest, 0.0))
            self.record(f"{dn}/{name}", got, want, atol, rtol)
        self.calls += 1
        return out, state


class HeldFlashPerCall(HeldPerCall):
    """A ``self_attn`` for the compared kernel-path prefills: it launches
    the flash kernel and holds each call against ``attention_plain`` on
    the same inputs, at the kernel phase's tolerance (``TOL``), before the
    layers compound the bf16 rounding: the kernel's evidence call by call,
    beside the model-level logits."""

    arg = "self_attn"

    def __call__(self, q, k, v, *, causal, window):
        from repro_torch.kernels.flash_attention import (attention_plain,
                                                         flash_attention)
        out = flash_attention(q, k, v, causal=causal, window=window)
        dn = dtype_name(q.dtype)
        self.record(dn, out, attention_plain(q, k, v, causal=causal,
                                             window=window), TOL[dn], TOL[dn])
        self.calls += 1
        return out


class RouteLog:
    """The routing of every MoE layer in the compared prefills.  While
    ``run(key)`` is open, ``layers.moe_block`` is wrapped so that each call
    keeps its router probs (B,S,E) and top-k expert indices (B,S,k), as
    ``layers.moe_route`` gives them.  The kernel path and the plain path
    differ by rounding, so a token whose experts are nearly tied can route
    differently in the two and move its logits by a discrete step:
    ``flips`` counts them."""

    def __init__(self):
        self.calls = {}

    @contextlib.contextmanager
    def run(self, key: str):
        from repro_torch.models import layers
        block = layers.moe_block
        calls = self.calls.setdefault(key, [])

        def recorded(p, x, *, n_experts, top_k, capacity_factor):
            probs, _, idx = layers.moe_route(p, x, top_k)
            calls.append((probs, idx))
            return block(p, x, n_experts=n_experts, top_k=top_k,
                         capacity_factor=capacity_factor)

        layers.moe_block = recorded
        try:
            yield
        finally:
            layers.moe_block = block

    def flips(self, a: str, b: str, limit: int = 16) -> dict:
        """Tokens whose ordered top-k experts differ between runs ``a`` and
        ``b``, layer by layer.  For each flip its margin in run ``b``: the
        k-th largest prob less the (k+1)-th, and the smallest gap between
        adjacent ones of its k+1 largest (an order flip within the top k).
        Also the largest |probs_a - probs_b| over every token: the scale of
        the two paths' rounding at the router."""
        out, prob_gap = [], 0.0
        for layer, ((pa, ia), (pb, ib)) in enumerate(zip(self.calls[a],
                                                         self.calls[b])):
            k = ib.shape[-1]
            top = pb.sort(dim=-1, descending=True).values[..., :k + 1]
            margin = top[..., k - 1] - top[..., k]
            order_gap = (top[..., :-1] - top[..., 1:]).min(dim=-1).values
            prob_gap = max(prob_gap, float((pa - pb).abs().max()))
            for row, tok in (ia != ib).any(dim=-1).nonzero().tolist():
                out.append({"layer": layer, "row": row, "token": tok,
                            "margin": float(margin[row, tok]),
                            "order_gap": float(order_gap[row, tok])})
        return {"calls": len(self.calls[b]), "flips": len(out),
                "probs_max_abs_diff": prob_gap,
                "largest_margin": max((f["margin"] for f in out),
                                      default=None),
                "first_flips": out[:limit]}


def cast_as_you_go(params: dict, dtype) -> None:
    """``cast_matrices`` in place, leaf by leaf: each leaf's cast replaces
    it in the tree before the next is made, so a model's fp32 tree and its
    bf16 copy never coexist on the card (mixtral-8x7b at 8 layers: 47.5 GB
    and 23.7 GB)."""
    from repro_torch.models.common import cast_matrices
    for key, value in params.items():
        if isinstance(value, dict):
            cast_as_you_go(value, dtype)
        else:
            params[key] = cast_matrices({key: value}, dtype)[key]


# groups of device kernels in a trace (a served slice's prefills or a train
# step), by a substring of the kernel's name (the first that matches); the
# rest is "other": PyTorch's elementwise and reduction kernels
KERNEL_GROUPS = (
    ("flash_attention", ("fa_fwd",)),
    ("fp32 GEMM", ("f32f32", "sgemm", "gemmk1")),
    ("bf16 GEMM", ("nvjet",)),
    ("softmax", ("oftMax", "softmax")),
    ("copy and cast", ("copy",)),
    ("cumsum / scan over an outer dim", ("scan_outer_dim",)),
)


def kernel_groups(device: list) -> dict:
    """The device time of trace events ``device`` by ``KERNEL_GROUPS``,
    largest first, each with its share of all of it."""
    total_ns = sum(e.duration_ns() for e in device)
    groups = {}
    for e in device:
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in e.name() for k in keys)), "other")
        groups[group] = groups.get(group, 0) + e.duration_ns()
    return {g: {"device_ms": ns / 1e6, "share": ns / total_ns}
            for g, ns in sorted(groups.items(), key=lambda kv: -kv[1])}


# each kernel's symbol as a profiler trace names it (a substring)
KERNEL_SYMBOLS = {"flash_attention": "fa_fwd", "rglru": "rglru_fwd",
                  "wkv6": "wkv6_fwd"}


def profile_prefills(cfg, params, prompts, *, max_len: int,
                     counters: dict, engine_cls) -> dict:
    """The slice's prefill calls once more, under ``torch.profiler`` with
    CUDA activity: the same waves of the same prompts, one new token each,
    so each wave runs its wave prefill and its exact re-prefills and no
    decode step.  Per kernel: its launches in the trace, their summed
    device time and its share of all device time in those calls (kernels,
    copies and fills); also the largest other kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Request
    engine = engine_cls(cfg, params, n_slots=4, max_len=max_len)
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=1))
    for kernel in counters:
        kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    device = [e for e in prof.profiler.kineto_results.events()
              if str(e.device_type()).endswith("CUDA")]
    total_ns = sum(e.duration_ns() for e in device)
    assert device and total_ns > 0, "the trace shows no device activity"
    result = {"phase": "slice_kernels", "arch": cfg.arch_id,
              "prefill_calls": engine.prefill_calls, "wall_s": wall,
              "device_ms": total_ns / 1e6, "kernels": {}}
    mine = set()
    for kernel, per_prefill in counters.items():
        name = kernel.__name__
        evs = [e for e in device if KERNEL_SYMBOLS[name] in e.name()]
        mine.update(id(e) for e in evs)
        ns = sum(e.duration_ns() for e in evs)
        result["kernels"][name] = {
            "launches": len(evs), "wrapper_launches": kernel.launches,
            "device_ms": ns / 1e6, "share": ns / total_ns}
        assert len(evs) == kernel.launches == \
            per_prefill * engine.prefill_calls, (name, result)
    others = {}
    for e in device:
        if id(e) not in mine:
            others[e.name()[:80]] = others.get(e.name()[:80], 0) + \
                e.duration_ns()
    result["largest_others"] = [
        {"name": n, "device_ms": ns / 1e6, "share": ns / total_ns}
        for n, ns in sorted(others.items(), key=lambda kv: -kv[1])[:5]]
    result["groups"] = kernel_groups(device)
    emit(result)
    return result


def engine_with_frontend(frontend):
    """A ``ServeEngine`` whose ``_batch_for`` gives every row of every
    prefill (the wave prefills and the exact re-prefills alike) the one
    frontend ``frontend`` (1, T, d_model), in place of the package
    engine's zeros: a re-prefill sees the image or audio its wave saw."""
    from repro_torch.serving import ServeEngine

    class FrontendEngine(ServeEngine):
        def _batch_for(self, prompts):
            batch = super()._batch_for(prompts)
            batch["frontend"] = frontend.expand(len(prompts), -1, -1)
            return batch

    return FrontendEngine


def frontend_for(cfg, dev):
    """One seeded frontend (1, n_frontend_tokens, d_model), N(0, 1) * 0.02
    as the data pipeline draws it, rounded once to the activation dtype so
    the bf16 and fp32 prefills see the same values."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(1)
    return (0.02 * torch.randn((1, cfg.n_frontend_tokens, cfg.d_model),
                               generator=gen, device=dev)
            ).to(cfg.activation_dtype)


def draw_vlm_gates(params: dict, gen) -> None:
    """Draw the vlm's cross gates, zero at init (tanh 0 = 0: the cross
    layers would add nothing), from U(-1, 1) in place."""
    cross = params["supers"]["cross"]
    for name in ("gate_attn", "gate_mlp"):
        cross[name].uniform_(-1.0, 1.0, generator=gen)


def serve_slice(cfg, dev, prompts, *, max_len: int, counters: dict,
                compare_wave: int, plain_kw: dict, state: str | None = None,
                draw_leaves=None, per_call: HeldPerCall | None = None,
                route_log: RouteLog | None = None,
                bf16_own_factor: float = 1.0, frontend=None) -> dict:
    """Serve ``prompts`` (16 new tokens each) on 4 slots through the
    kernels, counting each kernel's launches; then hold wave
    ``compare_wave``'s prefill logits (and the cache leaf ``state``, if
    named) against the same prefill with ``plain_kw`` (the kernels' plain
    versions), in fp32 and in bf16.  ``draw_leaves(params, generator)``
    redraws leaves of the fresh params in place before the cast;
    ``per_call``, if given, is the compared kernel-path prefills'
    ``wkv_fn`` or ``self_attn`` (its ``arg``); ``route_log``, if given,
    records the MoE routing of the compared prefills and the line counts
    its flips between the paths.  ``bf16_own_factor`` is the logits'
    ``own_factor`` in ``held_to_plain``.  ``frontend`` (1, T, d_model), for
    the vlm and audio families, goes to every prefill, the compared ones
    included (``engine_with_frontend``)."""
    import numpy as np
    import torch

    from repro_torch.models import zoo
    from repro_torch.models.common import _FLOAT32_LEAVES as FLOAT32_LEAVES
    from repro_torch.models.common import tree_get, tree_leaves
    from repro_torch.serving import Request, ServeEngine

    engine_cls = ServeEngine if frontend is None else \
        engine_with_frontend(frontend)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = zoo.init(cfg, gen, device=dev)
    if draw_leaves is not None:
        draw_leaves(params, gen)
    cast_as_you_go(params, cfg.activation_dtype)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    assert all(t.device.type == dev.type for t in tree_leaves(params))
    # the leaves the model reads in fp32 (the vlm's gates among them) stay
    # fp32 through the cast
    kept = {path: tree_get(params, path).dtype for path in leaf_paths(params)
            if path.split("/")[-1] in FLOAT32_LEAVES}
    assert all(d == torch.float32 for d in kept.values()), kept

    # warm-up (cuBLAS handles, kernel libraries), not counted
    warm = engine_cls(cfg, params, n_slots=4, max_len=max_len)
    for i in range(2):
        warm.submit(Request(rid=i, prompt=prompts[i][:64 - 7 * i],
                            max_new_tokens=2))
    warm.run()

    engine = engine_cls(cfg, params, n_slots=4, max_len=max_len)
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=16))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kernel in counters:
        kernel.launches = 0
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {kernel.__name__: kernel.launches for kernel in counters}
    peak = torch.cuda.max_memory_allocated()

    assert len(done) == len(prompts)
    assert all(len(r.output) == 16 for r in done), [len(r.output)
                                                   for r in done]
    assert engine.prefill_calls > len(engine.stats), "no exact re-prefill ran"
    # every launch belongs to a prefill: decode launches no kernel
    for kernel, per_prefill in counters.items():
        assert launches[kernel.__name__] == \
            per_prefill * engine.prefill_calls > 0, (
                kernel.__name__, launches, engine.prefill_calls)
    tokens = sum(len(r.output) for r in done)
    kernels = profile_prefills(cfg, params, prompts, max_len=max_len,
                               counters=counters, engine_cls=engine_cls)

    # one wave's prompts, left-padded as the engine pads them: kernel path
    # against the plain path (launches here are not counted)
    wave = prompts[4 * compare_wave:4 * compare_wave + 4]
    plen = max(len(p) for p in wave)
    padded = np.zeros((4, plen), np.int32)
    for i, p in enumerate(wave):
        padded[i, plen - len(p):] = p
    batch = {"tokens": torch.as_tensor(padded, dtype=torch.int64, device=dev)}
    if frontend is not None:
        batch["frontend"] = frontend.expand(4, -1, -1)
    cache_len = zoo.cache_max_len(cfg, min(max_len, plen + 16))
    # the same weights with fp32 activations (the bf16 matrices upcast
    # where they are used)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    runs = {}
    kernel_kw = {} if per_call is None else {per_call.arg: per_call}
    for key, c, kw in (("kernel", cfg, kernel_kw), ("plain", cfg, plain_kw),
                       ("kernel32", cfg32, kernel_kw),
                       ("plain32", cfg32, plain_kw)):
        with route_log.run(key) if route_log else contextlib.nullcontext():
            lg, cache = zoo.prefill(c, params, batch, cache_len, **kw)
        if "k" in cache:
            assert cache["k"].device.type == dev.type
            # (L, S, ...), or the vlm's (supers, self layers, S, ...)
            seq_dim = 2 if cfg.family == "vlm" else 1
            assert cache["k"].shape[seq_dim] == cache_len
        runs[key] = (lg, cache[state] if state else None)
        del cache
    torch.cuda.synchronize()
    lg, lg32 = runs["kernel"][0], runs["kernel32"][0]
    assert tuple(lg.shape) == (4, cfg.padded_vocab)
    assert lg.dtype == torch.bfloat16 and lg32.dtype == torch.float32
    for out, st in runs.values():
        assert torch.isfinite(out).all()
        assert st is None or (st.device.type == dev.type
                              and torch.isfinite(st).all())
    checks = {"logits": held_to_plain(
        "logits", *(runs[k][0] for k in ("kernel", "plain", "kernel32",
                                         "plain32")),
        own_factor=bf16_own_factor)}
    if state:
        checks[state] = held_to_plain(
            state, *(runs[k][1] for k in ("kernel", "plain", "kernel32",
                                          "plain32")))
    lg, lg_plain = lg.float(), runs["plain"][0].float()
    logit_tol = checks["logits"]["logits_tol"]
    top2 = lg_plain.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * logit_tol
    same_argmax = bool(torch.equal(lg.argmax(-1)[clear],
                                   lg_plain.argmax(-1)[clear]))
    result = {
        "phase": "slice", "arch": cfg.arch_id, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model,
        "params": sum(t.numel() for t in tree_leaves(params)),
        "active_params": cfg.active_param_count(),
        "init_s": init_s, "requests": len(done),
        "prompt_lens": [len(p) for p in prompts], "generated_tokens": tokens,
        "waves": len(engine.stats), "prefill_calls": engine.prefill_calls,
        "launches": launches, "wall_s": wall, "tokens_per_s": tokens / wall,
        "prefill_s": engine.prefill_s, "decode_s": engine.decode_s,
        "peak_mem_bytes": peak,
        "mean_slot_utilization": engine.mean_slot_utilization,
        "compared_wave": compare_wave, "compared_prompt_len": plen,
        "compared_cache_len": cache_len,
        **{k: v for c in checks.values() for k, v in c.items() if k != "ok"},
        "logits_abs_max": float(lg_plain.abs().max()),
        "kernel_bf16_logits_err_vs_fp32": float((lg - lg32).abs().max()),
        "rows_with_clear_argmax": int(clear.sum()),
        "same_argmax_vs_plain": same_argmax}
    result["slice_kernels"] = kernels["kernels"]
    if per_call is not None:
        result["per_call"] = {"calls": per_call.calls, **per_call.worst}
    if route_log is not None:
        result["routing_flips_vs_plain"] = {
            "bfloat16": route_log.flips("kernel", "plain"),
            "float32": route_log.flips("kernel32", "plain32")}
        route_log.calls.clear()
    emit(result)
    for name, c in checks.items():
        assert c["ok"], (name, c)
    assert same_argmax
    if per_call is not None:
        # the kernel-path prefills in bf16 and fp32, each making every
        # counted call once
        assert per_call.calls == 2 * sum(counters.values()), per_call.calls
        assert all(h_["max_err_ratio"] <= 1.0
                   for h_ in per_call.worst.values()), per_call.worst
    del params, runs, lg, lg32, lg_plain
    torch.cuda.empty_cache()
    return result


def check_grads(gen, dev) -> dict:
    """The grad phase: each kernel's autograd Function on the card, in bf16
    and fp32 at ``GRAD_SHAPES``.  A random cotangent of every output goes
    back through the kernel path (the kernel forward, the recomputed VJP
    of the plain version) and through autograd of the plain differentiable
    version on the same inputs; every input must get a gradient (not None)
    within the kernel tolerances of the plain one."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru import rglru, rglru_plain
    from repro_torch.kernels.rwkv6 import wkv6, wkv6_plain
    from repro_torch.models import layers

    def dense(q, k, v):
        return layers._attention_torch(q, k, v, causal=True, window=None,
                                       q_offset=0, softcap=0.0)

    out = {}
    for kernel in (flash_attention, rglru, wkv6):
        name = kernel.__name__
        for dtype in (torch.bfloat16, torch.float32):
            dn = dtype_name(dtype)
            if name == "flash_attention":
                b, s_, h, kh, d = GRAD_SHAPES[name]
                ins = [torch.randn((b, s_, n, d), generator=gen, device=dev)
                       .to(dtype) for n in (h, kh, kh)]
                path = lambda q, k, v: (layers.attention(  # noqa: E731
                    q, k, v, causal=True),)
                plain = lambda q, k, v: (dense(q, k, v),)  # noqa: E731
                atol = rtol = TOL[dn]
            elif name == "rglru":
                ins = list(rglru_inputs(gen, dev, *GRAD_SHAPES[name], None,
                                        dtype))
                path, plain = rglru, rglru_plain
                atol = rtol = RGLRU_TOL[dn]
            else:
                b, h, s_, d = GRAD_SHAPES[name]
                ins = list(wkv6_inputs(gen, dev, b, h, s_, d, "model",
                                       dtype))
                path = lambda *a: wkv6(*a, floor=1e-8)  # noqa: E731
                plain = lambda *a: wkv6_plain(*a, floor=1e-8)  # noqa: E731
                atol, rtol = WKV6_TOL[dn]
            # leaves with the strides the model passes (views for WKV6)
            ins = [t.detach().requires_grad_(True) for t in ins]
            before = kernel.launches
            outs = path(*ins)
            launched = kernel.launches - before
            cots = [torch.randn(o.shape, generator=gen, device=dev)
                    .to(o.dtype) for o in outs]
            got = torch.autograd.grad(outs, ins, cots, allow_unused=True)
            want = torch.autograd.grad(plain(*ins), ins, cots,
                                       allow_unused=True)
            torch.cuda.synchronize()
            missing = [i for i, g in enumerate(got) if g is None]
            per_input = [held(g, w, atol, rtol) for g, w in zip(got, want)
                         if g is not None]
            h_ = per_input[0]
            for other in per_input[1:]:
                h_ = worse(h_, other)
            check = {"phase": "grad", "kernel": name, "dtype": dn,
                     "shape": list(ins[0].shape), "inputs": len(ins),
                     "inputs_without_grad": missing, "launches": launched,
                     **h_, "ok": (not missing and launched == 1
                                  and h_["max_err_ratio"] <= 1.0)}
            emit(check)
            assert check["ok"], check
            out[(name, dn)] = h_
    return out



def profile_train_step(step, state, batch, arch: str) -> dict:
    """One more train step under ``torch.profiler`` with CUDA activity:
    all device time, each group of ``KERNEL_GROUPS`` and the largest
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    device = [e for e in prof.profiler.kineto_results.events()
              if str(e.device_type()).endswith("CUDA")]
    total_ns = sum(e.duration_ns() for e in device)
    assert device and total_ns > 0, "the trace shows no device activity"
    names = {}
    for e in device:
        names[e.name()[:80]] = names.get(e.name()[:80], 0) + e.duration_ns()
    return {"phase": "train_kernels", "arch": arch,
            "device_ms": total_ns / 1e6, "groups": kernel_groups(device),
            "largest": [{"name": n, "device_ms": ns / 1e6,
                         "share": ns / total_ns} for n, ns in sorted(
                names.items(), key=lambda kv: -kv[1])[:8]]}


def olmo_train_setup():
    """The olmo-1b train phase's config and ``TrainConfig``."""
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig
    return get_config("olmo-1b"), TrainConfig(
        microbatches=TRAIN_MICRO, remat=True,
        optimizer=AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                              total_steps=TRAIN_STEPS))


def moe_train_setup():
    """The train_moe phase's config (mixtral-8x7b cut in depth) and
    ``TrainConfig``."""
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig
    return (dataclasses.replace(get_config("mixtral-8x7b"),
                                n_layers=MOE_TRAIN_LAYERS),
            TrainConfig(remat=True, optimizer=AdamWConfig(
                lr=TRAIN_LR, warmup_steps=1, total_steps=MOE_TRAIN_STEPS)))


def train_olmo(dev) -> dict:
    """The train phase: olmo-1b at full width (random weights from seed 0,
    fp32 params, bf16 activations), AdamW with fp32 moments,
    ``remat=True``, ``TRAIN_MICRO`` microbatches, ``TRAIN_STEPS`` steps on
    one fixed batch of ``SyntheticLM``.  Flash's launch count is zeroed
    just before the steps and read just after: 16 layers x 2 microbatches
    x (forward + remat recompute) x 4 steps."""
    import statistics

    import torch

    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.hw import H100
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.common import tree_leaves
    from repro_torch.train import init_state, make_train_step

    cfg, tcfg = olmo_train_setup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = init_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    source = SyntheticLM(DataConfig(seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH,
                                    vocab=cfg.vocab))
    batch = {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
             for k, v in source.batch_at(0).items()}
    step = make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    flash_attention.launches = 0
    times, metrics = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = flash_attention.launches
    peak = torch.cuda.max_memory_allocated()
    kernels = profile_train_step(step, state, batch, cfg.arch_id)

    tokens = TRAIN_BATCH * TRAIN_SEQ
    median_s = statistics.median(times[1:])
    flops = 6.0 * n_params * tokens
    losses = [m["loss"] for m in metrics]
    finite = all(math.isfinite(v) for m in metrics for v in m.values()) \
        and all(bool(torch.isfinite(t).all())
                for t in tree_leaves(state["params"]))
    expected = cfg.n_layers * TRAIN_MICRO * 2 * TRAIN_STEPS
    result = {
        "phase": "train", "arch": cfg.arch_id, "params": n_params,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "microbatches": TRAIN_MICRO,
        "remat": True, "activations": cfg.dtype,
        "param_dtype": cfg.param_dtype, "moment_dtype": "float32",
        "lr": TRAIN_LR, "init_s": init_s, "step_s": times,
        "median_step_s_2_to_4": median_s,
        "tokens_per_s": tokens / median_s,
        "flops_per_step_6NT": flops,
        "bf16_peak_share": flops / median_s / H100.peak_bf16_flops,
        "loss": losses, "lr_per_step": [m["lr"] for m in metrics],
        "grad_norm": [m["grad_norm"] for m in metrics],
        "peak_mem_bytes": peak, "mem_at_reset_bytes": base,
        "traced_step_device_ms": kernels["device_ms"],
        "flash_launches": launches, "expected_flash_launches": expected,
        "ok": finite and losses[-1] < losses[0] and launches == expected}
    emit(kernels)
    emit(result)
    assert result["ok"], result
    del state, batch
    torch.cuda.empty_cache()
    return result


def train_moe(dev) -> dict:
    """The train_moe phase: mixtral-8x7b at full width cut to
    ``MOE_TRAIN_LAYERS`` of 32 layers (random fp32 weights from seed 0,
    bf16 activations), AdamW with fp32 moments, ``remat=True``, one
    microbatch of B=``MOE_TRAIN_BATCH``, S=``TRAIN_SEQ``, ``MOE_TRAIN_STEPS``
    steps on one fixed ``SyntheticLM`` batch at the olmo phase's lr and
    warm-up.  Flash's launch count is zeroed just before the steps and read
    just after: layers x (forward + remat recompute) x steps.  ``loss_fn``
    on the batch before the steps and after them (ce and aux: 1 for
    balanced routing, E for all tokens on one expert), the router's
    gradient norm from one more backward, and a traced step
    (``train_kernels``); then ``moe_plain_witness``.
    The loss need not fall (ROADMAP.md: the olmo-1b step-2 rise is not
    explained); every loss and leaf must be finite and the router's
    gradient non-zero."""
    import statistics

    import torch

    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.hw import H100
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import zoo
    from repro_torch.models.common import tree_leaves
    from repro_torch.train import init_state, make_train_step

    cfg, tcfg = moe_train_setup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = init_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    active = cfg.active_param_count()
    source = SyntheticLM(DataConfig(seq_len=TRAIN_SEQ,
                                    global_batch=MOE_TRAIN_BATCH,
                                    vocab=cfg.vocab))
    batch = {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
             for k, v in source.batch_at(0).items()}
    step = make_train_step(cfg, tcfg)
    rcfg = dataclasses.replace(cfg, remat="full")
    with torch.no_grad():
        _, first = zoo.loss_fn(rcfg, state["params"], batch)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    flash_attention.launches = 0
    times, metrics = [], []
    for _ in range(MOE_TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = flash_attention.launches
    peak = torch.cuda.max_memory_allocated()

    params = {**state["params"], "layers": dict(state["params"]["layers"])}
    with torch.no_grad():
        loss, parts = zoo.loss_fn(rcfg, params, batch)
    router = params["layers"]["router"].detach().requires_grad_(True)
    params["layers"]["router"] = router
    (g_router,) = torch.autograd.grad(zoo.loss_fn(rcfg, params, batch)[0],
                                      [router])
    router_grad_norm = float(g_router.norm())
    del params, router, g_router
    kernels = profile_train_step(step, state, batch, cfg.arch_id)

    tokens = MOE_TRAIN_BATCH * TRAIN_SEQ
    median_s = statistics.median(times[1:])
    flops = 6.0 * active * tokens
    losses = [m["loss"] for m in metrics]
    finite = all(math.isfinite(v) for m in metrics for v in m.values()) \
        and math.isfinite(float(loss)) and all(
            bool(torch.isfinite(t).all()) for t in tree_leaves(state["params"]))
    expected = cfg.n_layers * 2 * MOE_TRAIN_STEPS
    result = {
        "phase": "train_moe", "arch": cfg.arch_id, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "experts": cfg.moe_experts,
        "top_k": cfg.moe_top_k, "params": n_params, "active_params": active,
        "batch": MOE_TRAIN_BATCH, "seq": TRAIN_SEQ, "microbatches": 1,
        "remat": True, "activations": cfg.dtype,
        "param_dtype": cfg.param_dtype, "moment_dtype": "float32",
        "lr": TRAIN_LR, "init_s": init_s, "step_s": times,
        "median_step_s_2_to_3": median_s,
        "tokens_per_s": tokens / median_s,
        "flops_per_step_6_active_T": flops,
        "bf16_peak_share": flops / median_s / H100.peak_bf16_flops,
        "loss": losses, "lr_per_step": [m["lr"] for m in metrics],
        "grad_norm": [m["grad_norm"] for m in metrics],
        "initial_ce": float(first["ce"]), "initial_aux": float(first["aux"]),
        "final_loss": float(loss), "final_ce": float(parts["ce"]),
        "final_aux": float(parts["aux"]),
        "router_grad_norm": router_grad_norm,
        "peak_mem_bytes": peak, "mem_at_reset_bytes": base,
        "flash_launches": launches, "expected_flash_launches": expected}
    del state
    torch.cuda.empty_cache()
    result["plain_attention_witness"] = moe_plain_witness(cfg, tcfg, dev,
                                                          batch)
    result["ok"] = finite and router_grad_norm > 0.0 and launches == expected
    emit(kernels)
    emit(result)
    assert result["ok"], result
    del batch
    torch.cuda.empty_cache()
    return result


def moe_plain_witness(cfg, tcfg, dev, batch) -> dict:
    """The train_moe steps once more from the same weights (seed 0) with
    ``layers.attention`` swapped for ``attention_plain``, so that no flash
    kernel runs: if the routing does here what it does in the kernel run,
    the kernel has no part in it.  Its losses and grad norms, and ce and
    aux after the steps; must be finite."""
    import torch

    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention)
    from repro_torch.models import layers, zoo
    from repro_torch.models.common import tree_leaves
    from repro_torch.train import init_state, make_train_step

    def plain(q, k, v, *, causal=True, window=None, q_offset=0,
              softcap=0.0):
        assert q_offset == 0 and not softcap, (q_offset, softcap)
        return attention_plain(q, k, v, causal=causal, window=window)

    attention, launches = layers.attention, flash_attention.launches
    layers.attention = plain
    try:
        state = init_state(cfg, tcfg,
                           torch.Generator(device=dev).manual_seed(0),
                           device=dev)
        step = make_train_step(cfg, tcfg)
        metrics = []
        for _ in range(MOE_TRAIN_STEPS):
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        with torch.no_grad():
            _, parts = zoo.loss_fn(dataclasses.replace(cfg, remat="full"),
                                   state["params"], batch)
        finite = all(math.isfinite(v) for m in metrics for v in m.values()) \
            and all(bool(torch.isfinite(t).all())
                    for t in tree_leaves(state["params"]))
    finally:
        layers.attention = attention
    assert flash_attention.launches == launches, "the witness ran flash"
    out = {"loss": [m["loss"] for m in metrics],
           "grad_norm": [m["grad_norm"] for m in metrics],
           "final_ce": float(parts["ce"]), "final_aux": float(parts["aux"])}
    assert finite and math.isfinite(out["final_aux"]), out
    del state
    torch.cuda.empty_cache()
    return out


def leaf_paths(tree: dict, prefix: str = "") -> list[str]:
    """The ``/`` paths of a nested dict's leaves, in ``tree_leaves`` order."""
    return [p for k, v in tree.items()
            for p in (leaf_paths(v, f"{prefix}{k}/") if isinstance(v, dict)
                      else [prefix + k])]


def train_grad_check(dev) -> dict:
    """One microbatch of olmo-1b at full width (B=1, S=``TRAIN_GRAD_SEQ``,
    fp32 params from seed 0): the loss's gradients through the kernel path
    against the same with ``self_attn=attention_plain``, per leaf.  In fp32
    (TF32 off) within 1e-3 of the leaf's largest |g|; in bf16 activations
    as the slices hold bf16 logits (``held_to_plain``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.models import zoo
    from repro_torch.models.common import tree_leaves, tree_map

    cfg = get_config("olmo-1b")
    params = zoo.init(cfg, torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    paths = leaf_paths(params)
    source = SyntheticLM(DataConfig(seq_len=TRAIN_GRAD_SEQ, global_batch=1,
                                    vocab=cfg.vocab, seed=1))
    batch = {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
             for k, v in source.batch_at(0).items()}
    grads, losses = {}, {}
    for dn in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dn)
        for path_name, kw in (("kernel", {}),
                              ("plain", {"self_attn": attention_plain})):
            leaves = tree_map(lambda _, p: p.detach().requires_grad_(True),
                              params)
            loss, _ = zoo.loss_fn(c, leaves, batch, **kw)
            losses[f"{dn}_{path_name}"] = float(loss.detach())
            # the non-parametric norms' scales get zeros
            grads[dn, path_name] = torch.autograd.grad(
                loss, tree_leaves(leaves), allow_unused=True,
                materialize_grads=True)
            del leaves, loss
    torch.cuda.synchronize()
    leaves_held = {}
    for i, path in enumerate(paths):
        leaves_held[path] = held_to_plain(
            "grad", grads["bfloat16", "kernel"][i],
            grads["bfloat16", "plain"][i], grads["float32", "kernel"][i],
            grads["float32", "plain"][i])
    ratio32 = {p: h["fp32_grad_max_abs_err_vs_plain"]
               / max(h["fp32_grad_tol"], 1e-30) for p, h in
               leaves_held.items()}
    ratio16 = {p: h["grad_max_abs_err_vs_plain"] / max(h["grad_tol"], 1e-30)
               for p, h in leaves_held.items()}
    result = {"phase": "train_grad", "arch": cfg.arch_id, "batch": 1,
              "seq": TRAIN_GRAD_SEQ, "losses": losses,
              "fp32_worst_leaf": max(ratio32, key=ratio32.get),
              "fp32_worst_gap_over_largest_g": 1e-3 * max(ratio32.values()),
              "bf16_worst_leaf": max(ratio16, key=ratio16.get),
              "bf16_worst_gap_over_largest_g":
                  LOGIT_RTOL["bfloat16"] * max(ratio16.values()),
              "leaves": leaves_held,
              "ok": all(h["ok"] for h in leaves_held.values())}
    emit(result)
    assert result["ok"], result
    del params, grads
    torch.cuda.empty_cache()
    return result


def held_bit_for_bit(got: list, want: list) -> dict:
    """Sharded against unsharded outputs (a list of tensors each): bit for
    bit, or else the largest gap beside the served slices' bf16 bound
    (``LOGIT_RTOL`` of the largest |value|), held."""
    import torch
    gap = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want))
    scale = max(float(b.float().abs().max()) for b in want)
    bound = LOGIT_RTOL["bfloat16"] * scale
    return {"bit_equal": len(got) == len(want) and all(
                a.shape == b.shape and bool(torch.equal(a, b))
                for a, b in zip(got, want)),
            "max_gap": gap, "bound": bound, "held": gap <= bound}


def multidevice_moe(mesh, dev, kernels) -> dict:
    """moe: the train_moe phase's mixtral-8x7b step (full width, 1 layer,
    B=2, S=2048, remat) for ``MULTI_MOE_STEPS`` steps, unsharded and then
    sharded by ``default_plan`` on ``mesh`` (experts on "model") from the
    same seed; the two states never coexist."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models.common import default_plan
    from repro_torch.sharding import distribute_tree, named_sharding_tree
    from repro_torch.train import init_state, make_train_step, state_specs

    cfg, tcfg = moe_train_setup()
    source = SyntheticLM(DataConfig(seq_len=TRAIN_SEQ,
                                    global_batch=MOE_TRAIN_BATCH,
                                    vocab=cfg.vocab))
    batch = {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
             for k, v in source.batch_at(0).items()}
    runs = {}
    for name in ("unsharded", "sharded"):
        c = dataclasses.replace(cfg, batch_axes=("data",)) \
            if name == "sharded" else cfg
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = init_state(c, tcfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
        if name == "sharded":
            state = distribute_tree(state, named_sharding_tree(
                default_plan(), mesh, state_specs(c, tcfg)))
            step = make_train_step(c, tcfg, batch_axes=("data",))
        else:
            step = make_train_step(c, tcfg)
        for k in kernels:
            k.launches = 0
        losses, times, comms = [], [], []
        for _ in range(MULTI_MOE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with CommDebugMode() as cm:
                state, m = step(state, batch)
                losses.append(m["loss"].detach().clone())
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            comms.append(cm.get_total_counts())
        runs[name] = {"losses": losses, "step_s": times,
                      "collectives_per_step": comms,
                      "launches": {k.__name__: k.launches for k in kernels},
                      "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        if name == "sharded":
            runs[name]["w_gate_placements"] = str(
                state["params"]["layers"]["w_gate"].placements)
        del state, step
    want = runs["unsharded"].pop("losses")
    held = held_bit_for_bit(runs["sharded"].pop("losses"), want)
    return {"family": "moe", "arch": cfg.arch_id, "run": "train step",
            "layers": cfg.n_layers, "batch": MOE_TRAIN_BATCH,
            "seq": TRAIN_SEQ, "loss": [float(x) for x in want], **held,
            **{f"{k}_{n}": v for n, r in runs.items() for k, v in r.items()},
            "step_ratio": sum(runs["sharded"]["step_s"][1:])
            / sum(runs["unsharded"]["step_s"][1:])}


def multidevice_serve(mesh, dev, kernels, arch: str) -> dict:
    """A served family: prefill of ``MULTI_SERVE_BATCH`` prompts and
    ``MULTI_DECODE_STEPS`` decode steps (each step's token the unsharded
    run's argmax, fed to both runs), unsharded and then on params placed
    by ``default_plan`` on ``mesh`` with the cache placed by
    ``cache_shardings``, from the same bf16 weights (seed 0; rwkv6's zero
    leaves and the vlm's gates drawn as in their slices)."""
    import numpy as np
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    from repro_torch.models.common import default_plan
    from repro_torch.serving import cache_shardings
    from repro_torch.sharding import distribute_tree, named_sharding_tree
    from repro_torch.train import make_prefill_step, make_serve_step

    prompt_len, max_len, depth = MULTI_SERVE[arch]
    cfg = get_config(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = zoo.init(cfg, gen, device=dev)
    if cfg.family == "ssm":
        draw_rwkv6_leaves(params, gen)
    if cfg.family == "vlm":
        draw_vlm_gates(params, gen)
    cast_as_you_go(params, cfg.activation_dtype)
    rng = np.random.default_rng(0)
    b = MULTI_SERVE_BATCH
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, size=(b, prompt_len)), device=dev)}
    if zoo.needs_frontend(cfg):
        batch["frontend"] = frontend_for(cfg, dev).expand(b, -1, -1)
    ml = zoo.cache_max_len(cfg, max_len)
    scfg = dataclasses.replace(cfg, batch_axes=("data",))
    plan = default_plan()
    runs, tokens = {}, []
    for name in ("unsharded", "sharded"):
        if name == "sharded":
            # the placed tree stands alone: the unsharded one is dropped,
            # so that the peak is the sharded run's own
            p = distribute_tree(params, named_sharding_tree(
                plan, mesh, zoo.specs(scfg)))
            del params
            shardings, strategy = cache_shardings(
                scfg, plan, mesh, zoo.abstract_cache(scfg, b, ml),
                model_degree=mesh.shape[1])
            prefill = make_prefill_step(scfg, ml, shardings)
            decode = make_serve_step(scfg)
        else:
            p = params
            prefill, decode = make_prefill_step(cfg, ml), make_serve_step(cfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels:
            k.launches = 0
        comms = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with CommDebugMode() as cm:
            logits, cache = prefill(p, batch)
        comms.append(cm.get_total_counts())
        outs = [logits]
        for i in range(MULTI_DECODE_STEPS):
            if name == "unsharded":
                tokens.append(torch.argmax(logits, dim=-1))
            with CommDebugMode() as cm:
                logits, cache = decode(p, cache, tokens[i], prompt_len + i)
            comms.append(cm.get_total_counts())
            outs.append(logits)
        torch.cuda.synchronize()
        runs[name] = {"wall_s": time.perf_counter() - t0, "outs": outs,
                      "collectives_per_step": comms,
                      "launches": {k.__name__: k.launches for k in kernels},
                      "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                      "cache_len": int(cache["len"])}
        if name == "sharded":
            runs[name]["cache_placements"] = sorted({
                str(t.placements) for t in leaves_of(cache)})
            runs[name]["strategy"] = strategy
        del cache, p, outs, logits
    held = held_bit_for_bit(runs["sharded"].pop("outs"),
                            runs["unsharded"].pop("outs"))
    return {"family": cfg.family, "arch": cfg.arch_id,
            "run": f"prefill + {MULTI_DECODE_STEPS} decode steps",
            "layers": cfg.n_layers, "batch": b, "prompt_len": prompt_len,
            "max_len": ml, **held,
            **{f"{k}_{n}": v for n, r in runs.items() for k, v in r.items()},
            "wall_ratio": runs["sharded"]["wall_s"]
            / runs["unsharded"]["wall_s"]}


def leaves_of(tree) -> list:
    import torch
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves_of(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def multidevice_child(tmp: str) -> dict:
    """The multidevice phase's child: NCCL at world size 1 on card 0, the
    train phase's olmo-1b state placed by ``default_plan`` on a (1, 1)
    mesh, ``MULTI_STEPS`` sharded steps, the checkpoint round trip and the
    ring collective matmul.  Returns its line."""
    import statistics
    import socket

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru import rglru
    from repro_torch.kernels.rwkv6 import wkv6
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import default_plan, tree_leaves
    from repro_torch.sharding import (distribute_tree, named_sharding_tree,
                                      ring_ag_matmul)
    from repro_torch.train import (CheckpointManager, init_state,
                                   make_train_step, state_specs)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1, device_id=dev)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        cfg, tcfg = olmo_train_setup()
        cfg = dataclasses.replace(cfg, batch_axes=("data",))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem_at_reset = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        shardings = named_sharding_tree(default_plan(), mesh,
                                        state_specs(cfg, tcfg))
        state = distribute_tree(
            init_state(cfg, tcfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev), shardings)
        source = SyntheticLM(DataConfig(seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH,
                                        vocab=cfg.vocab))
        batch = {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
                 for k, v in source.batch_at(0).items()}
        step = make_train_step(cfg, tcfg, batch_axes=("data",))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0

        kernels = (flash_attention, rglru, wkv6)
        for k in kernels:
            k.launches = 0
        times, losses, comms = [], [], {}
        for i in range(MULTI_STEPS):
            t0 = time.perf_counter()
            if i == 0:
                # the first step (not in the median) under the counter
                with CommDebugMode() as cm:
                    state, m = step(state, batch)
                    torch.cuda.synchronize()
                comms = {"total": cm.get_total_counts(),
                         "by_op": {str(op): n for op, n in
                                   cm.get_comm_counts().items()}}
            else:
                state, m = step(state, batch)
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        launches = {k.__name__: k.launches for k in kernels}
        peak = torch.cuda.max_memory_allocated()
        placements = sorted({str(t.placements)
                             for t in tree_leaves(state["params"])})
        vs_card = sharded_step_vs_card(
            mesh, cfg, tcfg, card_peak=peak - mem_at_reset,
            card_step_s=statistics.median(times[1:]),
            card_collectives=comms["total"])
        # one more step under the profiler: the device's share of its wall
        t0 = time.perf_counter()
        trace = profile_train_step(step, state, batch, cfg.arch_id)
        traced = {"wall_s": time.perf_counter() - t0,
                  "device_ms": trace["device_ms"],
                  "groups": trace["groups"]}
        traced["device_busy_share"] = traced["device_ms"] / 1e3 \
            / traced["wall_s"]

        t0 = time.perf_counter()
        mgr = CheckpointManager(tmp, device=dev)
        mgr.save(MULTI_STEPS, state, block=True)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, _, back_step = mgr.restore(shardings=shardings)
        restore_s = time.perf_counter() - t0
        pairs = list(zip(tree_leaves(state), tree_leaves(back)))
        exact = back_step == MULTI_STEPS and len(pairs) == len(
            tree_leaves(shardings)) and all(
            a.placements == b.placements and a.dtype == b.dtype
            and torch.equal(a.to_local(), b.to_local()) for a, b in pairs)
        ck_bytes = sum(a.numel() * a.element_size() for a, _ in pairs)
        del back, pairs, state
        torch.cuda.empty_cache()

        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(TRAIN_BATCH * TRAIN_SEQ, cfg.d_model, generator=gen,
                        device=dev).to(torch.bfloat16)
        w = torch.randn(cfg.d_model, cfg.d_ff, generator=gen,
                        device=dev).to(torch.bfloat16)
        y = ring_ag_matmul(x, w, mesh=mesh, axis="model")
        ref = torch.matmul(x, w)
        ring = {"shape": [list(x.shape), list(w.shape)], "dtype": "bfloat16",
                "bit_equal": bool(torch.equal(y, ref)),
                "ms": cuda_ms(lambda: ring_ag_matmul(x, w, mesh=mesh,
                                                     axis="model")),
                "matmul_ms": cuda_ms(lambda: torch.matmul(x, w))}
        del x, w, y, ref
        torch.cuda.empty_cache()
        families = [multidevice_moe(mesh, dev, kernels)]
        families += [multidevice_serve(mesh, dev, kernels, arch)
                     for arch in MULTI_SERVE]
        return {"phase": "multidevice", "backend": dist.get_backend(),
                "world_size": dist.get_world_size(),
                "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                "plan": "default_plan", "batch_axes": ["data"],
                "param_placements": placements, "init_s": init_s,
                "step_s": times,
                "median_step_s": statistics.median(times[1:]),
                "loss": losses, "peak_mem_bytes": peak,
                "collectives_first_step": comms, "launches": launches,
                "traced_step": traced,
                "checkpoint": {"exact": exact, "bytes": ck_bytes,
                               "save_s": save_s, "restore_s": restore_s},
                "ring_ag_matmul": ring, "families": families,
                "dryrun_vs_card": vs_card}
    finally:
        dist.destroy_process_group()


def sharded_step_vs_card(mesh, cfg, tcfg, *, card_peak: int,
                         card_step_s: float, card_collectives: int) -> dict:
    """The ``dryrun_vs_card`` row of the sharded olmo-1b step: the step
    the multidevice child just ran, counted on meta on the same mesh by
    ``launch.dryrun.lower_cell`` (the DTensor count: one rank's ops, its
    kernels on local shapes, every collective it dispatches), beside the
    card: predicted peak against ``max_memory_allocated`` less what was
    allocated before the state was made (within 10 %), the roofline's
    ``step_s_overlapped`` against the median step (a share of at most
    1.05), and the counted collectives, which must be 0 and equal the
    child's ``CommDebugMode`` count."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.hw import H100Spec
    from repro_torch.launch import dryrun
    from repro_torch.models.common import default_plan

    shape = ShapeSpec("olmo-1b sharded train", "train", TRAIN_SEQ,
                      TRAIN_BATCH)
    t0 = time.perf_counter()
    rec = dryrun.lower_cell(cfg, shape, mesh, plan=default_plan(),
                            tcfg=tcfg, spec=H100Spec.from_device(0))
    r = rec["roofline"]
    counted = sum(k["count"] for k in rec["collectives"]["by_kind"].values())
    row = {"phase": "dryrun_vs_card", "cell": shape.name,
           "mesh": rec["mesh"], "B": shape.global_batch, "S": shape.seq_len,
           "microbatches": tcfg.microbatches,
           "predicted_peak_bytes": rec["peak_bytes"],
           "card_peak_bytes": card_peak,
           "peak_ratio": rec["peak_bytes"] / card_peak,
           "flops_by_dtype": rec["flops_by_dtype"],
           "kernel_calls": {k: v["calls"] for k, v in rec["kernels"].items()},
           "counted_over_model_flops": 1.0 / rec["useful_flops_ratio"],
           "bytes": rec["bytes_per_device"],
           "compute_s": r["compute_s"], "memory_s": r["memory_s"],
           "collective_s": r["collective_s"], "dominant": r["dominant"],
           "step_s_overlapped": r["step_s_overlapped"],
           "card_step_s": card_step_s,
           "share": r["step_s_overlapped"] / card_step_s,
           "collectives_counted": counted,
           "collectives_card": card_collectives,
           "count_s": time.perf_counter() - t0}
    row["ok"] = (abs(row["peak_ratio"] - 1.0) <= 0.10 and row["share"] <= 1.05
                 and counted == card_collectives == 0)
    return row


def multidevice(train: dict) -> dict:
    """The multidevice phase: ``multidevice_child`` in a process of its
    own (a process group of its own, the card's memory its own), its line
    checked against the unsharded train phase's."""
    import tempfile

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    parent_allocated = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--multidevice", tmp], capture_output=True,
                             text=True, timeout=MULTI_TIMEOUT_S,
                             stdin=subprocess.DEVNULL)
        wall = time.perf_counter() - t0
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert out.returncode == 0 and lines, (out.returncode,
                                           out.stderr[-4000:])
    line = json.loads(lines[-1])
    gaps = [abs(a - b) for a, b in zip(line["loss"], train["loss"])]
    line.update({
        "wall_s": wall, "parent_allocated_bytes": parent_allocated,
        "unsharded_loss": train["loss"][:MULTI_STEPS],
        "loss_gap": gaps, "loss_tol": MULTI_LOSS_TOL,
        "unsharded_median_step_s": train["median_step_s_2_to_4"],
        "step_ratio": line["median_step_s"] / train["median_step_s_2_to_4"],
        "unsharded_peak_mem_bytes": train["peak_mem_bytes"],
        "unsharded_traced_step_device_ms": train["traced_step_device_ms"],
        "peak_ratio": line["peak_mem_bytes"] / train["peak_mem_bytes"]})
    # each rank's attention is one card's: flash forward in every layer,
    # microbatch and remat recompute, as the train phase counts it
    expected = train["expected_flash_launches"] // TRAIN_STEPS * MULTI_STEPS
    line["expected_launches"] = {"flash_attention": expected, "rglru": 0,
                                 "wkv6": 0}
    families = line.pop("families")
    for fam in families:
        fam["phase"] = "multidevice_family"
        fam["ok"] = multidevice_family_ok(fam)
        emit(fam)
    vs_card = line.pop("dryrun_vs_card")
    emit(vs_card)
    line["dryrun_vs_card_ok"] = vs_card["ok"]
    line["families_ok"] = {f["arch"]: f["ok"] for f in families}
    line["launches_by_family"] = {f["arch"]: f["launches_sharded"]
                                  for f in families}
    line["ok"] = (len(gaps) == MULTI_STEPS
                  and max(gaps) <= MULTI_LOSS_TOL
                  and line["backend"] == "nccl"
                  and line["checkpoint"]["exact"]
                  and line["ring_ag_matmul"]["bit_equal"]
                  and line["launches"] == line["expected_launches"]
                  and len(families) == 1 + len(MULTI_SERVE)
                  and all(f["ok"] for f in families)
                  and vs_card["ok"]
                  and wall <= MULTI_TIMEOUT_S)
    emit(line)
    assert line["ok"], line
    return line


# the kernels each family's sharded path must launch (no fallback to a
# plain version on the card)
FAMILY_KERNELS = {"dense": ("flash_attention",), "moe": ("flash_attention",),
                  "hybrid": ("flash_attention", "rglru"),
                  "ssm": ("wkv6",), "vlm": ("flash_attention",),
                  "audio": ("flash_attention",)}


def multidevice_family_ok(fam: dict) -> bool:
    """A family's sharded run held against its unsharded one: outputs bit
    for bit or within the served slices' bound, the same launches of every
    kernel (each of the family's own at least once), no collective."""
    sharded, unsharded = fam["launches_sharded"], fam["launches_unsharded"]
    return ((fam["bit_equal"] or fam["held"])
            and sharded == unsharded
            and all(sharded[k] > 0 for k in FAMILY_KERNELS[fam["family"]])
            and all(n == 0 for n in fam["collectives_per_step_sharded"]))


def dryrun_matrix(spec) -> dict:
    """The dryrun phase: every (arch x shape) cell of the reference's
    matrix counted on meta at full depth (``launch.dryrun.run_cells``)
    against ``spec``, the card's: one line a cell (its roofline terms,
    dominant term, peak and whether it fits the card; or the reference's
    reason to skip it) and a summary.  A cell that fails to count raises."""
    from repro_torch.configs import ARCH_IDS, SHAPES
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    records = dryrun.run_cells(ARCH_IDS, SHAPES, None, spec=spec,
                               verbose=False, raise_errors=True)
    seconds = time.perf_counter() - t0
    for rec in records:
        if "skipped" in rec:
            emit({"phase": "dryrun_cell", **rec})
            continue
        r = rec["roofline"]
        emit({"phase": "dryrun_cell", "arch": rec["arch"],
              "shape": rec["shape"], "kind": rec["kind"],
              "microbatches": rec["microbatches"],
              "flops_by_dtype": rec["flops_by_dtype"],
              "bytes": rec["bytes_per_device"],
              "peak_bytes": rec["hbm_bytes_per_device_est"],
              "fits_hbm": rec["fits_hbm"], "compute_s": r["compute_s"],
              "memory_s": r["memory_s"], "dominant": r["dominant"],
              "step_s_overlapped": r["step_s_overlapped"],
              "useful_flops_ratio": rec["useful_flops_ratio"],
              "kernel_calls": {k: v["calls"]
                               for k, v in rec["kernels"].items()},
              "count_s": rec["compile_seconds"]})
    counted = [r for r in records if "roofline" in r]
    result = {"phase": "dryrun", "cells": len(records),
              "counted": len(counted),
              "skipped": {f"{r['arch']} {r['shape']}": r["skipped"]
                          for r in records if "skipped" in r},
              "fit": [f"{r['arch']} {r['shape']}" for r in counted
                      if r["fits_hbm"]],
              "depth": "full (no extrapolation)", "seconds": seconds,
              "spec": dataclasses.asdict(spec),
              "ok": len(records) == len(ARCH_IDS) * len(SHAPES) == 40
              and all("roofline" in r or "skipped" in r for r in records)}
    emit(result)
    assert result["ok"], result
    return result


# the dryrun_mesh phase: every cell of the reference's matrix on its 16x16
# mesh, and on 2x16x16 every arch's cells of these shapes.  On 2x16x16
# DTensor's sharding propagation takes minutes a train cell on the CPU (PERF.md
# section 6, PR 24), so one train cell a family would not fit the phase;
# ``python -m repro_torch.launch.dryrun --mesh multi`` counts them all.  The
# child's time limit
DRYRUN_MULTI_SHAPES = ("decode_32k", "long_500k")
DRYRUN_MESH_TIMEOUT_S = 600
# the dense family's train cells on 16x16 as torch 2.13 counts them on a
# CPU (``python -m repro_torch.launch.dryrun --mesh single --extrapolate
# --device cpu``): one rank's flops and peak bytes.  Every GEMM of the step
# now runs with the plan's placements (``layers.tp_matmul``, the
# vocab-parallel loss), not DTensor's choice, so the card's torch must
# count the same cells within DRYRUN_MESH_MATCH of both
DRYRUN_MESH_CPU_DENSE_TRAIN = {
    "olmo-1b": (44321130676224.0, 4867063832),
    "granite-3-8b": (292911673507840.0, 8666316824),
    "codeqwen1.5-7b": (273601668317184.0, 5760688160),
    "llama3-405b": (1.2866486632710144e+16, 29472653332),
}
DRYRUN_MESH_MATCH = 0.01


def dryrun_mesh_cell(rec: dict, wall: float) -> dict:
    """One line of the dryrun_mesh phase: a counted cell's roofline terms,
    dominant term, one rank's peak and whether it fits the card, its
    collectives by kind (the counted step: one microbatch, or the deeper
    of the two extrapolation depths) with the step's ici and dci link
    bytes and their time, the decode cache's strategy and the seconds the
    cell took; or the reference's reason to skip it; or its error."""
    head = {"phase": "dryrun_mesh_cell", "mesh": rec["mesh_name"]
            if "roofline" in rec else rec["mesh"], "arch": rec["arch"],
            "shape": rec["shape"], "count_s": wall}
    if "skipped" in rec:
        return {**head, "skipped": rec["skipped"]}
    if "error" in rec:
        return {**head, "error": rec["error"],
                "traceback_tail": rec["traceback"][-2000:]}
    r, c = rec["roofline"], rec["collectives"]
    return {**head, "kind": rec["kind"], "devices": rec["devices"],
            "microbatches": rec["microbatches"],
            "extrapolated_from": rec.get("cost_extrapolated_from"),
            "compute_s": r["compute_s"], "memory_s": r["memory_s"],
            "collective_s": r["collective_s"], "dominant": r["dominant"],
            "step_s_overlapped": r["step_s_overlapped"],
            "peak_bytes": rec["hbm_bytes_per_device_est"],
            "fits_hbm": rec["fits_hbm"],
            "by_kind_counted": c["by_kind"],
            "ici_link_bytes_step": c["ici_link_bytes_step"],
            "dci_link_bytes_step": c["dci_link_bytes_step"],
            "kv_strategy": rec.get("kv_strategy"),
            "flops_per_device": rec["flops_per_device"],
            # 6·N·T (2·N·T serving) over (one rank's flops x ranks)
            "useful_flops_ratio": rec["useful_flops_ratio"],
            "replicated_gemms": rec["replicated_gemms"]}


def dryrun_mesh_child() -> dict:
    """The dryrun_mesh phase's child: the reference's matrix counted by
    ``launch.dryrun.run_cells`` on its 16x16 mesh (one rank's share over
    a fake world of 256 ranks, ``launch.mesh.count_mesh``; no collective
    runs) at ``depth_plan``'s depths where it gives any, against the
    card's spec, then on 2x16x16 (512 ranks) every arch's cells of
    ``DRYRUN_MULTI_SHAPES``; a line a cell as it is counted.  Returns the
    summary: cells counted, skipped with the reference's reason, in
    error, fitting the card, seconds a mesh; on 16x16 also the dense
    family's GEMMs run replicated (train and prefill cells: none may be)
    and its train cells' flops and peak against the CPU's count
    (``DRYRUN_MESH_CPU_DENSE_TRAIN``)."""
    from repro_torch.configs import ARCH_IDS, SHAPES, get_config
    from repro_torch.hw import H100Spec
    from repro_torch.launch import dryrun

    spec = H100Spec.from_device(0)
    runs = [("single", [(a, s) for a in ARCH_IDS for s in SHAPES]),
            ("multi", [(a, s) for a in ARCH_IDS
                       for s in DRYRUN_MULTI_SHAPES])]
    summary = {"phase": "dryrun_mesh", "spec": dataclasses.asdict(spec),
               "meshes": {}}
    for mesh_name, cells in runs:
        records, last = [], [time.perf_counter()]
        t0 = last[0]

        def line(rec, records=records, last=last):
            now = time.perf_counter()
            records.append(rec)
            emit(dryrun_mesh_cell(rec, now - last[0]))
            last[0] = now

        for arch, shape in cells:
            dryrun.run_cells([arch], [shape], None, [mesh_name], spec=spec,
                             extrapolate=True, verbose=False,
                             on_record=line)
        counted = [r for r in records if "roofline" in r]
        summary["meshes"][mesh_name] = {
            "cells": len(records), "counted": len(counted),
            "skipped": sum("skipped" in r for r in records),
            "errors": [f"{r['arch']} {r['shape']}" for r in records
                       if "error" in r],
            "fit": [f"{r['arch']} {r['shape']}" for r in counted
                    if r["fits_hbm"]],
            "dominant": {k: sum(r["roofline"]["dominant"] == k
                                for r in counted)
                         for k in ("compute", "memory", "collective")},
            "seconds": time.perf_counter() - t0}
        if mesh_name == "single":
            dense = [r for r in counted
                     if get_config(r["arch"]).family == "dense"
                     and r["kind"] in ("train", "prefill")]
            summary["dense_replicated_gemms"] = {
                f"{r['arch']} {r['shape']}": r["replicated_gemms"]
                for r in dense}
            cpu = DRYRUN_MESH_CPU_DENSE_TRAIN
            summary["dense_train_vs_cpu"] = {r["arch"]: {
                "flops_ratio": r["flops_per_device"] / cpu[r["arch"]][0],
                "peak_ratio": r["hbm_bytes_per_device_est"]
                / cpu[r["arch"]][1]} for r in dense if r["kind"] == "train"}
    vs_cpu = summary["dense_train_vs_cpu"]
    summary["ok"] = all(m["cells"] == m["counted"] + m["skipped"]
                        and not m["errors"]
                        for m in summary["meshes"].values()) and \
        summary["meshes"]["single"]["cells"] == len(ARCH_IDS) * len(SHAPES) \
        and not any(summary["dense_replicated_gemms"].values()) \
        and sorted(vs_cpu) == sorted(DRYRUN_MESH_CPU_DENSE_TRAIN) \
        and all(abs(v - 1.0) <= DRYRUN_MESH_MATCH
                for row in vs_cpu.values() for v in row.values())
    return summary


def dryrun_mesh() -> dict:
    """The dryrun_mesh phase: ``dryrun_mesh_child`` in a process of its
    own (a fake process group of its own), its lines relayed; the
    summary's ``ok`` needs every cell counted or skipped with the
    reference's reason and none in error.  A cell that fails to count
    fails the phase and the run."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--dryrun-mesh"], capture_output=True, text=True,
                         timeout=DRYRUN_MESH_TIMEOUT_S,
                         stdin=subprocess.DEVNULL)
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    for ln in lines[:-1]:
        emit(ln)
    assert out.returncode == 0 and lines, (out.returncode,
                                           out.stderr[-4000:])
    summary = {**lines[-1], "wall_s": time.perf_counter() - t0}
    emit(summary)
    assert summary["ok"], summary
    return summary


# the olmo-1b served prefill the dry-run is held to: the olmo-1b slice's
# longest wave (B=4, S=512), timed over PREFILL_CALLS calls
PREFILL_BATCH, PREFILL_SEQ, PREFILL_CALLS = 4, 512, 6


def card_prefill(dev, cfg, max_len: int) -> dict:
    """The olmo-1b served prefill on the card: params cast as the slice
    casts them, ``PREFILL_CALLS`` calls of ``zoo.prefill`` (each to a
    sync), the median of all but the first, and the peak above what was
    allocated before the first, with the params' and tokens' bytes."""
    import statistics

    import torch

    from repro_torch.hw.cost import addressed_bytes, tensor_leaves
    from repro_torch.models import zoo

    gen = torch.Generator(device=dev).manual_seed(0)
    params = zoo.init(cfg, gen, device=dev)
    cast_as_you_go(params, cfg.activation_dtype)
    batch = {"tokens": torch.randint(0, cfg.vocab,
                                     (PREFILL_BATCH, PREFILL_SEQ),
                                     generator=gen, device=dev)}
    args = sum(addressed_bytes(t) for t in tensor_leaves((params, batch)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = []
    with torch.no_grad():
        for _ in range(PREFILL_CALLS):
            t0 = time.perf_counter()
            out = zoo.prefill(cfg, params, batch, max_len)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del out
    peak = torch.cuda.max_memory_allocated()
    del params, batch
    torch.cuda.empty_cache()
    return {"median_s": statistics.median(times[1:]),
            "peak_bytes": peak - base + args}


def dryrun_vs_card(dev, spec, train: dict, moe_train: dict) -> list:
    """The dryrun_vs_card phase: the shapes the card ran in this call
    counted on meta (``launch.dryrun.lower_cell``), beside what the card
    measured: the olmo-1b train phase, train_moe and the olmo-1b served
    prefill.  For each, the predicted peak (arguments and all they
    allocate) against the card's (``max_memory_allocated`` less what was
    allocated before the phase began, the phase's own arguments included)
    and their ratio (within 10 %); the counted flops by class against
    6·N·T (2·N·T to serve); the measured median step against the
    roofline's ``step_s_overlapped`` and the share of it the step reaches
    (at most 1.05: no step may run faster than its bound)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.models import zoo

    olmo, olmo_tcfg = olmo_train_setup()
    moe, moe_tcfg = moe_train_setup()
    prefill = ShapeSpec("olmo-1b served prefill", "prefill", PREFILL_SEQ,
                        PREFILL_BATCH)
    card = card_prefill(dev, olmo, zoo.cache_max_len(olmo, PREFILL_SEQ))
    cells = (
        (olmo, olmo_tcfg, ShapeSpec("olmo-1b train", "train", TRAIN_SEQ,
                                    TRAIN_BATCH),
         train["peak_mem_bytes"] - train["mem_at_reset_bytes"],
         train["median_step_s_2_to_4"]),
        (moe, moe_tcfg, ShapeSpec("mixtral-8x7b train_moe", "train",
                                  TRAIN_SEQ, MOE_TRAIN_BATCH),
         moe_train["peak_mem_bytes"] - moe_train["mem_at_reset_bytes"],
         moe_train["median_step_s_2_to_3"]),
        (olmo, None, prefill, card["peak_bytes"], card["median_s"]))
    out = []
    for cfg, tcfg, shape, card_peak, card_s in cells:
        rec = dryrun.lower_cell(cfg, shape, tcfg=tcfg, spec=spec)
        r = rec["roofline"]
        row = {"phase": "dryrun_vs_card", "cell": shape.name,
               "B": shape.global_batch, "S": shape.seq_len,
               "predicted_peak_bytes": rec["peak_bytes"],
               "card_peak_bytes": card_peak,
               "peak_ratio": rec["peak_bytes"] / card_peak,
               "flops_by_dtype": rec["flops_by_dtype"],
               "kernel_calls": {k: v["calls"]
                                for k, v in rec["kernels"].items()},
               "model_flops_6NT_or_2NT": rec["model_flops_global"],
               "counted_over_model_flops": 1.0 / rec["useful_flops_ratio"],
               "bytes": rec["bytes_per_device"],
               "compute_s": r["compute_s"], "memory_s": r["memory_s"],
               "dominant": r["dominant"],
               "step_s_overlapped": r["step_s_overlapped"],
               "card_step_s": card_s,
               "share": r["step_s_overlapped"] / card_s}
        row["ok"] = abs(row["peak_ratio"] - 1.0) <= 0.10 and \
            row["share"] <= 1.05
        emit(row)
        out.append(row)
    assert all(r["ok"] for r in out), out
    return out


# the runtime phase: four independent olmo-1b prefills (one request a chain,
# distinct lengths, so distinct size keys) through RealGraphExecutor at
# 1 and 4 workers
RUNTIME_PROMPTS = (512, 384, 256, 128)
RUNTIME_WORKERS = (1, 4)
RUNTIME_SIM_MODELS = ("resnet50", "dcgan", "inception_v3")


def runtime_sim() -> dict:
    """``examples/quickstart.py``'s flow through the port's copy of the
    paper's runtime: the recommendation (1 x 68 threads), the manual best
    uniform configuration and the runtime's Strategies 1-4 per paper
    graph.  Every time here is the simulated KNL's (``SimMachine``), not
    the card's."""
    from repro_torch.core import (ConcurrencyRuntime, SimMachine,
                                  build_paper_graph, manual_best_schedule,
                                  uniform_schedule)

    machine = SimMachine()
    models = {}
    for model in RUNTIME_SIM_MODELS:
        graph = build_paper_graph(model)
        rt = ConcurrencyRuntime()
        summary = rt.train(graph, total_steps=10_000)
        result = rt.execute_step(graph)
        manual, best = manual_best_schedule(graph, machine)
        rec = uniform_schedule(graph, machine, intra=68, inter=1)
        models[model] = {
            "ops": graph.n_ops, "recommendation_ms": rec.makespan * 1e3,
            "manual_best_ms": manual.makespan * 1e3,
            "manual_best_inter_intra": list(best),
            "runtime_ms": summary.step_time * 1e3,
            "speedup": summary.speedup,
            "mean_corun": result.mean_corunning,
            "profiling_steps": summary.profiling_steps,
            "profiling_overhead": summary.profiling_overhead}
        assert 0 < summary.step_time <= rec.makespan, (model, models[model])
    out = {"phase": "runtime_sim",
           "clock": f"SimMachine {machine.spec.name} (simulated, not the "
                    "card)", "models": models}
    emit(out)
    return out


def run_inline(graph) -> dict:
    """The witness: every payload in ``graph.topo_order()`` on the
    caller's stream, with no executor."""
    vals = {}
    for u in graph.topo_order():
        op = graph.ops[u]
        vals[u] = op.payload({d: vals[d] for d in op.deps})
    return vals


def max_overlap(spans: dict) -> int:
    """The most (start, end) intervals open at one instant."""
    edges = sorted([(s, 1) for s, _ in spans.values()]
                   + [(e, -1) for _, e in spans.values()])
    most = open_ = 0
    for _, step in edges:
        open_ += step
        most = max(most, open_)
    return most


def flash_streams(graph, workers: int) -> int:
    """The distinct CUDA streams flash ran on in one more run of ``graph``
    at ``workers``, from a ``torch.profiler`` trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import RealGraphExecutor
    from repro_torch.kernels.flash_attention import flash_attention

    flash_attention.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        RealGraphExecutor(max_workers=workers).run(graph)
        torch.cuda.synchronize()
    evs = [e for e in prof.profiler.kineto_results.events()
           if str(e.device_type()).endswith("CUDA")
           and KERNEL_SYMBOLS["flash_attention"] in e.name()]
    assert len(evs) == flash_attention.launches, \
        (len(evs), flash_attention.launches)
    return len({e.device_resource_id() for e in evs})


def olmo_runtime_setup(dev) -> tuple:
    """olmo-1b at full width and depth, bf16, weights from seed 0, and
    the prompts of ``RUNTIME_PROMPTS``: what ``runtime_exec`` and
    ``service_exec`` run."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import zoo

    cfg = get_config("olmo-1b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in RUNTIME_PROMPTS]
    gen = torch.Generator(device=dev).manual_seed(0)
    params = zoo.init(cfg, gen, device=dev)
    cast_as_you_go(params, cfg.activation_dtype)
    return cfg, params, prompts


def runtime_exec(dev, setup) -> list:
    """Four independent olmo-1b prefills at full width as one graph of
    136 ops (``serving.prefill_payload_graph``: each chain the ops of
    ``wave_op_graph`` for its one request), planned on the sim by
    ``ConcurrencyRuntime`` with EWMA feedback and run on the card by
    ``RealGraphExecutor`` at 1 and 4 workers, one stream each.  Each
    request's bf16 logits must equal the witness's (the same payloads in
    topological order on the caller's stream) bit for bit, or else be
    held to the bf16 rule and the unequal elements counted; every op
    observed once in the plan store, flash launched 64 times, on two
    streams or more at 4 workers; and one fp32 run at 4 workers within
    1e-3 of the largest |logit| of ``transformer.prefill``.  Each line
    reads ``memory_allocated`` before its executor is built and after its
    results are dropped; the second may not be higher."""
    import torch

    from repro_torch.core import (ConcurrencyRuntime, RealGraphExecutor,
                                  RuntimeConfig, StrategyConfig)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import transformer, zoo
    from repro_torch.serving import prefill_payload_graph

    cfg, params, prompts = setup
    graph = prefill_payload_graph(cfg, params, prompts)
    n_flash = len(prompts) * cfg.n_layers
    assert graph.n_ops == len(prompts) * (2 * cfg.n_layers + 2) == 136
    sinks = [u for u in graph.topo_order() if not graph.consumers(u)]

    def planned():
        rt = ConcurrencyRuntime(config=RuntimeConfig(
            strategy=StrategyConfig(feedback="ewma")))
        rt.profile(graph)
        return rt

    lines = []
    with torch.no_grad():
        # warm-up (the first GEMMs on the worker streams), then the
        # witness on the caller's stream, timed to a sync
        RealGraphExecutor(max_workers=max(RUNTIME_WORKERS)).run(graph)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        witness = run_inline(graph)
        torch.cuda.synchronize()
        witness_s = time.perf_counter() - t0
        for w in RUNTIME_WORKERS:
            rt = planned()
            sim_ms = {}
            for op in graph.ops.values():
                p = rt.plan.per_instance[op.size_key]
                sim_ms[op.op_class] = sim_ms.get(op.op_class, 0.0) + \
                    rt.planstore.predict(op, p.threads, p.variant) * 1e3
            flash_attention.launches = 0
            torch.cuda.synchronize()
            mem_before = torch.cuda.memory_allocated()
            ex = RealGraphExecutor(max_workers=w, device="cuda")
            results, timings, wall = ex.run(graph, store=rt.planstore,
                                            plan=rt.plan)
            launches = flash_attention.launches
            observed_ms = {}
            for u, op in graph.ops.items():
                observed_ms[op.op_class] = observed_ms.get(
                    op.op_class, 0.0) + timings[u] * 1e3
            unequal, errs = [], []
            for u in sinks:
                out, ref = results[u].float(), witness[u].float()
                unequal.append(int((out != ref).sum()))
                errs.append(float((out - ref).abs().max()))
            largest = max(float(witness[u].float().abs().max())
                          for u in sinks)
            del results, out, ref
            streams = flash_streams(graph, w)
            torch.cuda.synchronize()
            line = {"phase": "runtime_exec", "workers": w,
                    "dtype": "bfloat16", "ops": graph.n_ops,
                    "wall_s": wall, "witness_wall_s": witness_s,
                    "device_ms_sum": sum(timings.values()) * 1e3,
                    "max_ops_overlapping": max_overlap(ex.spans),
                    "flash_launches": launches,
                    "flash_streams": streams,
                    "observed": rt.planstore.corrections.observed,
                    "device_ms_by_class": observed_ms,
                    "sim_predicted_ms_by_class": sim_ms,
                    "sim_clock": "SimMachine knl_7250 (simulated)",
                    "logits_equal_witness": [n == 0 for n in unequal],
                    "unequal_elements": unequal,
                    "max_abs_err_vs_witness": max(errs),
                    "tol": LOGIT_RTOL["bfloat16"] * largest,
                    "mem_allocated_before": mem_before,
                    "mem_allocated_after": torch.cuda.memory_allocated()}
            emit(line)
            lines.append(line)
            assert launches == n_flash, line
            assert line["mem_allocated_after"] <= mem_before, line
            assert line["observed"] == graph.n_ops, line
            assert max(errs) <= line["tol"], line
            if w > 1:
                assert line["flash_streams"] >= 2, line
    del graph, witness
    torch.cuda.empty_cache()

    # fp32: the executor's logits against transformer.prefill
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = zoo.init(cfg32, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    graph32 = prefill_payload_graph(cfg32, params32, prompts)
    w = max(RUNTIME_WORKERS)
    with torch.no_grad():
        # the references first: their GEMMs on the caller's stream take
        # its cuBLAS workspace before the executor's run is read
        refs = [transformer.prefill(cfg32, params32, torch.as_tensor(
            p, dtype=torch.int64, device=dev)[None], len(p))[0]
            for p in prompts]
        flash_attention.launches = 0
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        results, timings, wall = RealGraphExecutor(max_workers=w).run(
            graph32)
        launches = flash_attention.launches
        errs = [float((results[u] - ref).abs().max())
                for u, ref in zip(sinks, refs)]
        largest = max(float(ref.abs().max()) for ref in refs)
        del results
        torch.cuda.synchronize()
    line = {"phase": "runtime_exec", "workers": w, "dtype": "float32",
            "wall_s": wall, "device_ms_sum": sum(timings.values()) * 1e3,
            "flash_launches": launches, "max_abs_err_vs_prefill": max(errs),
            "tol": LOGIT_RTOL["float32"] * largest,
            "mem_allocated_before": mem_before,
            "mem_allocated_after": torch.cuda.memory_allocated()}
    emit(line)
    lines.append(line)
    assert launches == n_flash and max(errs) <= line["tol"], line
    assert line["mem_allocated_after"] <= mem_before, line
    del params32, graph32, refs
    torch.cuda.empty_cache()
    return lines


def service_exec(dev, setup) -> dict:
    """The olmo-1b prefills of ``runtime_exec`` served by the pool daemon:
    one job a request (its 34 ops from ``prefill_payload_graph``, attached
    to a ``JobSpec``), a simulated resnet50 training job beside them, and
    a fifth prefill cancelled before any step.  The daemon's persistent
    executor runs the payloads on the card at 4 workers as the sim
    launches them; with payload feedback each finished payload's device
    time reaches its job's plan store.  See the module docstring for what
    fails the phase."""
    import tempfile

    import torch

    from repro_torch.core import OpGraph, StrategyConfig
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.multitenant import PoolConfig
    from repro_torch.obs import FAM_SERVICE, RecordingSink
    from repro_torch.serving import prefill_payload_graph
    from repro_torch.service import (ATTACHED_GRAPH, JobSpec, PoolDaemon,
                                     load_store)
    from repro_torch.service import daemon as daemon_mod

    cfg, params, prompts = setup
    graphs = [prefill_payload_graph(cfg, params, [p]) for p in prompts]
    per_job = 2 * cfg.n_layers + 2
    assert all(g.n_ops == per_job == 34 for g in graphs)
    sink_of = [next(u for u in g.topo_order() if not g.consumers(u))
               for g in graphs]
    # the fifth request, to be cancelled: its payloads count their runs
    ran = []

    def counted(op):
        def run(deps):
            ran.append(op.op_class)
            return op.payload(deps)
        return dataclasses.replace(op, payload=run)

    extra = prefill_payload_graph(cfg, params, [prompts[0][:100]])
    extra = OpGraph(extra.name, {u: counted(op)
                                 for u, op in extra.ops.items()})
    observed = []
    real_report = daemon_mod.report_payload_observation

    def report(store, plan, op, dt):
        observed.append((id(store), op.uid))
        real_report(store, plan, op, dt)

    with torch.no_grad():
        witness = []
        for g, u in zip(graphs, sink_of):
            witness.append(run_inline(g)[u])
        torch.cuda.synchronize()
        flash_attention.launches = 0
        mem_before = torch.cuda.memory_allocated()
        sink = RecordingSink()
        daemon_mod.report_payload_observation = report
        try:
            with tempfile.TemporaryDirectory() as td:
                t0 = time.perf_counter()
                daemon = PoolDaemon(
                    td, config=PoolConfig(max_active=3,
                                          strategy=StrategyConfig(
                                              feedback="ewma", sink=sink)),
                    execute_payloads=True, max_workers=4,
                    payload_feedback=True, device="cuda")
                ids = [daemon.submit(JobSpec(
                    workload=ATTACHED_GRAPH,
                    name=f"olmo-1b-prefill-{len(p)}"), graph=g)
                    for p, g in zip(prompts, graphs)]
                daemon.submit(JobSpec(workload="resnet50",
                                      name="resnet50-train"))
                cancelled = daemon.submit(
                    JobSpec(workload=ATTACHED_GRAPH,
                            name="olmo-1b-prefill-cancelled"), graph=extra)
                assert daemon.cancel(cancelled)
                result = daemon.drain()
                jobs = {j.name: j for j in daemon.pool.jobs}
                futures = daemon.observer.futures
                outs, device_s = [], 0.0
                for g, u, p in zip(graphs, sink_of, prompts):
                    futs = futures[jobs[f"olmo-1b-prefill-{len(p)}"].jid]
                    assert sorted(futs) == sorted(g.ops), sorted(futs)
                    for f in futs.values():
                        device_s += f.result()[1]
                    outs.append(futs[u].result()[0])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = flash_attention.launches
                daemon.close()
                store = load_store(Path(td) / "store.json")
                status = daemon.status()
        finally:
            daemon_mod.report_payload_observation = real_report
        unequal, errs = [], []
        for out, ref in zip(outs, witness):
            unequal.append(int((out.float() != ref.float()).sum()))
            errs.append(float((out.float() - ref.float()).abs().max()))
        largest = max(float(ref.float().abs().max()) for ref in witness)
        stores = {id(jobs[f"olmo-1b-prefill-{len(p)}"].store)
                  for p in prompts}
        kept = [k for k in observed if k[0] in stores]
        # the results dropped: the daemon's observer keeps every job's
        # payload futures (their results on the card) until told not to
        futures.clear()
        del outs, out, futs, f, daemon, jobs
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
    states = sorted((e.spec.name, e.state) for e in store.entries)
    line = {"phase": "service_exec", "jobs": ids + [cancelled],
            "wall_s": wall, "sim_makespan_s": result.makespan,
            "sim_clock": "SimMachine knl_7250 (simulated, not the card)",
            "device_ms_sum": device_s * 1e3, "flash_launches": launches,
            "cancelled_job_launches": ran.count("wave_prefill_attn"),
            "cancelled_job_payloads_run": len(ran),
            "observed": len(kept), "observed_distinct": len(set(kept)),
            "logits_equal_witness": [n == 0 for n in unequal],
            "unequal_elements": unequal,
            "max_abs_err_vs_witness": max(errs),
            "tol": LOGIT_RTOL["bfloat16"] * largest,
            "store_entries": states,
            "checkpoints": sum(1 for e in sink.events
                               if e.family == FAM_SERVICE
                               and e.kind == "checkpoint"),
            "mem_allocated_before": mem_before,
            "mem_allocated_after_close": mem_after}
    emit(line)
    assert launches == len(prompts) * cfg.n_layers == 64, line
    assert ran == [] and line["cancelled_job_launches"] == 0, line
    assert line["observed"] == line["observed_distinct"] == \
        len(prompts) * per_job, line
    assert max(errs) <= line["tol"], line
    assert len(states) == 6 and {s for _, s in states} == {
        "done", "cancelled"}, line
    assert dict(states)["olmo-1b-prefill-cancelled"] == "cancelled", line
    assert [j["state"] for j in status["jobs"]].count("done") == 5, line
    assert mem_after <= mem_before, line
    return line


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    if sys.argv[1:2] == ["--multidevice"]:
        emit(multidevice_child(sys.argv[2]))
        return 0
    if sys.argv[1:2] == ["--dryrun-mesh"]:
        emit(dryrun_mesh_child())
        return 0
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.hw import H100Spec
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention)
    from repro_torch.kernels.rglru import rglru, rglru_plain
    from repro_torch.kernels.rwkv6 import wkv6, wkv6_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. card ---------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "card", "device": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    evidence = {name: build_evidence(name) for name in _build.sources()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": built, "sources": sorted(_build.sources()),
          **evidence})
    for name, ev in evidence.items():
        assert ev["ok"], (name, ev)

    # 3. kernel checks ------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    fa_err = check_flash(gen, dev)
    rg_err = check_rglru(gen, dev)
    wk_err = check_wkv6(gen, dev)
    check_grads(gen, dev)

    # 4. kernel times -------------------------------------------------------
    fa = {"name": "flash_attention", "route": "cuda",
          "source": "src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention.cu",
          "replaces": "src/repro/kernels/flash_attention/kernel.py:96",
          **time_flash(gen, dev, FLASH_TIMED[0], fa_err)}
    fa_d256 = time_flash(gen, dev, FLASH_TIMED[1], fa_err)
    fa_mixtral = time_flash(gen, dev, FLASH_TIMED[2], fa_err)
    fa_whisper = time_flash(gen, dev, FLASH_TIMED[3], fa_err)
    rg = {"name": "rglru", "route": "cuda",
          "source": "src/repro_torch/kernels/rglru/csrc/rglru.cu",
          "replaces": "src/repro/kernels/rglru/kernel.py:56",
          **time_rglru(gen, dev, RGLRU_TIMED[0], rg_err)}
    rg_b1 = time_rglru(gen, dev, RGLRU_TIMED[1], rg_err)
    wk = {"name": "wkv6", "route": "cuda",
          "source": "src/repro_torch/kernels/rwkv6/csrc/wkv6.cu",
          "replaces": "src/repro/kernels/rwkv6/kernel.py:80",
          **time_wkv6(gen, dev, WKV6_TIMED[0], wk_err)}
    wk_b1 = time_wkv6(gen, dev, WKV6_TIMED[1], wk_err)
    for name, t in (("flash_attention", fa), ("flash_attention", fa_d256),
                    ("flash_attention", fa_mixtral),
                    ("flash_attention", fa_whisper), ("rglru", rg),
                    ("rglru", rg_b1), ("wkv6", wk), ("wkv6", wk_b1)):
        emit({"phase": "kernel_time", "kernel": name, **{k_: t[k_] for k_ in (
            "ms", "cold_ms", "launch_host_us", "fp32_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "geometry", "geometry_ms",
            "at")
            if k_ in t}})

    # 5. slice: olmo-1b at full width ----------------------------------------
    rng = np.random.default_rng(0)
    cfg = get_config("olmo-1b")
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(64, 513, size=8)]
    assert any(len(p) % 64 for p in prompts), "no ragged prompt length"
    olmo = serve_slice(cfg, dev, prompts, max_len=1024,
                       counters={flash_attention: cfg.n_layers},
                       compare_wave=0,
                       plain_kw={"self_attn": attention_plain})

    # 5b. runtime: the paper's runtime on the sim, then its executor running
    # olmo-1b prefills on CUDA streams
    runtime_sim()
    olmo_setup = olmo_runtime_setup(dev)
    rt_lines = runtime_exec(dev, olmo_setup)
    service = service_exec(dev, olmo_setup)
    # the daemon's pool and its payload observer refer to each other, so
    # its jobs' graphs, and through their payloads the params, go only
    # with the cyclic collector
    del olmo_setup
    gc.collect()
    torch.cuda.empty_cache()

    # 6. slice: recurrentgemma-2b at full width ------------------------------
    cfg = get_config("recurrentgemma-2b")
    lens = [*rng.integers(64, 513, size=4), *rng.integers(1500, 2601, size=4)]
    if max(lens[4:]) <= cfg.window:           # one prompt past the window
        lens[4] = 2600
    if not any(n % 64 for n in lens[4:]):      # one ragged long prompt
        lens[5] += 1
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in lens]
    # per prefill: 18 recurrent blocks, 8 local-attention blocks
    rgemma = serve_slice(
        cfg, dev, prompts, max_len=4096,
        counters={rglru: 18, flash_attention: 8}, compare_wave=1,
        plain_kw={"self_attn": attention_plain, "rglru_fn": rglru_plain})
    assert rgemma["compared_prompt_len"] > cfg.window == \
        rgemma["compared_cache_len"]

    # 7. slice: rwkv6-1.6b at full width -------------------------------------
    cfg = get_config("rwkv6-1.6b")
    lens = [*rng.integers(64, 513, size=4), *rng.integers(1500, 4001, size=3),
            4093]                    # prime: the longest of its wave
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in lens]
    # per prefill: one WKV6 launch in each of the 24 time-mix blocks
    rwkv = serve_slice(
        cfg, dev, prompts, max_len=8192, counters={wkv6: cfg.n_layers},
        compare_wave=1, plain_kw={"wkv_fn": wkv6_plain}, state="tm_state",
        draw_leaves=draw_rwkv6_leaves, per_call=HeldPerCall())
    assert rwkv["compared_prompt_len"] == 4093

    # 8. slice: granite-3-8b at full width and depth (GQA 32/8) -------------
    cfg = get_config("granite-3-8b")
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(64, 1025, size=8)]
    assert any(len(p) % 64 for p in prompts), "no ragged prompt length"
    # after 40 bf16 layers the kernel path and the plain path are each about
    # as far from fp32 as the other (the line's plain_bf16_logits_err_vs_fp32
    # and kernel_bf16_logits_err_vs_fp32), so two such roundings, if
    # independent, end about sqrt(2) times that far apart: the bf16 logits
    # are held within sqrt(2) times the plain path's own error (a bound the
    # kernel's own error does not raise); each flash call of the compared
    # prefills is also held against attention_plain on its own inputs
    granite = serve_slice(cfg, dev, prompts, max_len=2048,
                          counters={flash_attention: cfg.n_layers},
                          compare_wave=0,
                          plain_kw={"self_attn": attention_plain},
                          per_call=HeldFlashPerCall(),
                          bf16_own_factor=math.sqrt(2.0))

    # 9. slice: mixtral-8x7b at full width, 8 of 32 layers (MoE top-2, SWA)
    cfg = dataclasses.replace(get_config("mixtral-8x7b"),
                              n_layers=MOE_SERVE_LAYERS)
    lens = [*rng.integers(64, 1025, size=4), *rng.integers(1500, 4093, size=3),
            4093]               # decode wraps the 4096 window after 3 tokens
    if not any(n % 64 for n in lens[4:]):       # one ragged long prompt
        lens[4] += 1
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in lens]
    assert max(lens) <= cfg.window       # one MoE group a row (S <= 4096)
    mixtral = serve_slice(cfg, dev, prompts, max_len=8192,
                          counters={flash_attention: cfg.n_layers},
                          compare_wave=1,
                          plain_kw={"self_attn": attention_plain},
                          route_log=RouteLog())
    assert mixtral["compared_prompt_len"] == 4093
    assert mixtral["compared_cache_len"] == cfg.window

    # 10. slice: llama-3.2-vision-11b at full width and depth (vlm: 32 self
    # layers through flash, 8 gated cross layers over a 1600-token frontend)
    cfg = get_config("llama-3.2-vision-11b")
    frontend = frontend_for(cfg, dev)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(64, 1025, size=8)]
    # a prompt as long as the frontend would send its cross-attention to
    # flash too (Sq == Sk), and the launch count below would not hold
    assert all(len(p) != cfg.n_frontend_tokens for p in prompts)
    n_self = cfg.n_layers - cfg.n_layers // cfg.cross_attn_every
    # 40 bf16 layers, as granite-3-8b: the logits within sqrt(2) times the
    # plain path's own bf16 error, and each flash call held on its inputs
    vision = serve_slice(cfg, dev, prompts, max_len=2048,
                         counters={flash_attention: n_self}, compare_wave=0,
                         plain_kw={"self_attn": attention_plain},
                         draw_leaves=draw_vlm_gates,
                         per_call=HeldFlashPerCall(),
                         bf16_own_factor=math.sqrt(2.0), frontend=frontend)
    assert vision["params"] == cfg.param_count() and n_self == 32

    # 11. slice: whisper-small at full width and depth (12 non-causal
    # encoder and 12 causal decoder self-attentions through flash; decode
    # reads the cross k/v from the cache)
    cfg = get_config("whisper-small")
    frontend = frontend_for(cfg, dev)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(16, 433, size=8)]
    whisper = serve_slice(cfg, dev, prompts, max_len=448,
                          counters={flash_attention: cfg.encoder_layers
                                    + cfg.n_layers}, compare_wave=0,
                          plain_kw={"self_attn": attention_plain},
                          per_call=HeldFlashPerCall(), frontend=frontend)
    assert whisper["params"] == cfg.param_count()

    # 12. train: olmo-1b at full width; its gradients against the plain
    # path; mixtral-8x7b at full width cut in depth
    train = train_olmo(dev)
    train_grad_check(dev)
    moe_train = train_moe(dev)
    # after train_moe: the child's mixtral-8x7b steps need the card's
    # memory that this process no longer holds
    multi = multidevice(train)

    # 15. dry-run: the (arch x shape) matrix on meta against the card's
    # spec, then the counts of the shapes this call ran beside the card's
    spec = H100Spec.from_device(0)
    dryrun_matrix(spec)
    dryrun_vs_card(dev, spec, train, moe_train)
    # 17. the dry-run on the reference's meshes, in a child of its own
    dryrun_mesh()

    # 13. kernels line, card line, result -------------------------------------
    by_path = {"olmo-1b": olmo["launches"]["flash_attention"],
               "recurrentgemma-2b": rgemma["launches"]["flash_attention"],
               "granite-3-8b": granite["launches"]["flash_attention"],
               "mixtral-8x7b": mixtral["launches"]["flash_attention"],
               "llama-3.2-vision-11b": vision["launches"]["flash_attention"],
               "whisper-small": whisper["launches"]["flash_attention"],
               "olmo-1b runtime": sum(line["flash_launches"]
                                      for line in rt_lines),
               "olmo-1b service": service["flash_launches"],
               "olmo-1b train": train["flash_launches"],
               "mixtral-8x7b train": moe_train["flash_launches"],
               "olmo-1b multidevice": multi["launches"]["flash_attention"],
               **{f"{arch} multidevice sharded": n["flash_attention"]
                  for arch, n in multi["launches_by_family"].items()}}
    fa["launches"] = sum(by_path.values())
    rg_by_path = {"recurrentgemma-2b": rgemma["launches"]["rglru"],
                  "olmo-1b multidevice": multi["launches"]["rglru"],
                  **{f"{arch} multidevice sharded": n["rglru"]
                     for arch, n in multi["launches_by_family"].items()}}
    wk_by_path = {"rwkv6-1.6b": rwkv["launches"]["wkv6"],
                  "olmo-1b multidevice": multi["launches"]["wkv6"],
                  **{f"{arch} multidevice sharded": n["wkv6"]
                     for arch, n in multi["launches_by_family"].items()}}
    rg["launches"] = sum(rg_by_path.values())
    wk["launches"] = sum(wk_by_path.values())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "tol", "max_err_ratio", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "at")
    flash_keys = (*keys, "cold_ms")
    emit({"kernels": [
        {**{k_: fa[k_] for k_ in flash_keys}, "launches_by_path": by_path,
         "at_d256": {k_: fa_d256[k_] for k_ in flash_keys if k_ in fa_d256},
         "at_mixtral": {k_: fa_mixtral[k_] for k_ in flash_keys
                        if k_ in fa_mixtral},
         "at_whisper_encoder": {k_: fa_whisper[k_] for k_ in flash_keys
                                if k_ in fa_whisper}},
        {**{k_: rg[k_] for k_ in keys}, "launches_by_path": rg_by_path,
         "at_b1": {k_: rg_b1[k_] for k_ in keys if k_ in rg_b1}},
        {**{k_: wk[k_] for k_ in keys}, "launches_by_path": wk_by_path,
         "at_b1": {k_: wk_b1[k_] for k_ in keys if k_ in wk_b1}}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
