#!/usr/bin/env python3
"""Does ``torch.sqrt`` on the CPU give the same float32 values every time?

    python3 cpu_sqrt_repro.py [--processes 24] [--rounds 300]

Imports torch and nothing of this repository.  Each of ``--processes``
fresh processes draws a (2, 64, 256) float32 ``c = clamp(1 - a², 1e-12)``
with a ~ U(0.001, 0.9995) (the RG-LRU's stages before its scan, at the
shape of ``tests/test_torch_cuda.py``'s gradient case) and, ``--rounds``
times, runs the sequence that test file runs just before its RG-LRU
gradient case, its flash gradient case: the CPU attention of
``layers.attention`` at olmo-1b's heads ((2, 96, 16, 128), causal, a
window of 48, the dense fp32 math) forward and backward against seeded
cotangents, the same once more (the test's CPU repeat), and with a card
present the inputs copied to the card, the same attention's forward and
backward there behind a sleep, and its three gradients copied back
(``.cpu()``, as the test's ``_rel_gap``).  Then it takes the RG-LRU
stages as the test does (a², 1 - a², the clamp, ``torch.sqrt``) and holds
the root against the correctly rounded square root (computed in float64
and rounded to float32): PyTorch's float32 sqrt is within 1 ulp of it (a
relative 1.2e-7), so a call is wrong where it is further than 1e-6.
PyTorch's CPU sqrt splits 32,768 elements among its intra-op threads in
blocks of 2,048 (one thread takes 4,096 of them on 8 threads), so the
line names each wrong call's wrong 4,096-element blocks, each with its
largest relative error against the exact root.  Prints one JSON line a process and a summary; exits 1 if
any call was wrong.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def attention(q, k, v, window: int = 48):
    """``layers.attention``'s dense fp32 math (causal, a sliding window):
    scores, the mask, softmax and the weighted v."""
    import torch
    s = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - window)
    logits = torch.where(mask[None, None], logits, -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)


def attention_grads(ins, cot, device="cpu"):
    leaves = [t.detach().to(device).requires_grad_(True) for t in ins]
    out = attention(*leaves)
    return torch_grad(out, leaves, cot.to(device))


def torch_grad(out, leaves, cot):
    import torch
    return torch.autograd.grad(out, leaves, cot)


def child(rounds: int, seed: int) -> dict:
    import torch

    gen = torch.Generator().manual_seed(seed)
    a = 0.001 + 0.9985 * torch.rand((2, 64, 256), generator=gen)
    c = torch.clamp(1.0 - a * a, min=1e-12)
    exact = torch.sqrt(c.double()).float()
    ins = [torch.randn((2, 96, 16, 128), generator=gen) for _ in range(3)]
    cot = torch.randn((2, 96, 16, 128), generator=gen)
    card = torch.cuda.is_available()
    wrong = []
    for i in range(rounds):
        attention_grads(ins, cot)                 # the flash case's want
        attention_grads(ins, cot)                 # and its CPU repeat
        if card:
            torch.cuda._sleep(2_000_000)
            for g in attention_grads(ins, cot, "cuda"):
                g.cpu()                           # _rel_gap's copies
        clamped = torch.clamp(1.0 - a * a, min=1e-12)   # the stages
        root = torch.sqrt(clamped)
        rel = ((root - exact).abs() / exact).reshape(8, 4096)
        bad = (rel > 1e-6).any(dim=1)
        if bad.any() or not torch.equal(clamped, c):
            wrong.append({"round": i, "clamp_equal": torch.equal(clamped, c),
                          "blocks": {int(b): float(rel[b].max())
                                     for b in bad.nonzero()[:, 0]}})
    if card:
        torch.cuda.synchronize()
    return {"seed": seed, "rounds": rounds, "threads": torch.get_num_threads(),
            "card": card, "wrong_calls": len(wrong), "wrong": wrong[:5]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, default=24)
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--child", type=int, default=None)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(child(args.rounds, args.child)), flush=True)
        return 0
    results = []
    for seed in range(args.processes):
        out = subprocess.run(
            [sys.executable, __file__, "--child", str(seed),
             "--rounds", str(args.rounds)],
            capture_output=True, text=True, check=True, timeout=600)
        result = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(result), flush=True)
        results.append(result)
    summary = {"processes": len(results),
               "calls": sum(r["rounds"] for r in results),
               "wrong_calls": sum(r["wrong_calls"] for r in results),
               "processes_with_a_wrong_call": sum(
                   r["wrong_calls"] > 0 for r in results)}
    print(json.dumps(summary), flush=True)
    return 1 if summary["wrong_calls"] else 0


if __name__ == "__main__":
    sys.exit(main())
