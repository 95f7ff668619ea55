#!/usr/bin/env python3
"""Does ``torch.sqrt`` on the CPU give the same float32 values every time?

    python3 cpu_sqrt_repro.py [--processes 24] [--rounds 300]

Imports torch and nothing of this repository.  Each of ``--processes``
fresh processes draws a (2, 64, 256) float32 ``c = clamp(1 - a², 1e-12)``
with a ~ U(0.001, 0.9995) (the RG-LRU's stages before its scan, at the
shape of ``tests/test_torch_cuda.py``'s gradient case) and, ``--rounds``
times, runs CPU work of the kind that test file runs before it (an fp32
attention forward and backward through ``einsum`` on (2, 96, 16, 128), and
with a card present, card work queued behind a sleep), then takes
``torch.sqrt(c)`` and holds it against the correctly rounded square root
(computed in float64 and rounded to float32): PyTorch's float32 sqrt is
within 1 ulp of it (a relative 1.2e-7), so a call is wrong where it is
further than 1e-6.
PyTorch's CPU sqrt splits 32,768 elements among its intra-op threads in
blocks of 2,048 (one thread takes 4,096 of them on 8 threads), so the
line names each wrong call's wrong 4,096-element blocks and their largest
relative error.  Prints one JSON line a process and a summary; exits 1 if
any call was wrong.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def child(rounds: int, seed: int) -> dict:
    import torch

    gen = torch.Generator().manual_seed(seed)
    a = 0.001 + 0.9985 * torch.rand((2, 64, 256), generator=gen)
    c = torch.clamp(1.0 - a * a, min=1e-12)
    exact = torch.sqrt(c.double()).float()
    q, k, v = (torch.randn((2, 96, 16, 128), generator=gen)
               for _ in range(3))
    card = torch.cuda.is_available()
    if card:
        big = torch.randn((4096, 4096), device="cuda")
    wrong = []
    for i in range(rounds):
        qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
        s = torch.einsum("bqhd,bkhd->bhqk", qs, ks) / 128 ** 0.5
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vs)
        torch.autograd.grad(o.sum(), (qs, ks, vs))
        if card:
            torch.cuda._sleep(2_000_000)
            big @ big
        rel = ((torch.sqrt(c) - exact).abs() / exact).reshape(8, 4096)
        bad = (rel > 1e-6).any(dim=1)
        if bad.any():
            wrong.append({"round": i, "blocks": bad.nonzero()[:, 0].tolist(),
                          "max_rel_err": float(rel.max())})
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
