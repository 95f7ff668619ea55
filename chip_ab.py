#!/usr/bin/env python3
"""The recurrence kernels of two checkouts timed in turns on one card.

    python3 chip_ab.py OTHER_CHECKOUT     # from the root of this checkout

Runs four processes in the order other, this, this, other.  Each imports
``repro_torch`` from its checkout's ``src`` (building that checkout's
kernels) and times RG-LRU and WKV6 through their public wrappers, in bf16,
at ``chip_smoke.py``'s timed shapes (the B=4 wave prefill and the B=1
re-prefill), with ``chip_smoke.cuda_ms`` (CUDA events around launches
queued behind a hold on the card).  Prints one JSON line per process and,
last, the card's ``nvidia-smi`` name and power limit.  Two versions are
compared only within one such call: calls land on different cards and
hosts.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

CHILD = r"""
import json, sys
import torch
import chip_smoke as cs
from repro_torch.kernels.rglru import rglru
from repro_torch.kernels.rwkv6 import wkv6
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
out = {"checkout": sys.argv[1]}
for name in cs.RGLRU_TIMED:
    _, b, s, r, a_const = next(x for x in cs.RGLRU_SHAPES if x[0] == name)
    a, x = cs.rglru_inputs(gen, dev, b, s, r, a_const, torch.bfloat16)
    out[f"rglru {name} B={b} S={s}"] = cs.cuda_ms(lambda: rglru(a, x))
for name in cs.WKV6_TIMED:
    _, b, h, s, d, decays, floor = next(x for x in cs.WKV6_SHAPES
                                        if x[0] == name)
    args = cs.wkv6_inputs(gen, dev, b, h, s, d, decays, torch.bfloat16)
    out[f"wkv6 {name} B={b} S={s}"] = cs.cuda_ms(
        lambda: wkv6(*args, floor=floor))
print(json.dumps(out), flush=True)
"""


def run(checkout: Path) -> dict:
    env = dict(os.environ)
    # this checkout's chip_smoke.py (shapes, inputs, timing); the other's
    # kernels and wrappers
    env["PYTHONPATH"] = f"{HERE}{os.pathsep}{checkout / 'src'}"
    proc = subprocess.run([sys.executable, "-c", CHILD, str(checkout)],
                          env=env, cwd=HERE, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: exit {proc.returncode}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    if not (other / "src" / "repro_torch").is_dir():
        print(f"chip_ab: no src/repro_torch under {other}", file=sys.stderr)
        return 2
    for checkout in (other, HERE, HERE, other):
        print(json.dumps(run(checkout)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
