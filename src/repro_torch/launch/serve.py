"""Serving launcher of the port:
``python -m repro_torch.launch.serve --arch olmo-1b [--device cuda|cpu] ...``

Random-initializes a model from ``--seed`` (or, with ``--ckpt-dir``,
restores the params of the latest training checkpoint, of either package)
and drives the batched serving engine over a synthetic request stream,
printing the same JSON keys as ``repro.launch.serve``.  With a bfloat16
activation dtype the weight matrices are cast once to bfloat16 (norm
scales stay float32), which gives the numbers of the reference's per-use
casts.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import zoo
from repro_torch.models.common import cast_matrices
from repro_torch.serving import Request, ServeEngine
from repro_torch.train import CheckpointManager


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore params from a training checkpoint")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.ckpt_dir:
        restored = CheckpointManager(args.ckpt_dir, device=device).restore()
        if restored is None:
            raise SystemExit(f"no checkpoint in {args.ckpt_dir}")
        params = restored[0]["params"]
        print(f"restored params from step {restored[2]}")
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = zoo.init(cfg, gen, device=device)
    params = cast_matrices(params, cfg.activation_dtype)

    engine = ServeEngine(cfg, params, n_slots=args.slots,
                         max_len=args.max_len)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        plen = int(rng.integers(args.prompt_len // 2, args.prompt_len + 1))
        engine.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab, size=plen).astype(np.int32),
            max_new_tokens=args.max_new))

    t0 = time.perf_counter()
    done = engine.run()
    wall = time.perf_counter() - t0
    total_tokens = sum(len(r.output) for r in done)
    result = {
        "arch": cfg.arch_id,
        "requests": len(done),
        "generated_tokens": total_tokens,
        "tokens_per_s": total_tokens / wall,
        "mean_slot_utilization": engine.mean_slot_utilization,
        "waves": len(engine.stats),
    }
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
