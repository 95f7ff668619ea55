"""Training launcher of the port:
``python -m repro_torch.launch.train --arch olmo-1b [--device cuda|cpu] ...``

Runs real steps on one device (``cuda`` unless asked for the CPU; it
raises without CUDA rather than fall back).  Wires the data pipeline and
prefetch, the train step, async checkpointing, heartbeat, straggler
monitor and the recovery loop, as ``repro.launch.train`` does on one
device (no mesh).  Each step's time is taken on the host clock after a
device sync, so it covers the step's device work, not only its launch.
Prints the reference's final JSON line (steps, mean_step_ms, failures,
restores).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import DataConfig, Prefetcher, make_source
from repro_torch.models import zoo
from repro_torch.optim import AdamWConfig
from repro_torch.train import (CheckpointManager, Heartbeat, StragglerMonitor,
                               TrainConfig, init_state, make_train_step,
                               run_with_recovery)


def build(args):
    cfg = get_config(args.arch, smoke=args.smoke)
    tcfg = TrainConfig(
        microbatches=args.microbatches,
        remat=not args.no_remat,
        optimizer=AdamWConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(args.steps // 20, 1)))
    return cfg, tcfg


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg, tcfg = build(args)
    print(f"arch={cfg.arch_id} params={cfg.param_count():,} "
          f"active={cfg.active_param_count():,} device={device}")

    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab=cfg.vocab, seed=args.seed,
                      frontend_tokens=cfg.n_frontend_tokens
                      if zoo.needs_frontend(cfg) else 0,
                      d_model=cfg.d_model)
    source = make_source(dcfg)
    prefetch = Prefetcher(source)

    manager = CheckpointManager(args.ckpt_dir, device=device)
    heartbeat = Heartbeat(os.path.join(args.ckpt_dir, "heartbeat.json"))
    monitor = StragglerMonitor()

    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_state(cfg, tcfg, gen, device=device)
    step_fn = make_train_step(cfg, tcfg)

    if args.resume:
        restored = manager.restore()
        if restored:
            state, extra, start = restored
            print(f"resumed from step {start}")

    times: list[float] = []

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def wrapped(state, batch, step):
        sync()
        t0 = time.perf_counter()
        tb = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        state, metrics = step_fn(state, tb)
        sync()
        dt = time.perf_counter() - t0
        times.append(dt)
        heartbeat.beat(step)
        monitor.observe({"host0": dt})
        return state, metrics

    def on_metrics(step, metrics):
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"dt {times[-1]*1e3:.0f}ms")

    try:
        state, stats = run_with_recovery(
            wrapped, state, n_steps=args.steps,
            save_every=args.save_every, manager=manager,
            data_prefetch=prefetch, on_metrics=on_metrics)
        manager.save(args.steps, state, extra={"final": True}, block=True)
    finally:
        prefetch.close()
    result = {
        "steps": args.steps,
        "mean_step_ms": 1e3 * sum(times) / max(len(times), 1),
        "failures": stats.failures, "restores": stats.restores,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
