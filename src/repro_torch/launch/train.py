"""Training launcher of the port:
``python -m repro_torch.launch.train --arch olmo-1b [--device cuda|cpu] ...``

Runs real steps on one device (``cuda`` unless asked for the CPU; it
raises without CUDA rather than fall back).  Wires the data pipeline and
prefetch, the train step, async checkpointing, heartbeat, straggler
monitor and the recovery loop, as ``repro.launch.train`` does.  Each
step's time is taken on the host clock after a device sync, so it covers
the step's device work, not only its launch.  Prints the reference's
final JSON line (steps, mean_step_ms, failures, restores).

Under ``torchrun`` with more than one rank (``WORLD_SIZE`` > 1) it brings
the process group up (NCCL for ``--device cuda``, a card a rank by
``LOCAL_RANK``; gloo for ``cpu``) and picks the mesh and plan by the
reference's rule: (2, n/2) ``("data", "model")`` with ``default_plan`` at
4 ranks or more, else a data-only (n, 1) mesh with ``replicated_plan``
and the batch sharded over ``data``.  The state is placed on the mesh by
``state_specs``; every rank draws the same state and keeps its slice.
Every family trains so (dense, moe, hybrid, ssm, vlm and audio; the vlm
and audio batches carry their frontend).  Rank 0 prints and writes the
checkpoints:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu --smoke --arch whisper-small
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import DataConfig, Prefetcher, make_source
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import zoo
from repro_torch.models.common import default_plan, replicated_plan
from repro_torch.optim import AdamWConfig
from repro_torch.sharding import distribute_tree, named_sharding_tree
from repro_torch.train import (CheckpointManager, Heartbeat, StragglerMonitor,
                               TrainConfig, init_state, make_train_step,
                               run_with_recovery, state_specs)


def build(args):
    cfg = get_config(args.arch, smoke=args.smoke)
    tcfg = TrainConfig(
        microbatches=args.microbatches,
        remat=not args.no_remat,
        optimizer=AdamWConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(args.steps // 20, 1)))
    return cfg, tcfg


def mesh_and_plan(n_ranks: int, device_type: str):
    """The reference's rule: a (2, n/2) ("data", "model") mesh with
    ``default_plan`` at 4 ranks or more, else (n, 1) with
    ``replicated_plan`` and the batch over "data"."""
    if n_ranks >= 4:
        return (make_mesh((2, n_ranks // 2), ("data", "model"),
                          device_type=device_type), default_plan())
    plan = replicated_plan()
    plan.batch_axes = ("data",)
    return (make_mesh((n_ranks, 1), ("data", "model"),
                      device_type=device_type), plan)


def init_ranks(device: torch.device) -> tuple[int, torch.device]:
    """Under ``torchrun`` with ``WORLD_SIZE`` > 1: the process group up
    (NCCL on the rank's card, gloo on the CPU).  Returns (rank, device)."""
    import torch.distributed as dist
    rank = int(os.environ["RANK"])
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", device_id=device)
    else:
        dist.init_process_group("gloo")
    return rank, device


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
    n_ranks = int(os.environ.get("WORLD_SIZE", "1"))
    rank, mesh, plan, shardings = 0, None, None, None
    if n_ranks > 1:
        rank, device = init_ranks(device)
        mesh, plan = mesh_and_plan(n_ranks, device.type)
        cfg = dataclasses.replace(cfg, batch_axes=tuple(plan.batch_axes))
        shardings = named_sharding_tree(plan, mesh, state_specs(cfg, tcfg))
    if rank == 0:
        print(f"arch={cfg.arch_id} params={cfg.param_count():,} "
              f"active={cfg.active_param_count():,} device={device}"
              + (f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}"
                 if mesh is not None else ""))

    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab=cfg.vocab, seed=args.seed,
                      frontend_tokens=cfg.n_frontend_tokens
                      if zoo.needs_frontend(cfg) else 0,
                      d_model=cfg.d_model)
    source = make_source(dcfg)
    prefetch = Prefetcher(source)

    manager = CheckpointManager(args.ckpt_dir, device=device,
                                shardings=shardings)
    heartbeat = Heartbeat(os.path.join(
        args.ckpt_dir, "heartbeat.json" if rank == 0
        else f"heartbeat_rank{rank}.json"))
    monitor = StragglerMonitor()

    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_state(cfg, tcfg, gen, device=device)
    if shardings is not None:
        state = distribute_tree(state, shardings)
    batch_axes = tuple(plan.batch_axes) if plan is not None else ()
    step_fn = make_train_step(cfg, tcfg, batch_axes=batch_axes or None)

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
        if rank == 0 and (step % 10 == 0 or step == args.steps - 1):
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
        if n_ranks > 1:
            import torch.distributed as dist
            dist.destroy_process_group()
    result = {
        "steps": args.steps,
        "mean_step_ms": 1e3 * sum(times) / max(len(times), 1),
        "failures": stats.failures, "restores": stats.restores,
    }
    if rank == 0:
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
