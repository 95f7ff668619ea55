"""The first AdamW steps of a model at full width (olmo-1b unless
``--arch`` names another): does the loss rise at step 2, and does the port
do what the reference does?

All runs use the train phase's optimizer of ``chip_smoke.py`` (AdamW, lr
``--lr``, one warm-up step, cosine over ``--steps``), ``--microbatches``
microbatches with per-layer remat, fp32 params, activations in
``--dtype``, depth cut to ``--layers``, and one fixed batch of
``SyntheticLM`` (seed 0).  Each package prints one JSON line: the loss
before each step, the grad norm, the lr, and, for the first step, the
first-order change of the loss it predicts, sum(g * (new - old)) (for
Adam's first step about -lr * ||g||_1), beside the change the second
step's loss shows.  For an MoE model also the aux loss (1 for balanced
routing, E for every token on one expert) before each step and after the
last, so that a collapse of the routing shows in both packages or in one.
``--d-ff`` cuts the feed-forward (each expert's) width; every other width
stays as published.

On the CPU (the default) both packages run, each in a process of its own
so only one state lives at a time (about 10 GB at 2 layers), from the
reference's ``zoo.init`` weights (seed 0) bridged into the port:

    PYTHONPATH=src python witness_first_steps.py [--layers 2] [--seq 256]

mixtral-8x7b as ``chip_smoke.py``'s train_moe phase trains it (1 layer,
one microbatch, 3 steps, bf16 activations), its experts cut to an eighth
of their width so that a package's train state fits in about 20 GB:

    PYTHONPATH=src python witness_first_steps.py --arch mixtral-8x7b \
        --layers 1 --d-ff 1792 --batch 2 --seq 256 --microbatches 1 \
        --steps 3 --dtype bfloat16

With ``--card``, only the port runs, on the CUDA card, from its own
``zoo.init`` (seed 0); this mode imports no JAX.  ``--sweep`` runs it at
every (layers, dtype, seq) of ``CARD_SWEEP``, chip_smoke's train phase
(16 layers, bfloat16, S=2048) first:

    PYTHONPATH=src python witness_first_steps.py --card --sweep
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys

import numpy as np


def _cfg(get_config, args):
    """The config of ``args.arch`` cut to ``args.layers`` (and
    ``args.d_ff``), activations in ``args.dtype``."""
    cfg = get_config(args.arch)
    return dataclasses.replace(cfg, n_layers=args.layers, dtype=args.dtype,
                               d_ff=args.d_ff or cfg.d_ff)


def _params_np(args):
    import jax

    from repro.configs import get_config
    from repro.models import zoo

    cfg = _cfg(get_config, args)
    params = jax.tree.map(np.asarray, zoo.init(cfg, jax.random.PRNGKey(0)))
    return cfg, params


def _batch(cfg, args):
    from repro.data import DataConfig, make_source

    return make_source(DataConfig(seq_len=args.seq, global_batch=args.batch,
                                  vocab=cfg.vocab)).batch_at(0)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# (layers, activation dtype, seq) of --card --sweep
CARD_SWEEP = ((16, "bfloat16", 2048), (16, "float32", 2048),
              (2, "bfloat16", 2048), (2, "float32", 2048),
              (2, "float32", 256), (16, "bfloat16", 256))


def _first_order(old, new, grads_mu, b1):
    """sum(g * (new - old)) with g = mu / (1 - b1) after the first step
    (mu = (1 - b1) g then)."""
    return sum(float(np.sum(np.asarray(m, np.float64) / (1 - b1)
                             * (np.asarray(n, np.float64)
                                - np.asarray(o, np.float64))))
                for o, n, m in zip(_leaves(old), _leaves(new),
                                   _leaves(grads_mu)))


def run_reference(args) -> list[dict]:
    import jax

    from repro.optim import AdamWConfig, init_opt_state
    from repro.train import TrainConfig, make_train_step

    from repro.models import zoo

    cfg, params = _params_np(args)
    tcfg = TrainConfig(microbatches=args.microbatches, remat=True,
                       optimizer=AdamWConfig(lr=args.lr, warmup_steps=1,
                                             total_steps=args.steps))
    state = {"params": jax.tree.map(jax.numpy.asarray, params),
             "opt": init_opt_state(tcfg.optimizer, params)}
    batch = jax.tree.map(jax.numpy.asarray, _batch(cfg, args))
    step = jax.jit(make_train_step(cfg, tcfg))
    aux = jax.jit(lambda p, b: zoo.loss_fn(cfg, p, b)[1]["aux"])
    rows = []
    for i in range(args.steps):
        new, m = step(state, batch)
        row = {k: float(v) for k, v in m.items()}
        if cfg.family == "moe":
            row["aux"] = float(aux(state["params"], batch))
            if i == args.steps - 1:
                row["aux_after"] = float(aux(new["params"], batch))
        if i == 0:
            row["first_order_change"] = _first_order(
                state["params"], new["params"], new["opt"]["mu"],
                tcfg.optimizer.b1)
        rows.append(row)
        state = new
    return rows


def run_port(args, dev) -> list[dict]:
    """The port on ``dev``; from its own init (seed 0) with ``--card``,
    else from the reference's weights."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import zoo
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step

    cfg = _cfg(get_config, args)
    if args.card:
        tparams = zoo.init(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    else:
        from repro_torch.bridge import params_from_jax
        tparams = params_from_jax(_params_np(args)[1])
    source = SyntheticLM(DataConfig(seq_len=args.seq,
                                    global_batch=args.batch,
                                    vocab=cfg.vocab))
    batch = {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
             for k, v in source.batch_at(0).items()}
    tcfg = TrainConfig(microbatches=args.microbatches, remat=True,
                       optimizer=AdamWConfig(lr=args.lr, warmup_steps=1,
                                             total_steps=args.steps))
    state = {"params": tparams, "opt": init_opt_state(tcfg.optimizer,
                                                      tparams)}
    step = make_train_step(cfg, tcfg)

    def aux(params):
        with torch.no_grad():
            return float(zoo.loss_fn(cfg, params, batch)[1]["aux"])

    rows = []
    for i in range(args.steps):
        new, m = step(state, batch)
        row = {k: float(v) for k, v in m.items()}
        if cfg.family == "moe":
            row["aux"] = aux(state["params"])
            if i == args.steps - 1:
                row["aux_after"] = aux(new["params"])
        if i == 0:
            with torch.no_grad():
                row["first_order_change"] = float(sum(
                    (m.double() / (1 - tcfg.optimizer.b1)
                     * (n.double() - o.double())).sum()
                    for o, n, m in zip(_leaves(state["params"]),
                                       _leaves(new["params"]),
                                       _leaves(new["opt"]["mu"]))))
        rows.append(row)
        state = new
    return rows


def _summary(package: str, rows: list[dict]) -> dict:
    losses = [r["loss"] for r in rows]
    out = {"package": package, "loss": losses,
           "grad_norm": [r["grad_norm"] for r in rows],
           "lr": [r["lr"] for r in rows],
           "first_order_change_step_1": rows[0]["first_order_change"],
           "observed_change_step_1": losses[1] - losses[0]}
    if "aux" in rows[0]:
        out["aux"] = [r["aux"] for r in rows] + [rows[-1]["aux_after"]]
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--d-ff", type=int, default=0,
                    help="feed-forward width (0: the config's)")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--card", action="store_true",
                    help="the port alone, on the CUDA card")
    ap.add_argument("--sweep", action="store_true",
                    help="with --card: every case of CARD_SWEEP")
    ap.add_argument("--package", choices=["reference", "port"])
    args = ap.parse_args()
    if args.card:
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        cases = (CARD_SWEEP if args.sweep
                 else ((args.layers, args.dtype, args.seq),))
        for args.layers, args.dtype, args.seq in cases:
            setup = {k: v for k, v in vars(args).items()
                     if k not in ("package", "sweep")}
            print(json.dumps({"setup": setup,
                              **_summary("port", run_port(
                                  args, torch.device("cuda")))}),
                  flush=True)
            torch.cuda.empty_cache()
        return
    if args.package:
        if args.package == "reference":
            rows = run_reference(args)
        else:
            import torch
            rows = run_port(args, torch.device("cpu"))
        print(json.dumps(rows))
        return
    setup = {k: v for k, v in vars(args).items()
             if k not in ("package", "card", "sweep")}
    print(json.dumps({"setup": setup}))
    for package in ("reference", "port"):
        out = subprocess.run(
            [sys.executable, __file__, "--package", package,
             *[f"--{k.replace('_', '-')}={v}"
               for k, v in setup.items()]],
            check=True, capture_output=True, text=True).stdout
        print(json.dumps(_summary(package,
                                  json.loads(out.strip().splitlines()[-1]))))


if __name__ == "__main__":
    main()
