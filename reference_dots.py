"""Per-device dot shapes of one reference cell, from its partitioned HLO.

Compiles one (arch x shape) cell of the JAX reference on CPU host
devices with ``repro.launch.dryrun.lower_cell`` (one microbatch, scans
unrolled), on one device and on a mesh, and prints for each ``dot`` of
the optimized HLO its einsum (the ``op_name`` of its metadata), its
result shape and its operands' shapes, with how many times it occurs.
A product that the mesh splits over all its devices shows a result
(or contraction) that many times smaller than on one device; one that a
mesh axis leaves whole shows the same extent there: the reference's
repeats, held against the port's ``CostCounter.replicated``
(``tests/test_torch_mesh_repeats.py``).

    PYTHONPATH=src python reference_dots.py --arch olmo-1b --set n_heads=6 \\
        --set n_kv_heads=6 --mesh 2x4
    PYTHONPATH=src python reference_dots.py --arch whisper-small --full \\
        --seq 4096 --batch 256 --mesh 16x16 --only bhqk --out /tmp/w.json

Smoke configs in fp32 by default (``--full``: the published widths,
depth cut to ``depth_plan``'s lower depth where it has one).  Importing
``repro.launch.dryrun`` brings up 512 host devices.  Runs on the CPU
only; the JAX package is read, never edited.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import re

DEF = re.compile(r"^\s*(?:ROOT )?(%[\w.\-]+) = \w+\[([\d,]*)\]")
DOT = re.compile(r"= \w+\[([\d,]*)\][^ ]* dot\((%[\w.\-]+), (%[\w.\-]+)\)")
OP_NAME = re.compile(r'op_name="([^"]+)"')


def _dims(text: str) -> tuple[int, ...]:
    return tuple(int(n) for n in text.split(",") if n)


def parse_dots(hlo: str) -> list[dict]:
    """Every ``dot`` of an optimized HLO module's text: its einsum, result
    and operand shapes, and its count (dots of the same einsum and shapes
    merged), sorted."""
    shapes = {}
    for line in hlo.splitlines():
        m = DEF.match(line)
        if m:
            shapes[m.group(1)] = m.group(2)
    dots: collections.Counter = collections.Counter()
    for line in hlo.splitlines():
        m = DOT.search(line)
        if not m:
            continue
        on = OP_NAME.search(line)
        spec = on.group(1).split("/")[-2] if on else "?"
        dots[(spec, m.group(1), shapes.get(m.group(2), ""),
              shapes.get(m.group(3), ""))] += 1
    return [{"einsum": spec, "result": _dims(r), "lhs": _dims(a),
             "rhs": _dims(b), "count": n}
            for (spec, r, a, b), n in sorted(dots.items())]


def cell_dots(arch: str, shape_name: str, mesh_shape: tuple[int, ...], *,
              overrides: dict, seq: int, batch: int, full: bool = False
              ) -> dict:
    """{"flops_per_device", "dots"} of the cell on a ("data", "model")
    mesh of ``mesh_shape`` (one microbatch, scans unrolled)."""
    from repro.configs import SHAPES, get_config
    from repro.launch import dryrun
    from repro.launch.mesh import make_mesh
    cfg = get_config(arch, smoke=not full)
    if full:
        plan = dryrun.depth_plan(cfg)
        if plan is not None:
            overrides = {"n_layers": plan[0], **overrides}
    else:
        overrides = {"dtype": "float32", **overrides}
    cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name].scaled(seq=seq, batch=batch)
    texts = []
    parse = dryrun.parse_collectives

    def keep(hlo, **kw):
        texts.append(hlo)
        return parse(hlo, **kw)
    dryrun.parse_collectives = keep
    try:
        mesh = make_mesh(tuple(mesh_shape), ("data", "model"))
        rec = dryrun.lower_cell(cfg, shape, mesh, micro_override=1,
                                unroll=True)
    finally:
        dryrun.parse_collectives = parse
    return {"flops_per_device": rec["flops_per_device"],
            "dots": parse_dots(texts[-1])}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--seq", type=int, default=96)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mesh", action="append",
                    help="AxB ('data' x 'model'); repeatable; default 1x1 "
                    "and 2x4")
    ap.add_argument("--set", action="append", default=[],
                    help="config field=int, e.g. n_heads=6")
    ap.add_argument("--full", action="store_true",
                    help="the published widths, not the smoke config")
    ap.add_argument("--only", default="",
                    help="print only dots whose einsum holds this text")
    ap.add_argument("--out", default=None, help="write the JSON here")
    args = ap.parse_args()
    overrides = {k: int(v) for k, v in (s.split("=", 1) for s in args.set)}
    out = {}
    for m in args.mesh or ["1x1", "2x4"]:
        rec = cell_dots(args.arch, args.shape,
                        tuple(int(n) for n in m.split("x")),
                        overrides=overrides, seq=args.seq, batch=args.batch,
                        full=args.full)
        rec["dots"] = [d for d in rec["dots"] if args.only in d["einsum"]]
        out[m] = rec
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
