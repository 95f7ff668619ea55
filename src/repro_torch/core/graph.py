"""Dataflow op-graph IR: the unit the paper's runtime schedules.

The port's own copy of ``repro.core.graph``.  A training step (or a
serving wave, ``serving.wave_op_graph``) is a DAG of ``Op`` nodes.  Each
op carries the analytic workload attributes the cost oracles need (flops,
bytes moved, working set, parallel fraction) plus its *op class*, the key
under which concurrency decisions are cached (the paper's Strategy 2 keys
decisions by operation type, not instance).

Graph builders for the paper's three evaluation networks (ResNet-50,
DCGAN, Inception-v3: op mixes taken from the paper's Table VI and
profiling claims) and for transformer-block step graphs live here too.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import defaultdict, deque
from typing import Callable, Iterable


@dataclasses.dataclass
class Op:
    """One schedulable operation instance."""

    uid: int
    name: str                      # unique instance name, e.g. "conv2d_bwd_filter/12"
    op_class: str                  # class key, e.g. "Conv2DBackpropFilter"
    input_shape: tuple[int, ...]   # the paper's "input data size"
    flops: float = 0.0
    bytes_moved: float = 0.0       # main-memory traffic at parallelism 1
    working_set: float = 0.0       # bytes live during execution
    parallel_fraction: float = 0.95  # Amdahl fraction (simmachine only)
    deps: tuple[int, ...] = ()     # uids of producers
    payload: Callable | None = None  # optional real callable to run
    tunable: bool = True           # False: Eigen-style op, keep session default

    @property
    def size_key(self) -> tuple[str, tuple[int, ...]]:
        """(op_class, input_shape): the paper's per-(op, input-size) key."""
        return (self.op_class, self.input_shape)

    @property
    def weight(self) -> float:
        """Scalar proxy for 'how big' this instance is (Strategy 2 uses the
        largest instance of a class to fix the class's concurrency)."""
        return self.flops + self.bytes_moved


@dataclasses.dataclass
class OpGraph:
    name: str
    ops: dict[int, Op]

    def __post_init__(self) -> None:
        self._consumers: dict[int, list[int]] = defaultdict(list)
        for op in self.ops.values():
            for d in op.deps:
                if d not in self.ops:
                    raise ValueError(f"{op.name} depends on unknown uid {d}")
                self._consumers[d].append(op.uid)

    # ---- structure ------------------------------------------------------
    def consumers(self, uid: int) -> list[int]:
        return self._consumers.get(uid, [])

    def sources(self) -> list[int]:
        return [u for u, op in self.ops.items() if not op.deps]

    # ---- ready-frontier contract ----------------------------------------
    # Every scheduler (``_EventSim``, ``_PoolSim``) drains a graph through
    # exactly four calls, so dynamic control flow needs no structural fork
    # in the strategy core:
    #
    # * ``reset()`` — restore the graph to its initial shape and return the
    #   ``RegionEvent``s of any regions that expand immediately (regions
    #   with no entry deps).  Called once per run, before readiness is
    #   derived, so a graph object can be scheduled many times.
    # * ``advance(uid, completed)`` — notify the graph that ``uid`` just
    #   completed (``completed`` is the full completed-uid set).  May
    #   materialize new ops (loop iterations, taken branches, region
    #   exits) and returns the ``RegionEvent``s describing them; the sim
    #   absorbs any new ops whose deps are already complete into its ready
    #   frontier.
    # * ``unresolved_regions()`` — regions whose final shape is still
    #   unknown; the pricing layer turns these into expectations.
    # * ``profile_view()`` — a static, dependency-free view carrying one
    #   clone of every op the graph could ever materialize, for the
    #   profiler/controller (which never read ``deps``).
    #
    # A static ``OpGraph`` is the trivial fixed point of this contract:
    # nothing ever changes shape, so all four are no-ops.
    def reset(self) -> list["RegionEvent"]:
        """Static graphs never change shape: nothing to restore."""
        return []

    def advance(self, uid: int,
                completed: set[int]) -> list["RegionEvent"]:
        """Static graphs never materialize ops on completion."""
        return []

    def unresolved_regions(self) -> tuple:
        """A static graph's shape is always fully resolved."""
        return ()

    def profile_view(self) -> "OpGraph":
        """Every op is already materialized: the graph is its own view."""
        return self

    def topo_order(self) -> list[int]:
        indeg = {u: len(op.deps) for u, op in self.ops.items()}
        q = deque(sorted(u for u, d in indeg.items() if d == 0))
        order: list[int] = []
        while q:
            u = q.popleft()
            order.append(u)
            for c in self._consumers.get(u, []):
                indeg[c] -= 1
                if indeg[c] == 0:
                    q.append(c)
        if len(order) != len(self.ops):
            raise ValueError(f"cycle detected in graph {self.name}")
        return order

    def validate(self) -> None:
        self.topo_order()

    # ---- stats ----------------------------------------------------------
    @property
    def n_ops(self) -> int:
        return len(self.ops)

    def classes(self) -> dict[str, list[Op]]:
        by_class: dict[str, list[Op]] = defaultdict(list)
        for op in self.ops.values():
            by_class[op.op_class].append(op)
        return dict(by_class)

    def total_flops(self) -> float:
        return sum(op.flops for op in self.ops.values())

    def fingerprint(self) -> str:
        h = hashlib.sha1()
        for u in sorted(self.ops):
            op = self.ops[u]
            h.update(f"{u}:{op.op_class}:{op.input_shape}:{op.deps}".encode())
        return h.hexdigest()[:12]


class GraphBuilder:
    """Incremental DAG construction helper."""

    def __init__(self, name: str):
        self.name = name
        self._ops: dict[int, Op] = {}
        self._next = 0

    def add(self, op_class: str, input_shape: tuple[int, ...], *,
            flops: float = 0.0, bytes_moved: float = 0.0,
            working_set: float = 0.0, parallel_fraction: float = 0.95,
            deps: Iterable[int] = (), name: str | None = None,
            payload: Callable | None = None, tunable: bool = True) -> int:
        uid = self._next
        self._next += 1
        self._ops[uid] = Op(
            uid=uid,
            name=name or f"{op_class.lower()}/{uid}",
            op_class=op_class,
            input_shape=tuple(input_shape),
            flops=flops, bytes_moved=bytes_moved,
            working_set=working_set or bytes_moved,
            parallel_fraction=parallel_fraction,
            deps=tuple(deps), payload=payload, tunable=tunable)
        return uid

    def build(self) -> OpGraph:
        g = OpGraph(self.name, dict(self._ops))
        g.validate()
        return g


# ---------------------------------------------------------------------------
# Dynamic control flow: regions + DynamicOpGraph.
#
# A region is a placeholder for a data-dependent subgraph: a while-loop
# whose trip count is unknown until the predicate resolves at runtime, or
# a conditional whose taken branch is unknown until its inputs arrive.
# Each region reserves one ``exit_uid`` at build time so downstream static
# ops can depend on the region's result before the region has any shape;
# the exit op itself is materialized only when the region resolves.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RegionEvent:
    """One shape change at a scheduling instant.

    ``kind`` is ``"expand"`` (a while-loop materialized its next
    iteration; trip count still unknown) or ``"resolve"`` (the region's
    final shape is now known: the exit op exists and ``outcome`` carries
    the observed trip count / branch direction for trip-count learning).
    """

    kind: str                    # "expand" | "resolve"
    region: "WhileRegion | CondRegion"
    new_uids: tuple[int, ...]    # ops materialized by this step
    outcome: float | None = None  # resolve only: trips taken / 1.0 if true


@dataclasses.dataclass
class WhileRegion:
    """Lazily-unrolled loop: ``body`` repeats ``actual_trips`` times.

    ``actual_trips`` is the hidden ground truth (what the data decides at
    runtime); the scheduler only ever sees ``est_trips`` (the pricing
    prior), the iterations materialized so far, and — once the region
    resolves — the observed count, which feeds ``TripCountEstimator``
    under ``key`` so later tenants running the same loop start informed.
    """

    kind = "while"               # class attr: duck-typed dispatch key

    rid: int
    body: OpGraph                # one iteration, cloned per trip
    entry_deps: tuple[int, ...]  # outer uids gating the first iteration
    exit_uid: int                # reserved uid of the (future) exit op
    exit_op: Op                  # template; deps filled at resolution
    est_trips: float             # pricing prior (expected trip count)
    max_trips: int               # upper bound (predicate hard limit)
    actual_trips: int            # hidden ground truth for this run
    key: tuple = None            # pool-wide trip-count learning key
    # runtime state (owned by the enclosing DynamicOpGraph)
    trips_started: int = 0
    trips_done: int = 0
    resolved: bool = False
    gate: tuple[int, ...] = ()   # uids whose completion steps the region

    def __post_init__(self) -> None:
        if self.body.n_ops == 0:
            raise ValueError(f"while region {self.rid}: empty body")
        if not 0 <= self.actual_trips <= self.max_trips:
            raise ValueError(
                f"while region {self.rid}: actual_trips "
                f"{self.actual_trips} outside [0, {self.max_trips}]")
        if self.key is None:
            self.key = ("while", self.body.fingerprint())


@dataclasses.dataclass
class CondRegion:
    """Two-armed conditional: exactly one branch materializes.

    ``taken`` is the hidden ground truth; ``p_true`` is the pricing prior
    (probability the true branch runs).  Resolution happens the instant
    the entry gate completes — the branch is then known, so expand and
    resolve collapse into one event with ``outcome`` 1.0/0.0.
    """

    kind = "cond"

    rid: int
    branches: tuple[OpGraph, OpGraph]  # (true, false); either may be empty
    entry_deps: tuple[int, ...]
    exit_uid: int
    exit_op: Op
    p_true: float                # pricing prior in [0, 1]
    taken: bool                  # hidden ground truth for this run
    key: tuple = None
    resolved: bool = False
    gate: tuple[int, ...] = ()

    def __post_init__(self) -> None:
        if self.key is None:
            self.key = ("cond", self.branches[0].fingerprint(),
                        self.branches[1].fingerprint())


@dataclasses.dataclass
class DynamicOpGraph(OpGraph):
    """An ``OpGraph`` whose shape resolves at runtime.

    Implements the ready-frontier contract documented on ``OpGraph``:
    ``reset()`` restores the initial (static ops only) shape and expands
    entry-free regions; ``advance(uid, completed)`` steps any region
    whose gate just completed, cloning body/branch ops with fresh uids
    and finally materializing the reserved exit op; with zero regions it
    degenerates to a static graph bit-for-bit (every method matches the
    ``OpGraph`` no-op behavior exactly).
    """

    regions: list = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        reserved = {r.exit_uid for r in self.regions}
        if len(reserved) != len(self.regions):
            raise ValueError(f"{self.name}: duplicate region exit uids")
        for op in self.ops.values():
            for d in op.deps:
                if d not in self.ops and d not in reserved:
                    raise ValueError(
                        f"{op.name} depends on unknown uid {d}")
        self._initial_ops = dict(self.ops)
        self._base_next = max([*self.ops, *reserved], default=-1) + 1
        self.reset()

    # ---- frontier contract ----------------------------------------------
    def reset(self) -> list[RegionEvent]:
        self.ops = dict(self._initial_ops)
        self._consumers = defaultdict(list)
        for op in self.ops.values():
            for d in op.deps:
                self._consumers[d].append(op.uid)
        self._next = self._base_next
        events: list[RegionEvent] = []
        for r in self.regions:
            r.resolved = False
            r.gate = r.entry_deps
            if r.kind == "while":
                r.trips_started = 0
                r.trips_done = 0
        for r in self.regions:
            # no entry deps: the region's first step is unconditional
            if not r.gate:
                events.append(self._step_region(r))
        return events

    def advance(self, uid: int, completed: set[int]) -> list[RegionEvent]:
        events: list[RegionEvent] = []
        for r in self.regions:
            if (not r.resolved and uid in r.gate
                    and all(g in completed for g in r.gate)):
                events.append(self._step_region(r))
        return events

    def unresolved_regions(self) -> tuple:
        return tuple(r for r in self.regions if not r.resolved)

    def profile_view(self) -> OpGraph:
        """Static dep-free view with one clone of every materializable op.

        The profiler dedups on ``size_key`` and the controller keys plans
        by op class — neither reads ``deps`` — so stripping edges yields a
        valid static ``OpGraph`` covering body/branch/exit ops that have
        not materialized yet.  With zero regions the graph is its own
        view (bit-for-bit the static path).
        """
        if not self.regions:
            return self
        ops: dict[int, Op] = {}
        nxt = 0
        for op in self._initial_ops.values():
            ops[nxt] = dataclasses.replace(op, uid=nxt, deps=())
            nxt += 1
        templates: list[Op] = []
        for r in self.regions:
            bodies = [r.body] if r.kind == "while" else list(r.branches)
            for body in bodies:
                templates.extend(body.ops[u] for u in sorted(body.ops))
            templates.append(r.exit_op)
        for op in templates:
            ops[nxt] = dataclasses.replace(op, uid=nxt, deps=())
            nxt += 1
        return OpGraph(f"{self.name}/profile", ops)

    # ---- region stepping -------------------------------------------------
    def _step_region(self, r) -> RegionEvent:
        if r.kind == "cond":
            branch = r.branches[0] if r.taken else r.branches[1]
            new, sinks = self._materialize(
                branch, r.gate, r.rid, "t" if r.taken else "f")
            self._place_exit(r, sinks if sinks else r.gate)
            r.resolved = True
            r.gate = ()
            return RegionEvent("resolve", r, (*new, r.exit_uid),
                               outcome=1.0 if r.taken else 0.0)
        # while: gate completion means the previous iteration finished
        r.trips_done = r.trips_started
        if r.trips_done >= r.actual_trips:
            self._place_exit(r, r.gate)
            r.resolved = True
            r.gate = ()
            return RegionEvent("resolve", r, (r.exit_uid,),
                               outcome=float(r.trips_done))
        new, sinks = self._materialize(
            r.body, r.gate, r.rid, f"i{r.trips_started}")
        r.trips_started += 1
        r.gate = tuple(sinks)
        return RegionEvent("expand", r, tuple(new))

    def _materialize(self, template: OpGraph, src_deps: tuple[int, ...],
                     rid: int, tag: str) -> tuple[list[int], list[int]]:
        """Clone ``template`` with fresh uids; template sources inherit
        ``src_deps``.  Returns (new uids, mapped template-sink uids)."""
        sinks = set(template.ops)
        for op in template.ops.values():
            for d in op.deps:
                sinks.discard(d)
        mapping: dict[int, int] = {}
        new_uids: list[int] = []
        for tu in template.topo_order():
            top = template.ops[tu]
            uid = self._next
            self._next += 1
            deps = (tuple(mapping[d] for d in top.deps) if top.deps
                    else tuple(src_deps))
            self.ops[uid] = dataclasses.replace(
                top, uid=uid, name=f"{top.name}@r{rid}.{tag}", deps=deps)
            for d in deps:
                self._consumers[d].append(uid)
            mapping[tu] = uid
            new_uids.append(uid)
        return new_uids, [mapping[s] for s in sorted(sinks)]

    def _place_exit(self, r, deps) -> None:
        op = dataclasses.replace(r.exit_op, uid=r.exit_uid,
                                 deps=tuple(deps))
        self.ops[r.exit_uid] = op
        for d in op.deps:
            self._consumers[d].append(r.exit_uid)

    # ---- overrides over unmaterialized deps ------------------------------
    def topo_order(self) -> list[int]:
        # reserved exit uids are future producers: only materialized
        # edges constrain the order of materialized ops
        indeg = {u: sum(1 for d in op.deps if d in self.ops)
                 for u, op in self.ops.items()}
        q = deque(sorted(u for u, d in indeg.items() if d == 0))
        order: list[int] = []
        while q:
            u = q.popleft()
            order.append(u)
            for c in self._consumers.get(u, []):
                if c in self.ops:
                    indeg[c] -= 1
                    if indeg[c] == 0:
                        q.append(c)
        if len(order) != len(self.ops):
            raise ValueError(f"cycle detected in graph {self.name}")
        return order


def region_exit_op(shape: tuple[int, ...] = (1, 64)) -> Op:
    """Template for the tiny op materialized when a region resolves.

    Real and schedulable (downstream deps anchor on it) but deliberately
    cheap and non-tunable so it never perturbs concurrency decisions.
    """
    return Op(uid=-1, name="region_exit", op_class="RegionExit",
              input_shape=tuple(shape), flops=_elems(shape) * 1.0,
              bytes_moved=_elems(shape) * 8.0, working_set=_elems(shape) * 8.0,
              parallel_fraction=0.55, tunable=False)


class DynamicGraphBuilder(GraphBuilder):
    """``GraphBuilder`` + control-flow regions.

    ``add_while``/``add_cond`` reserve and return an exit uid that later
    ops may list in ``deps`` exactly like a normal producer uid.
    """

    def __init__(self, name: str):
        super().__init__(name)
        self._regions: list = []

    def add_while(self, body: OpGraph, *, deps: Iterable[int] = (),
                  est_trips: float, max_trips: int, actual_trips: int,
                  exit_op: Op | None = None, key: tuple | None = None) -> int:
        exit_uid = self._next
        self._next += 1
        self._regions.append(WhileRegion(
            rid=len(self._regions), body=body, entry_deps=tuple(deps),
            exit_uid=exit_uid, exit_op=exit_op or region_exit_op(),
            est_trips=float(est_trips), max_trips=int(max_trips),
            actual_trips=int(actual_trips), key=key))
        return exit_uid

    def add_cond(self, true_branch: OpGraph, false_branch: OpGraph, *,
                 deps: Iterable[int] = (), p_true: float, taken: bool,
                 exit_op: Op | None = None, key: tuple | None = None) -> int:
        exit_uid = self._next
        self._next += 1
        self._regions.append(CondRegion(
            rid=len(self._regions),
            branches=(true_branch, false_branch), entry_deps=tuple(deps),
            exit_uid=exit_uid, exit_op=exit_op or region_exit_op(),
            p_true=float(p_true), taken=bool(taken), key=key))
        return exit_uid

    def build(self) -> DynamicOpGraph:
        g = DynamicOpGraph(self.name, dict(self._ops),
                           regions=list(self._regions))
        g.validate()
        return g


# ---------------------------------------------------------------------------
# Paper workload graphs.
#
# The op mixes approximate the paper's profiled networks: op classes, rough
# instance counts, the Table II input sizes, and per-class scalability
# character (conv backprop scales worst; elementwise ops are tiny and
# bandwidth-bound — the Strategy 4 "small op" population).
# ---------------------------------------------------------------------------

_CONV_CLASSES = {
    # op_class: (parallel_fraction, flops_per_elem, bytes_per_elem, tunable)
    # conv flops/elem calibrated so thread-count optima track the paper's
    # Table II (small inputs -> ~2x cores/3, the largest -> all 68 cores).
    # ``tunable=False`` marks Eigen-implemented ops: the paper only
    # re-tunes MKL-DNN ops (>70% of step time); Eigen ops keep the session
    # default concurrency (§IV-A "Controlling intra-op parallelism").
    "Conv2DBackpropFilter": (0.95, 740.0, 260.0, True),
    "Conv2DBackpropInput": (0.95, 700.0, 240.0, True),
    "Conv2D": (0.96, 660.0, 200.0, True),
    "MatMul": (0.96, 400.0, 60.0, True),
    "FusedBatchNorm": (0.80, 8.0, 12.0, True),
    "FusedBatchNormGrad": (0.80, 10.0, 14.0, True),
    "MaxPool": (0.85, 4.0, 8.0, True),
    "MaxPoolGrad": (0.85, 5.0, 10.0, True),
    "AvgPool": (0.85, 4.0, 8.0, True),
    "BiasAddGrad": (0.70, 2.0, 8.0, False),
    "ApplyAdam": (0.88, 8.0, 16.0, False),
    "Mul": (0.60, 1.0, 12.0, False),
    "Sum": (0.65, 1.0, 8.0, False),
    "Mean": (0.65, 1.0, 8.0, False),
    "Select": (0.55, 1.0, 12.0, False),
    "Tile": (0.60, 0.5, 16.0, False),
    "InputConversion": (0.75, 2.0, 12.0, False),
    "ToTf": (0.55, 0.5, 12.0, False),
    "SquaredDifference": (0.60, 2.0, 12.0, False),
}

# Table II input sizes (NHWC) used throughout the paper's measurements.
PAPER_INPUT_SIZES = [
    (32, 8, 8, 384),
    (32, 17, 17, 384),
    (32, 8, 8, 2048),
]


def _elems(shape: tuple[int, ...]) -> float:
    n = 1.0
    for d in shape:
        n *= d
    return n


def _chain_block(b: GraphBuilder, prev: int, shape: tuple[int, ...],
                 classes: list[str], rng_shapes: list[tuple[int, ...]],
                 idx: int, extra_pools: bool = False) -> int:
    """One fwd+bwd 'layer': conv fwd, then bwd pair + small ops fanning in."""
    shp = rng_shapes[idx % len(rng_shapes)]
    spec = _CONV_CLASSES
    conv = b.add("Conv2D", shp, deps=[prev],
                 flops=_elems(shp) * spec["Conv2D"][1],
                 bytes_moved=_elems(shp) * spec["Conv2D"][2],
                 parallel_fraction=spec["Conv2D"][0],
                 tunable=spec["Conv2D"][3])
    bn = b.add("FusedBatchNorm", shp, deps=[conv],
               flops=_elems(shp) * spec["FusedBatchNorm"][1],
               bytes_moved=_elems(shp) * spec["FusedBatchNorm"][2],
               parallel_fraction=spec["FusedBatchNorm"][0],
               tunable=spec["FusedBatchNorm"][3])
    # small ops act on a genuinely smaller tensor (distinct input size:
    # the paper's premise is that (op_class, input_size) determines the
    # work, so instances sharing a size_key must share their cost)
    small_shp = (*shp[:3], max(shp[3] // 16, 8))
    small_cls = classes[idx % len(classes)]
    small = b.add(small_cls, small_shp, deps=[conv],
                  flops=_elems(small_shp) * spec[small_cls][1],
                  bytes_moved=_elems(small_shp) * spec[small_cls][2],
                  parallel_fraction=spec[small_cls][0],
                  tunable=spec[small_cls][3])
    # backward pair — independent of each other given bn: the co-run pair
    # of the paper's Table III.
    bf = b.add("Conv2DBackpropFilter", shp, deps=[bn, small],
               flops=_elems(shp) * spec["Conv2DBackpropFilter"][1],
               bytes_moved=_elems(shp) * spec["Conv2DBackpropFilter"][2],
               parallel_fraction=spec["Conv2DBackpropFilter"][0],
               tunable=True)
    bi = b.add("Conv2DBackpropInput", shp, deps=[bn, small],
               flops=_elems(shp) * spec["Conv2DBackpropInput"][1],
               bytes_moved=_elems(shp) * spec["Conv2DBackpropInput"][2],
               parallel_fraction=spec["Conv2DBackpropInput"][0],
               tunable=True)
    join_deps = [bf, bi]
    if extra_pools:
        # Inception-v3 is pool/Tile-heavy (paper Table VI tops out with
        # AvgPool and Tile): full-weight pooling branches per block.
        for pool_cls in ("AvgPool", "MaxPool", "MaxPoolGrad"):
            join_deps.append(b.add(
                pool_cls, shp, deps=[conv],
                flops=_elems(shp) * spec[pool_cls][1] * 3.0,
                bytes_moved=_elems(shp) * 40.0,
                parallel_fraction=spec[pool_cls][0],
                tunable=spec[pool_cls][3]))
    join = b.add("Sum", shp, deps=join_deps,
                 flops=_elems(shp) * 1.0,
                 bytes_moved=_elems(shp) * 8.0,
                 parallel_fraction=0.65, tunable=False)
    return join


def build_paper_graph(model: str, scale: int = 1) -> OpGraph:
    """Op graphs shaped like the paper's three networks.

    ``scale`` multiplies layer count (1 = a representative single step
    skeleton; the paper's Inception-v3 step has ~16k ops — use scale to
    stress the scheduler).
    """
    model = model.lower()
    # per-model input-size distributions: ResNet-50/DCGAN train on
    # CIFAR-10/MNIST (small ops, low thread optima — the paper's manual
    # best used intra=16/34), Inception-v3 on ImageNet (big ops, optima up
    # to 68 — manual best intra=68).
    if model == "resnet50":
        layers, smalls = 16 * scale, ["Mul", "Select", "Mean", "Tile",
                                      "InputConversion", "ToTf"]
        sizes = [(64, 16, 16, 64), (64, 8, 8, 128), (64, 4, 4, 256)]
    elif model == "dcgan":
        layers, smalls = 8 * scale, ["Mul", "BiasAddGrad", "ToTf",
                                     "FusedBatchNormGrad"]
        # MNIST-scale: every op saturates around half the socket (the
        # paper's DCGAN manual-best intra-op was 34)
        sizes = [(64, 14, 14, 64), (64, 7, 7, 256), (64, 28, 28, 16)]
    elif model == "inception_v3":
        layers, smalls = 42 * scale, ["Mul", "Tile", "SquaredDifference",
                                      "InputConversion", "MaxPool", "AvgPool"]
        sizes = list(PAPER_INPUT_SIZES)
    elif model == "alexnet":
        # the paper's regression-model TEST set (Table IV)
        layers, smalls = 5 * scale, ["Mul", "BiasAddGrad", "MaxPool", "Mean"]
        sizes = [(16, 13, 13, 384), (16, 27, 27, 256), (16, 55, 55, 96)]
    else:
        raise ValueError(f"unknown paper model {model!r}")

    b = GraphBuilder(model)
    root = b.add("InputConversion", (32, 224, 224, 3),
                 flops=_elems((32, 224, 224, 3)) * 2.0,
                 bytes_moved=_elems((32, 224, 224, 3)) * 12.0,
                 parallel_fraction=0.75, tunable=False)
    prev = root
    pools = model == "inception_v3"
    for i in range(layers):
        prev = _chain_block(b, prev, (32, 8, 8, 384), smalls, sizes, i,
                            extra_pools=pools)
    b.add("ApplyAdam", (32, 8, 8, 2048), deps=[prev],
          flops=_elems((32, 8, 8, 2048)) * 8.0,
          bytes_moved=_elems((32, 8, 8, 2048)) * 16.0,
          parallel_fraction=0.88, tunable=False)
    return b.build()


def build_transformer_step_graph(*, n_layers: int, d_model: int, n_heads: int,
                                 d_ff: int, seq: int, batch: int,
                                 moe_experts: int = 0,
                                 name: str = "transformer") -> OpGraph:
    """Layer-grain step graph of a transformer training step.

    Op classes here are the tuner's op classes: qkv_proj, attention, out_proj,
    mlp_up, mlp_down (or moe_expert + router), norm, embed, unembed.
    """
    b = GraphBuilder(name)
    tok = float(batch * seq)
    d = float(d_model)
    embed = b.add("embed", (batch, seq, d_model), flops=2 * tok * d,
                  bytes_moved=tok * d * 2, parallel_fraction=0.9)
    prev = embed
    for li in range(n_layers):
        norm1 = b.add("norm", (batch, seq, d_model), deps=[prev],
                      flops=6 * tok * d, bytes_moved=tok * d * 4,
                      parallel_fraction=0.7)
        qkv = b.add("qkv_proj", (batch, seq, d_model), deps=[norm1],
                    flops=2 * tok * d * (3 * d), bytes_moved=tok * d * 8,
                    parallel_fraction=0.98)
        attn = b.add("attention", (batch, n_heads, seq, seq), deps=[qkv],
                     flops=4 * tok * seq * d, bytes_moved=tok * d * 6,
                     parallel_fraction=0.97)
        out = b.add("out_proj", (batch, seq, d_model), deps=[attn],
                    flops=2 * tok * d * d, bytes_moved=tok * d * 6,
                    parallel_fraction=0.98)
        norm2 = b.add("norm", (batch, seq, d_model), deps=[out],
                      flops=6 * tok * d, bytes_moved=tok * d * 4,
                      parallel_fraction=0.7)
        if moe_experts:
            router = b.add("router", (batch, seq, moe_experts), deps=[norm2],
                           flops=2 * tok * d * moe_experts,
                           bytes_moved=tok * d * 2, parallel_fraction=0.8)
            experts = [
                b.add("moe_expert", (batch, seq, d_ff), deps=[router],
                      flops=6 * tok * d * d_ff / moe_experts,
                      bytes_moved=tok * d * 4 / moe_experts,
                      parallel_fraction=0.97,
                      name=f"moe_expert/{li}.{e}")
                for e in range(moe_experts)
            ]
            prev = b.add("moe_combine", (batch, seq, d_model), deps=experts,
                         flops=2 * tok * d, bytes_moved=tok * d * 4,
                         parallel_fraction=0.75)
        else:
            up = b.add("mlp_up", (batch, seq, d_ff), deps=[norm2],
                       flops=4 * tok * d * d_ff, bytes_moved=tok * d * 6,
                       parallel_fraction=0.98)
            prev = b.add("mlp_down", (batch, seq, d_model), deps=[up],
                         flops=2 * tok * d * d_ff, bytes_moved=tok * d * 6,
                         parallel_fraction=0.98)
    b.add("unembed", (batch, seq, d_model), deps=[prev],
          flops=2 * tok * d * 32000, bytes_moved=tok * d * 4,
          parallel_fraction=0.96)
    return b.build()


# ---------------------------------------------------------------------------
# Dynamic workloads: data-dependent shape.
# ---------------------------------------------------------------------------

def _rnn_cell_body(shape: tuple[int, ...], work: float) -> OpGraph:
    """One recurrent cell: gate -> mix -> out chain (a while-loop body)."""
    b = GraphBuilder("rnn_cell")
    n = _elems(shape)
    gate = b.add("rnn_gate", shape, flops=n * work,
                 bytes_moved=n * 24.0, parallel_fraction=0.94)
    mix = b.add("rnn_mix", shape, deps=[gate], flops=n * work * 1.5,
                bytes_moved=n * 16.0, parallel_fraction=0.96)
    b.add("rnn_out", shape, deps=[mix], flops=n * work * 0.5,
          bytes_moved=n * 20.0, parallel_fraction=0.9)
    return b.build()


def build_recurrent_step_graph(*, trips: int, max_trips: int = 8,
                               est_trips: float | None = None,
                               shape: tuple[int, ...] = (32, 32, 128),
                               work: float = 220.0,
                               name: str = "recurrent") -> DynamicOpGraph:
    """Recurrent training step: embed -> while(rnn cell) -> unembed.

    ``trips`` is the data-dependent sequence-chunk count (hidden ground
    truth); ``est_trips`` is the pricing prior (defaults to the
    pessimistic ``max_trips``, the frozen-plan worst case).
    """
    b = DynamicGraphBuilder(name)
    n = _elems(shape)
    embed = b.add("embed", shape, flops=n * 16.0, bytes_moved=n * 12.0,
                  parallel_fraction=0.9)
    loop = b.add_while(
        _rnn_cell_body(shape, work), deps=[embed],
        est_trips=est_trips if est_trips is not None else float(max_trips),
        max_trips=max_trips, actual_trips=trips,
        key=("while", "rnn_cell", shape))
    b.add("unembed", shape, deps=[loop], flops=n * 24.0,
          bytes_moved=n * 12.0, parallel_fraction=0.9)
    return b.build()


def _decoder_body(shape: tuple[int, ...], work: float) -> OpGraph:
    b = GraphBuilder("decoder_layer")
    n = _elems(shape)
    attn = b.add("dec_attn", shape, flops=n * work,
                 bytes_moved=n * 18.0, parallel_fraction=0.96)
    b.add("dec_mlp", shape, deps=[attn], flops=n * work * 2.0,
          bytes_moved=n * 14.0, parallel_fraction=0.97)
    return b.build()


def _verify_branch(shape: tuple[int, ...], work: float,
                   heavy: bool) -> OpGraph:
    b = GraphBuilder("verify_big" if heavy else "verify_small")
    n = _elems(shape)
    scale = 6.0 if heavy else 0.5
    cls = "correct_big" if heavy else "verify_small"
    b.add(cls, shape, flops=n * work * scale, bytes_moved=n * 16.0,
          parallel_fraction=0.95)
    return b.build()


def build_early_exit_wave(*, depth: int, max_depth: int = 6,
                          est_depth: float | None = None,
                          accept: bool = True, p_accept: float = 0.5,
                          shape: tuple[int, ...] = (16, 64, 96),
                          work: float = 160.0,
                          name: str = "early_exit") -> DynamicOpGraph:
    """Early-exit serving wave with data-dependent depth.

    prefill -> while(decoder layer, ``depth`` trips) -> cond(cheap verify
    if the draft is ``accept``-ed, expensive correction otherwise) ->
    readout.  ``est_depth``/``p_accept`` are the pricing priors.
    """
    b = DynamicGraphBuilder(name)
    n = _elems(shape)
    prefill = b.add("prefill", shape, flops=n * 60.0, bytes_moved=n * 16.0,
                    parallel_fraction=0.96)
    loop = b.add_while(
        _decoder_body(shape, work), deps=[prefill],
        est_trips=est_depth if est_depth is not None else float(max_depth),
        max_trips=max_depth, actual_trips=depth,
        key=("while", "decoder_layer", shape))
    cond = b.add_cond(
        _verify_branch(shape, work, heavy=False),
        _verify_branch(shape, work, heavy=True),
        deps=[loop], p_true=p_accept, taken=accept,
        key=("cond", "verify", shape))
    b.add("readout", shape, deps=[cond], flops=n * 12.0,
          bytes_moved=n * 10.0, parallel_fraction=0.85)
    return b.build()
