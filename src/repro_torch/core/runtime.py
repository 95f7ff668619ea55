"""The runtime driver: the paper's Fig. 2 workflow.

The port's copy of ``repro.core.runtime``.  ``ConcurrencyRuntime`` glues
the pieces together exactly in the paper's order: the first N training
steps run ops serially while the hill-climbing profiler measures them
(profiling steps); the resulting curves freeze a ``ConcurrencyPlan``
(Strategies 1-2); every subsequent step executes under the co-run
scheduler (Strategies 3-4).  The same step graph is reused across steps
(the paper's stable-step observation, §II-A), so profiling cost
amortizes over thousands of steps.

Two executors:

* the **simulated executor** (``SimMachine``-timed) validates the decision
  logic deterministically: this is what the paper-table benchmarks use;
* ``RealGraphExecutor`` runs op payloads (PyTorch callables) on a worker
  pool with dependency tracking: on CUDA each worker owns a stream, so
  the worker count is the number of ops in flight on the card together.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait

import torch

from repro_torch import resolve_device
from repro_torch.core.concurrency import ConcurrencyController, ConcurrencyPlan
from repro_torch.core.graph import Op, OpGraph
from repro_torch.core.interference import InterferenceRecorder
from repro_torch.core.perfmodel import (CurveCache, HillClimbProfiler, ProfileStore,
                                  paper_case_lists)
from repro_torch.core.planstore import (OBS_FINISH, OpObservation, PlanStore,
                                  make_plan_store)
from repro_torch.core.scheduler import CorunScheduler, ScheduleResult, uniform_schedule
from repro_torch.core.simmachine import Placement, SimMachine
from repro_torch.core.strategy import (CONFIG_SCHEMA_VERSION, StrategyConfig,
                                 _check_config_dict,
                                 fold_deprecated_strategy_kwargs)
from repro_torch.obs.trace import TraceSink


@dataclasses.dataclass(init=False)
class RuntimeConfig:
    """Single-job runtime knobs.  Strategy-owned knobs (S3/S4 switches,
    candidate counts, topology, feedback, sink, ...) live ONCE on the
    composed ``strategy`` field; only the knobs the runtime itself
    consumes (profiling interval, S2 clamp, interference threshold) are
    declared here.  The old flat constructor kwargs
    (``RuntimeConfig(feedback="ewma")``) keep working with a
    DeprecationWarning — they fold onto ``strategy``."""

    interval: int = 4               # hill-climb probe interval x
    max_deviation: int = 2          # Strategy 2 clamp (paper's empirical 2)
    strategy2: bool = True
    interference_threshold: float = 1.35
    strategy: StrategyConfig = dataclasses.field(
        default_factory=StrategyConfig)

    def __init__(self, interval: int = 4, max_deviation: int = 2,
                 strategy2: bool = True,
                 interference_threshold: float = 1.35,
                 strategy: StrategyConfig | None = None, **deprecated):
        self.interval = interval
        self.max_deviation = max_deviation
        self.strategy2 = strategy2
        self.interference_threshold = interference_threshold
        self.strategy = fold_deprecated_strategy_kwargs(
            type(self).__name__,
            strategy if strategy is not None else StrategyConfig(),
            deprecated)

    # read-only views of the strategy-owned knobs, so the sprawling
    # existing read sites (schedulers, benchmarks, tests) keep working
    @property
    def enable_s3(self) -> bool: return self.strategy.enable_s3

    @property
    def enable_s4(self) -> bool: return self.strategy.enable_s4

    @property
    def candidates(self) -> int: return self.strategy.candidates

    @property
    def max_ht_corunners(self) -> int: return self.strategy.max_ht_corunners

    @property
    def min_fallback_cores(self) -> int:
        return self.strategy.min_fallback_cores

    @property
    def fallback_slack(self) -> float: return self.strategy.fallback_slack

    @property
    def topology(self) -> str: return self.strategy.topology

    @property
    def feedback(self) -> str: return self.strategy.feedback

    @property
    def sink(self) -> TraceSink: return self.strategy.sink

    def strategy_config(self) -> StrategyConfig:
        """The shared-core view of these knobs (see repro_torch.core.strategy).
        The multi-tenant PoolConfig composes the same StrategyConfig, so
        Strategy-3/4 rule parameters cannot drift between schedulers."""
        return self.strategy

    def to_dict(self) -> dict:
        """Versioned JSON form (the daemon's persisted store and the CLI
        share this serialization; the strategy nests its own document)."""
        return {"schema": CONFIG_SCHEMA_VERSION,
                "interval": self.interval,
                "max_deviation": self.max_deviation,
                "strategy2": self.strategy2,
                "interference_threshold": self.interference_threshold,
                "strategy": self.strategy.to_dict()}

    @classmethod
    def from_dict(cls, d) -> "RuntimeConfig":
        d = dict(d)
        strat = d.pop("strategy", None)
        kw = _check_config_dict(
            cls.__name__, d,
            {"interval", "max_deviation", "strategy2",
             "interference_threshold"})
        if strat is not None:
            kw["strategy"] = StrategyConfig.from_dict(strat)
        return cls(**kw)


@dataclasses.dataclass
class TrainingSummary:
    profiling_steps: int
    profiling_time: float           # serial time spent probing
    step_time: float                # steady-state scheduled step time
    baseline_step_time: float       # TF-recommendation uniform schedule
    total_steps: int

    @property
    def speedup(self) -> float:
        return self.baseline_step_time / self.step_time

    @property
    def total_time(self) -> float:
        return self.profiling_time + self.step_time * max(
            0, self.total_steps - self.profiling_steps)

    @property
    def profiling_overhead(self) -> float:
        return self.profiling_time / max(self.total_time, 1e-12)


class ConcurrencyRuntime:
    def __init__(self, machine: SimMachine | None = None,
                 config: RuntimeConfig | None = None,
                 plan_cache: "CurveCache | None" = None):
        self.machine = machine or SimMachine()
        self.config = config or RuntimeConfig()
        # optional cross-job curve cache (multi-tenant pool): profiling
        # probes one job paid for are reused by every later job
        self.plan_cache = plan_cache
        self.store: ProfileStore | None = None
        self.plan: ConcurrencyPlan | None = None
        self.controller: ConcurrencyController | None = None
        # the closed-loop plan store (built at profile time): every
        # prediction the scheduler consumes and every completion it
        # reports flows through it; persists across execute_step calls so
        # feedback="ewma" corrections carry from one step to the next
        self.planstore: PlanStore | None = None
        self.recorder = InterferenceRecorder(
            threshold=self.config.interference_threshold)

    # ---- phase 1: profiling steps -------------------------------------
    def _measure(self, op: Op, threads: int, variant: bool) -> float:
        return self.machine.op_time(
            op, Placement(threads, cache_sharing=variant))

    def profile(self, graph: OpGraph) -> ProfileStore:
        if self.plan_cache is not None:
            # caches that can pin themselves must refuse reuse across a
            # different timing function OR probe protocol: a curve's
            # measured samples carry the probe spacing, which Strategy-3
            # candidates and the S2 clamp's case_step assume
            bind = getattr(self.plan_cache, "bind_machine", None)
            if bind is not None:
                bind((self.machine.fingerprint, self.config.interval))
        profiler = HillClimbProfiler(
            measure=self._measure,
            case_lists=paper_case_lists(self.machine.spec.cores,
                                        self.machine.spec.tiles),
            interval=self.config.interval)
        # dynamic graphs are profiled/planned through their static
        # profile_view — one clone of every op a region could ever
        # materialize, so the frozen plan covers loop bodies and branches
        # before the first iteration exists (a static graph is its own
        # view: bit-identical to profiling the graph directly)
        view = graph.profile_view()
        self.store = profiler.profile_graph(view, cache=self.plan_cache)
        self.controller = ConcurrencyController(
            self.store, max_deviation=self.config.max_deviation,
            default_threads=self.machine.spec.cores,
            interval=self.config.interval)
        self.plan = self.controller.build_plan(view)
        self.planstore = make_plan_store(self.config.feedback,
                                         self.controller)
        return self.store

    def profiling_cost(self) -> tuple[int, float]:
        """(#profiling steps, serial seconds spent probing).

        The paper bounds N <= C/x * 2; each probing step runs every op once
        serially at that step's concurrency."""
        assert self.store is not None
        probes_per_curve = [c.probes for c in self.store.curves.values()]
        n_steps = max(probes_per_curve) if probes_per_curve else 0
        # curves served by a warm plan cache carry probes=0 — their sample
        # times were paid by another job, not this run
        probe_time = sum(y for c in self.store.curves.values() if c.probes
                         for pts in c.samples.values() for _, y in pts)
        return n_steps, probe_time

    # ---- phase 2: scheduled steps --------------------------------------
    def scheduler(self) -> CorunScheduler:
        assert self.plan is not None and self.controller is not None
        cfg = self.config
        return CorunScheduler(
            self.machine, self.controller, self.plan,
            recorder=self.recorder,
            enable_s3=cfg.enable_s3,
            enable_s4=cfg.enable_s4,
            strategy2=cfg.strategy2,
            max_ht_corunners=cfg.max_ht_corunners,
            candidates=cfg.candidates,
            min_fallback_cores=cfg.min_fallback_cores,
            fallback_slack=cfg.fallback_slack,
            topology=cfg.topology,
            feedback=cfg.feedback,
            sink=cfg.sink,
            planstore=self.planstore)

    def execute_step(self, graph: OpGraph) -> ScheduleResult:
        if self.plan is None:
            self.profile(graph)
        return self.scheduler().run(graph)

    # ---- end-to-end ------------------------------------------------------
    def train(self, graph: OpGraph, total_steps: int = 1000,
              baseline_intra: int | None = None) -> TrainingSummary:
        self.profile(graph)
        n_steps, probe_time = self.profiling_cost()
        result = self.execute_step(graph)
        baseline = uniform_schedule(
            graph, self.machine,
            intra=baseline_intra or self.machine.spec.cores, inter=1)
        return TrainingSummary(
            profiling_steps=n_steps,
            profiling_time=probe_time,
            step_time=result.makespan,
            baseline_step_time=baseline.makespan,
            total_steps=total_steps)


# ---------------------------------------------------------------------------
# Real-payload executor
# ---------------------------------------------------------------------------

def report_payload_observation(store: PlanStore, plan: ConcurrencyPlan | None,
                               op, dt: float) -> None:
    """Report one real payload completion through ``PlanStore.observe``.

    The wall time is attributed to the op's frozen-plan width (falling
    back to solo when the plan has no entry), so real timings feed the
    same closed loop the simulated schedulers use.  Shared by the batch
    ``RealGraphExecutor.run`` path and the service daemon's persistent
    executor."""
    if plan is not None and op.size_key in plan.per_instance:
        p = plan.per_instance[op.size_key]
        threads, variant = p.threads, p.variant
    else:
        threads, variant = 1, True
    try:
        predicted = store.predict(op, threads, variant)
    except KeyError:
        # op never profiled under this store — the observation record
        # still needs a predicted value (it is informative only:
        # AdaptivePlanStore re-derives the base prediction itself and
        # skips ops without a curve)
        predicted = dt
    store.observe(OpObservation(
        op=op, threads=threads, variant=variant, hyper=False,
        predicted=predicted, observed=dt, kind=OBS_FINISH))


def _tensors(value):
    """Every tensor in ``value``: a tensor, or tuples, lists and dicts of
    them, at any depth."""
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)


class _StreamPool:
    """The worker streams of every executor in the process, per device.

    A worker thread leases one stream a device for as long as it lives and
    its executor hands the leases back once its workers are gone (the end
    of a batch ``run``, or ``close``), so the streams ever made are as many
    as the workers alive at once, however many runs and executors there
    have been.  ``made`` counts them by device index."""

    def __init__(self):
        self._lock = threading.Lock()
        self._free: dict[int, list[torch.cuda.Stream]] = {}
        self.made: dict[int, int] = {}

    def lease(self, index: int) -> torch.cuda.Stream:
        with self._lock:
            free = self._free.setdefault(index, [])
            if free:
                return free.pop()
            self.made[index] = self.made.get(index, 0) + 1
        return torch.cuda.Stream(device=index)

    def give_back(self, leases: list[tuple[int, torch.cuda.Stream]]) -> None:
        with self._lock:
            for index, stream in leases:
                self._free.setdefault(index, []).append(stream)


WORKER_STREAMS = _StreamPool()


class _Done(tuple):
    """A finished payload's ``(result, seconds)``, carrying the CUDA event
    recorded after it on its worker's stream (None on the CPU), so a
    consumer's stream can wait on it."""

    event: "torch.cuda.Event | None" = None


class RealGraphExecutor:
    """Dependency-ordered execution of op payloads on a worker pool.

    ``op.payload`` is ``fn(dep_results: dict[uid, value]) -> value``.  The
    worker count plays the role of inter-op parallelism; per-op results are
    returned with their timings so the runtime's decisions can be
    validated against real computation.

    ``device`` (default ``"cuda"``; raises without CUDA) decides how a
    payload runs.  On ``"cpu"`` workers are plain threads timed with
    ``perf_counter``, as the reference's.  On CUDA:

    * each worker thread leases one stream per device from
      ``WORKER_STREAMS`` and runs its payloads under
      ``torch.cuda.stream(...)``, so the kernel wrappers, which launch on
      the current stream, land on it;
    * before a payload its stream waits on the event recorded after each
      dep (and on one recorded on the submitting thread's stream, so
      what the caller queued before submitting is done first), and every
      tensor among the dep values is ``record_stream``-ed on it, so the
      caching allocator cannot hand the block to a later allocation of
      the producer's stream while this one still reads it;
    * a payload is timed by a pair of CUDA events on its stream, the start
      recorded after the dep waits; the worker then waits on the end
      event, so each worker holds one op in flight on the device and
      ``max_workers`` bounds the ops that co-run.  ``seconds`` is the
      events' elapsed time, which is what reaches the plan store;
    * the submitting thread's grad and inference modes are carried into
      the worker (a fresh thread has grad on).

    ``run`` returns once the last op's end event completed; its results
    are ``record_stream``-ed on the caller's current stream, so reading
    and freeing them there is safe.  Once its workers are gone (the end of
    a batch ``run``; ``close`` in persistent mode) the executor hands its
    streams back and frees cuBLAS's workspaces: PyTorch keeps one (32 MiB
    on Hopper) for each (handle, stream) pair a GEMM ran on, for the life
    of the process, and counts it in ``memory_allocated``.  So neither
    leaves memory allocated on the card; the next GEMM on a stream
    allocates its workspace again from the cache.  The freeing is
    process-wide (PyTorch has no per-stream call), so ``run`` and
    ``close`` must not race another thread's GEMMs.  ``spans`` maps each
    op of the last ``run`` to its (start, end) in seconds from the run's
    start (on CUDA from an event recorded on the caller's stream), for
    overlap counts.

    Real timings can feed the same closed loop as the simulated
    schedulers: pass ``store``/``plan`` to ``run`` and every payload
    completion is reported through ``PlanStore.observe`` as an
    ``OBS_FINISH`` event at the op's frozen-plan width.

    ``persistent=True`` switches to the service-daemon mode: the worker
    pool outlives any one graph and callers drive it op-by-op with
    ``submit_op`` (the pool's launch decisions pick the order) instead of
    handing over a whole graph.  ``submit_op`` futures wait for their
    dependency futures INSIDE the worker, which keeps ``Future.cancel``
    meaningful: a revoked op that has not reached a worker yet is
    cancelled before any payload runs.  Deadlock-free because payloads
    are only submitted in dependency order (the pool launches an op only
    after its deps completed), so every queued task waits only on
    strictly earlier submissions.

    ``device_for(machine)`` maps the cluster daemon's simulated machines
    onto the CUDA devices round-robin (at most ``n_devices`` of them when
    given).  A payload's exception propagates out of ``run`` and out of
    its ``submit_op`` future; nothing falls back to the CPU."""

    def __init__(self, max_workers: int = 2, *, persistent: bool = False,
                 n_devices: int | None = None,
                 device: str | torch.device = "cuda"):
        self.max_workers = max_workers
        self.n_devices = n_devices
        self.device = resolve_device(device)
        self.spans: dict[int, tuple[float, float]] = {}
        self._local = threading.local()   # a worker's streams by device
        self._leases: list[tuple[int, torch.cuda.Stream]] = []
        self._lease_lock = threading.Lock()
        self._pool: ThreadPoolExecutor | None = (
            ThreadPoolExecutor(max_workers=max_workers)
            if persistent else None)

    # ---- one payload, in a worker thread --------------------------------
    def _stream(self) -> torch.cuda.Stream:
        """The calling worker's stream on the current device."""
        streams = self._local.__dict__.setdefault("streams", {})
        index = torch.cuda.current_device()
        if index not in streams:
            streams[index] = WORKER_STREAMS.lease(index)
            with self._lease_lock:
                self._leases.append((index, streams[index]))
        return streams[index]

    def _release(self) -> None:
        """Once the workers are gone: wait for their streams, hand them
        back and free cuBLAS's per-stream workspaces (class docstring)."""
        with self._lease_lock:
            leases, self._leases = self._leases, []
        if not leases:
            return
        for _, stream in leases:
            stream.synchronize()
        WORKER_STREAMS.give_back(leases)
        torch._C._cuda_clearCublasWorkspaces()

    def _execute(self, op, vals: dict, waits: list, device, modes
                 ) -> tuple[_Done, tuple]:
        """Run ``op``'s payload on ``vals`` under the submitter's
        ``modes`` (grad, inference); returns its ``_Done`` and its
        (start, end): ``perf_counter`` readings on the CPU, events on
        CUDA."""
        grad, inference = modes
        with torch.inference_mode(inference), torch.set_grad_enabled(grad):
            if self.device.type != "cuda":
                ts = time.perf_counter()
                out = op.payload(vals) if op.payload else None
                te = time.perf_counter()
                return _Done((out, te - ts)), (ts, te)
            with torch.cuda.device(device or self.device):
                stream = self._stream()
                for ev in waits:
                    stream.wait_event(ev)
                for t in _tensors(vals):
                    if t.is_cuda:
                        t.record_stream(stream)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                with torch.cuda.stream(stream):
                    start.record(stream)
                    out = op.payload(vals) if op.payload else None
                    end.record(stream)
                end.synchronize()
        done = _Done((out, start.elapsed_time(end) / 1e3))
        done.event = end
        return done, (start, end)

    def _modes(self) -> tuple[bool, bool]:
        return torch.is_grad_enabled(), torch.is_inference_mode_enabled()

    def _caller_event(self) -> list:
        """An event on the calling thread's current stream (none on the
        CPU): payloads submitted now start after what it queued."""
        if self.device.type != "cuda":
            return []
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return [ev]

    # ---- persistent (service-daemon) mode ------------------------------
    def device_for(self, machine: int | None):
        """The device simulated machine ``machine`` maps to: the CUDA
        devices round-robin (at most ``n_devices``), the CPU on the CPU,
        None for no machine."""
        if machine is None:
            return None
        if self.device.type != "cuda":
            return self.device
        count = torch.cuda.device_count()
        if self.n_devices is not None:
            count = max(1, min(count, self.n_devices))
        return torch.device("cuda", machine % count)

    def submit_op(self, op, deps: dict[int, object],
                  device=None) -> Future:
        """Submit one op's payload to the persistent worker set.

        ``deps`` maps dep uid -> either the dep's ``Future`` (resolved
        inside the worker) or an already-materialized value (ops without
        payloads produce ``None`` directly).  ``device`` (from
        ``device_for``) is the device the payload runs on.  Returns a
        future of ``(result, seconds)``."""
        assert self._pool is not None, "submit_op needs persistent=True"
        modes = self._modes()
        base = self._caller_event()

        def call() -> tuple[object, float]:
            vals, waits = {}, list(base)
            for u, f in deps.items():
                if isinstance(f, Future):
                    # dep futures resolve to (value, seconds)
                    done = f.result()
                    vals[u] = done[0]
                    if getattr(done, "event", None) is not None:
                        waits.append(done.event)
                else:
                    vals[u] = f
            return self._execute(op, vals, waits, device, modes)[0]

        return self._pool.submit(call)

    def close(self) -> None:
        """Shut down the persistent worker set: queued work is cancelled,
        running payloads finish (waited for, unlike the reference, so the
        streams can be handed back).  No-op in batch mode."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
            self._release()

    def run(self, graph: OpGraph, *, store: PlanStore | None = None,
            plan: ConcurrencyPlan | None = None
            ) -> tuple[dict[int, object], dict[int, float], float]:
        results: dict[int, object] = {}
        timings: dict[int, float] = {}
        ends: dict[int, object] = {}
        marks: dict[int, tuple] = {}
        pending = {u: len(op.deps) for u, op in graph.ops.items()}
        ready = [u for u, n in pending.items() if n == 0]
        modes = self._modes()
        base = self._caller_event()
        t0 = time.perf_counter()

        def observe(uid: int, dt: float) -> None:
            if store is None:
                return
            report_payload_observation(store, plan, graph.ops[uid], dt)

        try:
            with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
                futures: dict[Future, int] = {}

                def submit(uid: int) -> None:
                    op = graph.ops[uid]
                    deps = {d: results[d] for d in op.deps}
                    waits = base + [ends[d] for d in op.deps
                                    if ends[d] is not None]
                    futures[pool.submit(self._execute, op, deps, waits,
                                        None, modes)] = uid

                for u in ready:
                    submit(u)
                while futures:
                    done, _ = wait(list(futures),
                                   return_when=FIRST_COMPLETED)
                    for fut in done:
                        uid = futures.pop(fut)
                        finished, marks[uid] = fut.result()
                        out, dt = finished
                        ends[uid] = finished.event
                        results[uid] = out
                        timings[uid] = dt
                        observe(uid, dt)
                        for c in graph.consumers(uid):
                            pending[c] -= 1
                            if pending[c] == 0:
                                submit(c)
            wall = time.perf_counter() - t0
        finally:
            self._release()
        if base:
            base[0].synchronize()
            stream = torch.cuda.current_stream()
            for t in _tensors(list(results.values())):
                if t.is_cuda:
                    t.record_stream(stream)
            self.spans = {u: (base[0].elapsed_time(s) / 1e3,
                              base[0].elapsed_time(e) / 1e3)
                          for u, (s, e) in marks.items()}
        else:
            self.spans = {u: (s - t0, e - t0) for u, (s, e) in marks.items()}
        return results, timings, wall
