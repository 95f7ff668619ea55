"""The port's real-payload executor (``repro_torch.core.RealGraphExecutor``)
and the kernel loader it leans on.

On the CPU (``device="cpu"``) the executor is held against
``repro.core.RealGraphExecutor`` on the same graphs (results, timings,
observations reaching the plan store), in persistent mode (deps given as
futures, a cancel before start), with the submitting thread's grad and
inference modes carried into the workers, and on a graph of four
independent olmo-1b smoke prefills (``serving.prefill_payload_graph``)
against ``transformer.prefill``.  Tests marked ``cuda`` skip without a
card: there each worker runs on its own stream, waits on what its inputs
depend on, and is timed by CUDA events.  The file imports no JAX
(``repro.core`` needs none), so the ``cuda`` tests also run where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_runtime.py
"""

import ctypes
import dataclasses
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import CancelledError

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.models import transformer, zoo
from repro_torch.serving import Request, prefill_payload_graph, wave_op_graph

# one prompt a chain, distinct lengths (distinct size keys)
PROMPT_LENS = (16, 12, 8, 4)
SLEEP_CYCLES = 100_000_000     # about 50 ms of the card spinning


def executor(pkg, max_workers=2, **kw):
    if pkg is P:
        kw["device"] = "cpu"
    return pkg.RealGraphExecutor(max_workers=max_workers, **kw)


def two_op_graph(pkg):
    b = pkg.GraphBuilder("real")
    u0 = b.add("X", (32, 16, 16, 64), flops=4e8, bytes_moved=2e6,
               payload=lambda deps: sum(range(1000)))
    b.add("X", (32, 16, 16, 64), flops=4e8, bytes_moved=2e6,
          deps=[u0], payload=lambda deps: deps[u0] + 1)
    return b.build()


def ewma_runtime(pkg, graph):
    rt = pkg.ConcurrencyRuntime(
        machine=pkg.SimMachine(),
        config=pkg.RuntimeConfig(strategy=pkg.StrategyConfig(
            feedback="ewma")))
    rt.profile(graph)
    return rt


# ---------------------------------------------------------------------------
# on the CPU, against the reference executor
# ---------------------------------------------------------------------------

def test_no_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.RealGraphExecutor()


def test_payload_timings_flow_into_store_as_reference():
    out = {}
    for pkg in (R, P):
        graph = two_op_graph(pkg)
        rt = ewma_runtime(pkg, graph)
        results, timings, wall = executor(pkg).run(
            graph, store=rt.planstore, plan=rt.plan)
        assert len(timings) == graph.n_ops and wall > 0
        key = R.perfmodel.cross_graph_key(graph.ops[0])
        assert rt.planstore.corrections.overall.get(key) is not None
        out[pkg] = (results, rt.planstore.corrections.observed)
    assert out[P] == out[R] == ({0: 499500, 1: 499501}, 2)


def test_executor_without_store_as_reference():
    for pkg in (R, P):
        b = pkg.GraphBuilder("real")
        b.add("X", (8, 8), flops=1e6, bytes_moved=1e3,
              payload=lambda deps: 42)
        results, timings, _ = executor(pkg, max_workers=2).run(b.build())
        assert results == {0: 42} and list(timings) == [0]


@pytest.mark.parametrize("pkg", [R, P], ids=["reference", "port"])
def test_persistent_deps_resolve_in_worker_and_cancel_before_start(pkg):
    graph = two_op_graph(pkg)
    ex = executor(pkg, max_workers=1, persistent=True)
    gate, ran = threading.Event(), []
    blocker = dataclasses.replace(
        graph.ops[0], payload=lambda deps: (gate.wait(5), 7)[1])
    consumer = dataclasses.replace(
        graph.ops[1], payload=lambda deps: deps[0] + 1)
    revoked = dataclasses.replace(
        graph.ops[1], uid=2, payload=lambda deps: ran.append("revoked"))
    try:
        f0 = ex.submit_op(blocker, {})
        f1 = ex.submit_op(consumer, {0: f0})
        f2 = ex.submit_op(revoked, {})
        assert f2.cancel(), "a queued op must cancel before it starts"
        gate.set()
        assert f1.result(timeout=10)[0] == 8
        assert f0.result()[0] == 7 and f0.result()[1] >= 0
        with pytest.raises(CancelledError):
            f2.result()
        assert ran == []
    finally:
        gate.set()
        ex.close()


def _grad_probe(deps):
    x = torch.ones(3, requires_grad=True)
    return (x * 2, torch.is_grad_enabled(), torch.is_inference_mode_enabled())


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference_mode"])
def test_grad_mode_carried_into_workers(mode):
    ctx = {"grad": torch.enable_grad, "no_grad": torch.no_grad,
           "inference_mode": torch.inference_mode}[mode]
    b = P.GraphBuilder("modes")
    b.add("X", (1,), payload=_grad_probe)
    graph = b.build()
    ex = P.RealGraphExecutor(max_workers=2, persistent=True, device="cpu")
    try:
        with ctx():
            (out, grad, inference), _ = ex.submit_op(
                graph.ops[0], {}).result()
            results, _, _ = P.RealGraphExecutor(device="cpu").run(graph)
    finally:
        ex.close()
    assert results[0][1:] == (grad, inference)
    assert grad == (mode == "grad")
    assert inference == (mode == "inference_mode")
    assert (out.grad_fn is not None) == (mode == "grad")
    assert (results[0][0].grad_fn is not None) == (mode == "grad")


def test_payload_errors_propagate():
    def boom(deps):
        raise ValueError("payload failed")

    b = P.GraphBuilder("boom")
    u = b.add("X", (1,), payload=lambda deps: 1)
    b.add("X", (2,), deps=[u], payload=boom)
    graph = b.build()
    with pytest.raises(ValueError, match="payload failed"):
        P.RealGraphExecutor(device="cpu").run(graph)
    ex = P.RealGraphExecutor(persistent=True, device="cpu")
    try:
        with pytest.raises(ValueError, match="payload failed"):
            ex.submit_op(graph.ops[1], {u: 1}).result()
    finally:
        ex.close()


def test_device_for_on_the_cpu():
    ex = P.RealGraphExecutor(device="cpu", n_devices=2)
    assert ex.device_for(None) is None
    assert ex.device_for(3) == torch.device("cpu")


# ---------------------------------------------------------------------------
# four olmo-1b smoke prefills as one graph
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def olmo_prefills():
    cfg = dataclasses.replace(get_config("olmo-1b", smoke=True),
                              dtype="float32")
    params = zoo.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in PROMPT_LENS]
    with torch.no_grad():
        refs = [transformer.prefill(cfg, params, torch.as_tensor(
            p, dtype=torch.int64)[None], len(p))[0] for p in prompts]
    return cfg, params, prompts, refs


def chain_sinks(graph) -> list[int]:
    return [u for u in graph.topo_order() if not graph.consumers(u)]


def test_payload_graph_chains_are_wave_op_graphs(olmo_prefills):
    cfg, params, prompts, _ = olmo_prefills
    graph = prefill_payload_graph(cfg, params, prompts)
    per_chain = 2 * cfg.n_layers + 2
    assert graph.n_ops == len(prompts) * per_chain
    fields = ("op_class", "input_shape", "flops", "bytes_moved",
              "working_set", "parallel_fraction", "tunable")
    for i, prompt in enumerate(prompts):
        wave = wave_op_graph(cfg, [Request(rid=i, prompt=prompt,
                                           max_new_tokens=1)])
        assert wave.n_ops == per_chain
        base = i * per_chain
        for u, op in wave.ops.items():
            mine = graph.ops[base + u]
            assert [getattr(mine, f) for f in fields] == \
                [getattr(op, f) for f in fields]
            assert mine.deps == tuple(base + d for d in op.deps)
            assert mine.payload is not None


@pytest.mark.parametrize("workers", [1, 4])
def test_payload_graph_gives_prefill_logits(olmo_prefills, workers):
    cfg, params, prompts, refs = olmo_prefills
    graph = prefill_payload_graph(cfg, params, prompts)
    rt = ewma_runtime(P, graph)
    ex = P.RealGraphExecutor(max_workers=workers, device="cpu")
    with torch.no_grad():
        results, timings, _ = ex.run(graph, store=rt.planstore, plan=rt.plan)
    assert rt.planstore.corrections.observed == graph.n_ops
    assert len(timings) == len(ex.spans) == graph.n_ops
    for u, ref in zip(chain_sinks(graph), refs):
        assert results[u].shape == ref.shape == (1, cfg.padded_vocab)
        err = float((results[u] - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), err


def test_payload_graph_refuses_other_families():
    cfg = get_config("rwkv6-1.6b", smoke=True)
    with pytest.raises(ValueError, match="family"):
        prefill_payload_graph(cfg, {"layers": {}, "embed": {}}, [])


# ---------------------------------------------------------------------------
# the kernel loader, under concurrent first use
# ---------------------------------------------------------------------------

def test_two_threads_build_a_library_once(monkeypatch, tmp_path):
    builds, loads = [], []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            builds.append((threading.get_ident(), cmd))
            self.out = cmd[cmd.index("-o") + 1]
            self.returncode = None

        def communicate(self):
            time.sleep(0.2)          # a window for the other thread
            with open(self.out, "wb") as f:
                f.write(b"lib")
            self.returncode = 0
            return "ptxas info: no spills", None

        def poll(self):
            return self.returncode

    def fake_cdll(path):
        loads.append(path)
        return object()

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "tool", lambda name: name)
    monkeypatch.setattr(subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(ctypes, "CDLL", fake_cdll)
    start = threading.Barrier(2)
    got = []

    def first_use():
        start.wait()
        got.append(_build.library("flash_attention"))

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and len(loads) == 1
    assert got[0] is got[1]
    ident, cmd = builds[0]
    assert f".{ident}.tmp" in cmd[cmd.index("-o") + 1]


def test_launch_counts_from_threads_add_up():
    """More threads than cores and a short switch interval: a lost
    update of ``launches`` would show in the total."""
    def kernel():
        pass

    kernel.launches = 0

    def count():
        for _ in range(5_000):
            _build.count_launch(kernel)

    threads = [threading.Thread(target=count)
               for _ in range(2 * (os.cpu_count() or 4))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert kernel.launches == 5_000 * len(threads)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: streams and events have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_consumer_on_another_stream_reads_the_producers_write(cuda_device):
    def producer(deps):
        t = torch.zeros(1 << 20, device="cuda")
        torch.cuda._sleep(SLEEP_CYCLES)
        t.fill_(1.0)
        return t, torch.cuda.current_stream()

    def consumer(deps):
        t, _ = deps[0]
        return float(t.min()), torch.cuda.current_stream()

    b = P.GraphBuilder("hazard")
    u = b.add("X", (1,), payload=producer)
    b.add("X", (2,), deps=[u], payload=consumer)
    graph = b.build()
    ex = P.RealGraphExecutor(max_workers=2, persistent=True)
    try:
        f0 = ex.submit_op(graph.ops[0], {})
        # queued while the producer runs: the other worker takes it and
        # waits for the producer's future inside
        f1 = ex.submit_op(graph.ops[1], {0: f0})
        value, consumer_stream = f1.result(timeout=60)[0]
    finally:
        ex.close()
    assert consumer_stream != f0.result()[0][1]
    assert value == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("waits", [True, False], ids=["waits", "wait-removed"])
def test_payload_waits_for_the_callers_stream(cuda_device, monkeypatch,
                                              waits):
    """What the caller queued on its stream before ``run`` is done before
    a payload reads it; with ``Stream.wait_event`` taken away, the payload
    reads the stale value (the write is held back behind a sleep)."""
    if not waits:
        monkeypatch.setattr(torch.cuda.Stream, "wait_event",
                            lambda self, event: None)
    t = torch.zeros(1 << 20, device="cuda")
    torch.cuda.synchronize()
    b = P.GraphBuilder("caller")
    b.add("X", (1,), payload=lambda deps: t.clone())
    graph = b.build()
    torch.cuda._sleep(SLEEP_CYCLES)
    t.fill_(1.0)
    results, _, _ = P.RealGraphExecutor(max_workers=1).run(graph)
    assert float(results[0].min()) == (1.0 if waits else 0.0)


@pytest.mark.cuda
def test_event_timing_covers_the_device_work(cuda_device):
    b = P.GraphBuilder("sleep")
    b.add("X", (1,), payload=lambda deps: torch.cuda._sleep(SLEEP_CYCLES))
    ex = P.RealGraphExecutor(max_workers=1)
    _, timings, wall = ex.run(b.build())
    t0 = time.perf_counter()
    torch.cuda._sleep(SLEEP_CYCLES)
    launch = time.perf_counter() - t0
    torch.cuda.synchronize()
    assert timings[0] > 100 * launch and timings[0] > 0.01
    assert wall >= timings[0]
    start, end = ex.spans[0]
    assert end - start == pytest.approx(timings[0], rel=1e-3)


@pytest.mark.cuda
def test_flash_from_a_worker_lands_on_its_stream(cuda_device, monkeypatch):
    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention, ops)

    real_lib = ops._lib
    launched = []

    class Spy:
        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, name):
            return getattr(self.lib, name)

        def repro_flash_attention_fwd(self, *args):
            launched.append(args[-1])          # the stream handle
            return self.lib.repro_flash_attention_fwd(*args)

    monkeypatch.setattr(ops, "_lib", lambda: Spy(real_lib()))
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((1, 256, 4, 128), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))

    def payload(deps):
        return (flash_attention(q, k, v, causal=True),
                torch.cuda.current_stream().cuda_stream)

    b = P.GraphBuilder("flash")
    b.add("X", (1,), payload=payload)
    with torch.no_grad():
        results, _, _ = P.RealGraphExecutor(max_workers=2).run(b.build())
    out, worker_stream = results[0]
    assert launched == [worker_stream]
    assert worker_stream != torch.cuda.current_stream().cuda_stream
    ref = attention_plain(q, k, v, causal=True)
    assert float((out.float() - ref.float()).abs().max()) <= 2e-2


@pytest.mark.cuda
def test_device_for_maps_machines_to_cuda_devices(cuda_device):
    ex = P.RealGraphExecutor()
    count = torch.cuda.device_count()
    assert ex.device_for(None) is None
    for machine in range(5):
        assert ex.device_for(machine) == torch.device("cuda",
                                                      machine % count)
    if count == 1:
        assert ex.device_for(3) == torch.device("cuda", 0)


# ---------------------------------------------------------------------------
# on the card: memory the executor leaves behind, and the daemon
# ---------------------------------------------------------------------------

def matmul_graph(n_ops: int, size: int = 1024):
    """``n_ops`` independent bf16 GEMMs, each a cuBLAS call."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((size, size), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    b = P.GraphBuilder("gemms")
    for i in range(n_ops):
        b.add("X", (i + 1,), payload=lambda deps, a=a: (a @ a).sum())
    return b.build(), a


@pytest.mark.cuda
def test_a_new_stream_gets_a_cublas_workspace(cuda_device):
    """The mechanism the executor guards against: a GEMM on a stream that
    has not run one before leaves a workspace allocated for the life of
    the process, counted in ``memory_allocated``, until PyTorch's
    workspaces are cleared."""
    a = torch.ones((256, 256), device="cuda", dtype=torch.bfloat16)
    (a @ a).sum().item()
    before = torch.cuda.memory_allocated()
    grew = []

    def on_a_new_stream():
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            out = (a @ a).sum()
        stream.synchronize()
        del out
        grew.append(torch.cuda.memory_allocated() - before)

    t = threading.Thread(target=on_a_new_stream)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    print(f"cublas workspace of one new (handle, stream): {grew[0]} bytes")
    assert grew[0] > 0
    torch._C._cuda_clearCublasWorkspaces()
    assert torch.cuda.memory_allocated() <= before


@pytest.mark.cuda
def test_executors_leave_no_memory_allocated(cuda_device):
    graph, a = matmul_graph(8)
    (a @ a).sum().item()
    torch.cuda.synchronize()
    made = dict(P.runtime.WORKER_STREAMS.made)
    before = torch.cuda.memory_allocated()
    readings = []
    for workers in (1, 4, 1, 4, 4):
        ex = P.RealGraphExecutor(max_workers=workers)
        results, _, _ = ex.run(graph)
        assert len(results) == graph.n_ops
        del results
        readings.append(torch.cuda.memory_allocated() - before)
        ex.close()
        readings.append(torch.cuda.memory_allocated() - before)
    new = P.runtime.WORKER_STREAMS.made.get(0, 0) - made.get(0, 0)
    print(f"memory_allocated after each run and close, less before: "
          f"{readings}; worker streams made: {new}")
    assert max(readings) <= 0, readings
    assert new <= 4


@pytest.mark.cuda
def test_persistent_executor_does_not_grow_after_its_workers_start(
        cuda_device):
    graph, a = matmul_graph(1)
    op = graph.ops[0]
    (a @ a).sum().item()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    barrier = threading.Barrier(4)

    def held(deps):
        barrier.wait(timeout=60)        # four ops at once: four workers
        return op.payload(deps)

    first = dataclasses.replace(op, payload=held)
    ex = P.RealGraphExecutor(max_workers=4, persistent=True)
    try:
        futs = [ex.submit_op(first, {}) for _ in range(4)]
        for f in futs:
            f.result(timeout=60)
        del futs
        warm = torch.cuda.memory_allocated()
        for _ in range(46):
            ex.submit_op(op, {}).result(timeout=60)
        assert torch.cuda.memory_allocated() <= warm
    finally:
        ex.close()
    assert torch.cuda.memory_allocated() <= before


def cuda_payload_graph():
    """Two chains of CUDA tensor payloads joined at the end."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    w = torch.randn((512, 512), generator=gen, device="cuda")
    b = P.GraphBuilder("cuda-tensors")
    x = b.add("X", (32, 16, 16, 64), flops=4e8, bytes_moved=2e6,
              payload=lambda deps: torch.tanh(w @ w))
    x2 = b.add("X", (32, 16, 16, 32), flops=2e8, bytes_moved=1e6, deps=[x],
               payload=lambda deps: deps[x] @ w + 1)
    y = b.add("Y", (16, 16, 64), flops=1e8, bytes_moved=1e6,
              payload=lambda deps: w.t() @ w)
    b.add("Z", (8, 8), flops=1e6, bytes_moved=1e4, deps=[x2, y],
          payload=lambda deps: deps[x2] @ deps[y])
    return b.build()


@pytest.mark.cuda
def test_daemon_runs_payloads_on_the_card_as_in_order(cuda_device,
                                                      tmp_path):
    from repro_torch.multitenant import PoolConfig
    from repro_torch.service import ATTACHED_GRAPH, JobSpec, PoolDaemon
    torch.backends.cuda.matmul.allow_tf32 = False
    graph = cuda_payload_graph()
    in_order = {}
    for uid in graph.topo_order():
        op = graph.ops[uid]
        in_order[uid] = op.payload({d: in_order[d] for d in op.deps})
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    d = PoolDaemon(tmp_path, config=PoolConfig(max_active=2),
                   max_workers=4, payload_feedback=True)
    assert d.executor.device == torch.device("cuda")
    d.submit(JobSpec(workload=ATTACHED_GRAPH, name="tensors"), graph=graph)
    d.submit(JobSpec(workload="dcgan"))
    d.drain()
    jid = d.pool.jobs[0].jid
    got = {u: f.result()[0] for u, f in d.observer.futures[jid].items()}
    d.close()
    for u, ref in in_order.items():
        assert got[u].is_cuda
        assert torch.equal(got[u], ref), u
    del got
    d.observer.futures.clear()
    assert torch.cuda.memory_allocated() <= before


@pytest.mark.cuda
def test_a_cancelled_job_launches_nothing_on_the_card(cuda_device,
                                                      tmp_path):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.multitenant import PoolConfig
    from repro_torch.service import ATTACHED_GRAPH, JobSpec, PoolDaemon
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((1, 256, 4, 128), generator=gen, device="cuda",
                    dtype=torch.bfloat16)

    def flash_graph(name):
        b = P.GraphBuilder(name)
        u = b.add("Attn", (1, 256, 4, 128), flops=1e9, bytes_moved=1e6,
                  payload=lambda deps: flash_attention(q, q, q, causal=True))
        b.add("Attn", (1, 256, 4, 64), flops=1e9, bytes_moved=1e6,
              deps=[u], payload=lambda deps: flash_attention(
                  deps[u], q, q, causal=True))
        return b.build()

    d = PoolDaemon(tmp_path, config=PoolConfig(max_active=2),
                   max_workers=2)
    with torch.no_grad():
        flash_attention(q, q, q, causal=True)       # build and load
        flash_attention.launches = 0
        d.submit(JobSpec(workload=ATTACHED_GRAPH, name="kept"),
                 graph=flash_graph("kept"))
        cancelled = d.submit(JobSpec(workload=ATTACHED_GRAPH,
                                     name="cancelled"),
                             graph=flash_graph("cancelled"))
        assert d.cancel(cancelled)
        d.drain()
        for futs in d.observer.futures.values():
            for f in futs.values():
                f.result(timeout=60)
    d.close()
    assert flash_attention.launches == 2
    jids = {j.name: j.jid for j in d.pool.jobs}
    assert jids["cancelled"] not in d.observer.futures
