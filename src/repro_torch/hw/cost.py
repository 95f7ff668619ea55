"""Counting the work of eager PyTorch code: flops by peak class, bytes
moved and the peak of live device memory, on the ``meta`` device or on
real tensors alike.

The port's counterpart of what XLA's ``cost_analysis`` and
``memory_analysis`` (and ``repro.hw.hlo``) give the reference.
``CostCounter`` is a ``TorchDispatchMode``; every aten op dispatched
inside it adds:

* its GEMM flops, by PyTorch's own flop registry (the one
  ``torch.utils.flop_counter.FlopCounterMode`` uses), under the peak class
  of its dtype (``hw.spec.matmul_class``: fp32 GEMMs count as "tfloat32"
  where TF32 is on);
* its bytes: each tensor input read once (a broadcast dimension counts
  once) and each output written once.  Views and allocations move
  nothing; ``copy_``, ``fill_`` and ``zero_`` do not read their target.
  Eager PyTorch fuses nothing, so this is the card's memory traffic less
  what its L2 catches;
* its new storages to the live bytes: each storage is counted from the op
  that creates it until it is freed (``weakref.finalize`` on the storage),
  on top of the storages of the trees passed in (params, optimizer state,
  cache, batch).  ``peak`` is the most that was live at once.

The port's CUDA kernels have no meta implementation: under a counter,
each wrapper given meta tensors returns outputs of the kernel's shapes and
dtypes and adds its ``cost`` (``add_kernel``), and ``layers.attention``
routes meta self-attention to flash as it routes CUDA tensors.  Outside a
counter a meta tensor still raises in the wrappers.

On DTensors the counter counts what ONE rank runs (the rank of the
process group the mesh is built on; the dry-run's fake world is rank 0):
an op on DTensors is left to DTensor (``NotImplemented``), which runs it
on the local tensors, and those local ops are counted as above, the
kernels by their ``cost`` on local shapes.  The ops DTensor's sharding
propagation runs on ``FakeTensor``s of the global shape are run and not
counted.  The live trees passed in count by their local tensors.  Every
collective dispatched inside (DTensor's redistributions, the layers'
explicit reductions) is recorded by ``hw.comm.dispatched_collective``
with the counter's ``pod_size``; ``collective_stats()`` sums them as the
reference's ``parse_collectives`` does.

What the counter cannot see: allocations inside an op's implementation
(a CUDA op's workspace, a composite op's intermediates below the Python
dispatcher), the CUDA caching allocator's rounding, and elementwise flops
(they are bound by bytes, which are counted).
"""

from __future__ import annotations

import threading
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

from repro_torch.hw.comm import (CollectiveOp, CollectiveStats,
                                 dispatched_collective)
from repro_torch.hw.spec import matmul_class

_aten = torch.ops.aten
# ops that allocate and move nothing, besides views
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
         _aten.new_empty_strided, _aten._unsafe_view, _aten.lift_fresh,
         _aten.set_, _aten.resize_}
# ops that write their first argument without reading it
_WRITE_ONLY = {_aten.copy_, _aten.fill_, _aten.zero_}
# ``CostCounter.repeat``'s counts, by key, for every counter
_MEMO: dict = {}
# GEMMs whose global flops a DTensor op gives from its shapes alone
_GEMMS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm}


def tensor_leaves(tree, out: list | None = None) -> list:
    """The tensors in nested tuples, lists and dicts, in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            tensor_leaves(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            tensor_leaves(x, out)
    return out


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor on this rank; any other tensor as it
    is."""
    return t._local_tensor if hasattr(t, "_local_tensor") else t


def addressed_bytes(t: torch.Tensor) -> int:
    """The bytes an op reads of ``t`` once each: a dimension of stride 0
    (a broadcast) counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class CostCounter(TorchDispatchMode):
    """``with CostCounter(state, batch) as c: step(state, batch)``: the
    work of everything dispatched inside, see the module's docstring.

    ``flops``: peak class -> flops (GEMMs and kernels); ``matmul_flops``:
    the GEMMs' share alone; ``kernels``: name -> calls, flops, bytes of
    the port's kernels counted by their ``cost``; ``bytes``: all bytes
    moved; ``live`` and ``peak``: live storage bytes now and at most;
    ``collectives``: the ``CollectiveOp`` of each collective, its group
    crossing blocks of ``pod_size`` ranks or not, and beside it in
    ``collective_groups`` its group's ranks; ``ops``: aten op name
    -> dispatches counted; ``replicated``: each GEMM of DTensors whose
    local share is more than its 1/n of the global GEMM (n the mesh's
    size), as (op, global shapes, local flops, global flops / n): work a
    rank repeats that other ranks also run.  GEMMs that DTensor runs
    are named here at dispatch; those the layers run on local tensors
    with explicit placements name themselves (``note_gemm_share``)."""

    def __init__(self, *live_trees, pod_size: int | None = None):
        super().__init__()
        self.pod_size = pod_size
        self.collectives: list[CollectiveOp] = []
        self.collective_groups: list[tuple[int, ...]] = []
        self.ops: dict[str, int] = defaultdict(int)
        self.replicated: list[tuple] = []
        self._skip = _subclasses_not_counted()
        self._global_gemm = None
        self.flops: dict[str, float] = defaultdict(float)
        self.matmul_flops: dict[str, float] = defaultdict(float)
        self.kernels: dict[str, dict] = {}
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._lock = threading.Lock()
        self._storages: dict[int, weakref.finalize] = {}
        for t in tensor_leaves(live_trees, []):
            self._track(t)

    # ---- live storage -------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        t = local_tensor(t)
        if t.layout != torch.strided:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        with self._lock:
            self.live += n
            self.peak = max(self.peak, self.live)
        self._storages[key] = weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        with self._lock:
            self.live -= n
        self._storages.pop(key, None)

    def __exit__(self, *exc):
        for fin in list(self._storages.values()):
            fin.detach()
        self._storages.clear()
        return super().__exit__(*exc)

    # ---- counting -------------------------------------------------------
    def collective_stats(self) -> CollectiveStats:
        return CollectiveStats(ops=list(self.collectives))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        dtensor, fake = self._skip
        if dtensor is not None and any(issubclass(t, dtensor) for t in types):
            if func._overloadpacket in _GEMMS:
                # the share of the global GEMM its local GEMM should take
                self._global_gemm = (
                    func._overloadpacket,
                    tuple(tuple(t.shape) for t in tensor_leaves(args, [])),
                    float(flop_registry[func._overloadpacket](
                        *args, **(kwargs or {}), out_val=None))
                    / next(t.device_mesh.size() for t in tensor_leaves(
                        args, []) if isinstance(t, dtensor)))
            return NotImplemented        # DTensor runs it on local tensors
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = tensor_leaves(out, [])
        if any(issubclass(t, fake) for t in types) or any(
                isinstance(t, fake) for t in outs):
            return out                   # sharding propagation's fake ops
        coll = dispatched_collective(func, args, kwargs, out, self.pod_size)
        if coll is not None:
            self.collectives.append(coll[0])
            self.collective_groups.append(tuple(coll[1]))
        packet = func._overloadpacket
        self.ops[str(packet)] += 1
        for t in outs:
            self._track(t)
        if packet in flop_registry:
            ins = tensor_leaves(args, [])
            cls = matmul_class(ins[-1].dtype)
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops[cls] += f
            self.matmul_flops[cls] += f
            share = self._global_gemm
            if share is not None and share[0] is packet:
                self._global_gemm = None
                if f > share[2]:
                    self.replicated.append((str(packet), share[1], f,
                                            share[2]))
        if packet in _FREE or _is_view(func):
            return out
        ins = tensor_leaves((args, kwargs), [])
        if packet in _WRITE_ONLY:
            ins = ins[1:]
        self.bytes += sum(addressed_bytes(t) for t in ins) + sum(
            addressed_bytes(t) for t in outs)
        return out

    def add_kernel(self, name: str, *, flops: float, bytes: float,
                   peak_class: str) -> None:
        """One call of the port's kernel ``name``, counted by its cost (the
        wrapper allocated its outputs through the counter)."""
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0,
                                           "peak_class": peak_class})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += bytes
        self.flops[peak_class] += flops
        self.bytes += bytes

    def repeat(self, key, fn):
        """``fn()``, counted once for each ``key``.  A later call with the
        same key does not run ``fn``: it adds the first call's flops,
        bytes and rise of the peak above the live bytes, and returns new
        tensors of its outputs' shapes, dtypes and strides.  For meta work
        only, whose count depends on shapes alone (local work: no
        collective is recorded again): the backward of a
        recurrence's plain per-step loop, the same in every layer, is
        counted once a shape, and once a process (every counter shares the
        memo: a dry-run counts the same layer shapes at two depths and in
        many cells)."""
        key = (key, torch.backends.cuda.matmul.allow_tf32)
        memo = _MEMO.get(key)
        if memo is None:
            flops, matmul, nbytes = (dict(self.flops),
                                     dict(self.matmul_flops), self.bytes)
            outer_peak, start = self.peak, self.live
            self.peak = self.live
            out = fn()
            rise = self.peak - start
            self.peak = max(outer_peak, self.peak)
            layout = [None if t is None else
                      (tuple(t.shape), t.stride(), t.dtype, t.device)
                      for t in out]
            _MEMO[key] = (
                {k: v - flops.get(k, 0.0) for k, v in self.flops.items()},
                {k: v - matmul.get(k, 0.0)
                 for k, v in self.matmul_flops.items()},
                self.bytes - nbytes, rise, layout)
            return out
        flops, matmul, nbytes, rise, layout = memo
        for k, v in flops.items():
            self.flops[k] += v
        for k, v in matmul.items():
            self.matmul_flops[k] += v
        self.bytes += nbytes
        with self._lock:
            self.peak = max(self.peak, self.live + rise)
        return tuple(None if lay is None else torch.empty_strided(
            lay[0], lay[1], dtype=lay[2], device=lay[3]) for lay in layout)


def _subclasses_not_counted() -> tuple:
    """(DTensor or None where torch has no distributed, FakeTensor)."""
    from torch._subclasses.fake_tensor import FakeTensor
    dtensor = None
    if torch.distributed.is_available():
        from torch.distributed.tensor import DTensor as dtensor
    return dtensor, FakeTensor


def current() -> CostCounter | None:
    """The innermost active ``CostCounter``, or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostCounter):
            return mode
    return None


def note_gemm_share(op: str, shapes: tuple, local_flops: float,
                    share: float) -> None:
    """A GEMM of DTensors run on local tensors (``layers.tp_matmul``, the
    MoE block's expert products): under a counter, name it in
    ``replicated`` when the rank's ``local_flops`` exceed its ``share`` of
    the global GEMM ``op`` of ``shapes``."""
    counter = current()
    if counter is not None and local_flops > share:
        counter.replicated.append((op, shapes, local_flops, share))


def counts_meta(t: torch.Tensor) -> bool:
    """Whether ``t`` is a meta tensor under a counter: a kernel wrapper
    then returns meta outputs and adds its cost instead of launching."""
    return t.device.type == "meta" and current() is not None
