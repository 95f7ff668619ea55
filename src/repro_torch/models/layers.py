"""Shared layers: norms, RoPE, attention, MLPs, the MoE block, the RG-LRU
and RWKV6 recurrences.

Port of ``repro.models.layers`` (norms through MLPs, the MoE block, the
RG-LRU functions and the RWKV6 decode step).  Each function keeps the reference's
dtype behaviour: norms and RoPE compute in float32 and cast back,
attention scores accumulate in float32 and the probabilities are cast to
the activation dtype before the PV product; the RG-LRU gates are float32
sigmoids and its carry is float32.

On CUDA, prefill self-attention goes through the hand-written flash
attention kernel and the prefill RG-LRU scan through the hand-written
RG-LRU kernel; everything else runs the dense math below (the MoE block
too: the reference computes it outside any Pallas kernel).  The RWKV6
prefill recurrence goes to the WKV6 kernel from ``models/rwkv6.py``; its
decode step is here.  The kernels are forward-only: where autograd needs
a gradient through one, its backward recomputes the differentiable torch
version of the same function (``kernels._grad.KernelFn``: here
``_attention_torch``, in the recurrences' ``ops.py`` their plain scans), as
the reference differentiates its jnp math.

Sharded activations are DTensors (``torch.distributed.tensor``):
``constrain_batch`` and ``seq_boundary`` pin their batch (and sequence)
dims to mesh axes, as the reference's sharding constraints do.  What
mixes along the sequence (attention, the RG-LRU and WKV6 scans, the
causal conv and the token shift) and the MoE routing run on each rank's
local tensors (``on_ranks``): no kernel takes a DTensor, and a sequence
sharded over ``seq_axes`` is gathered first, as the reference's
constraint before the scan makes GSPMD do.  Decode attention reads a
cache placed by ``serving.kvcache.cache_shardings``: rank by rank where
its heads or rows are sharded, and where its sequence is, as
flash-decoding (a partial softmax on each rank, combined by
all-reduces).  The projections run on local tensors too, with the
placements the reference's plan implies rather than DTensor's choice
(``tp_matmul``: column-parallel q, k, v, gate, up and unembedding,
row-parallel o and down, the FSDP split of each weight gathered), and so
do the MoE block's expert products (``_moe_experts_sharded``) and the
cross-entropy of vocab-split logits (``vocab_parallel_nll``): no rank
repeats a GEMM that the plan splits, and none holds the whole logits.
"""

from __future__ import annotations

import functools
import math
import string
from collections.abc import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.hw.cost import counts_meta, note_gemm_share
from repro_torch.kernels._grad import KernelFn, needs_grad
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rglru import rglru, rglru_plain
from repro_torch.models.common import is_dtensor


def _batch_placements(mesh, shape: tuple, batch_axes: tuple,
                      seq_axes: tuple) -> tuple:
    """One placement a mesh dim: Shard(0) on the batch axes whose ranks
    divide the rows (``launch.mesh.dividing_axes``), Shard(1) on the
    sequence axes (a tensor of 2 dims or more), Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import dividing_axes
    names = tuple(mesh.mesh_dim_names)
    unknown = [a for a in (*batch_axes, *seq_axes) if a not in names]
    if unknown:
        raise ValueError(f"axes {unknown} are not axes of the mesh {names}")
    batch_axes = dividing_axes(shape[0], mesh, tuple(batch_axes))
    ndim = len(shape)
    return tuple(Shard(0) if n in batch_axes
                 else Shard(1) if n in seq_axes and ndim >= 2
                 else Replicate() for n in names)


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with its partial sums reduced (Partial -> Replicate on
    those mesh dims), its other placements kept."""
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in x.placements))


def constrain_batch(x: torch.Tensor, batch_axes: tuple,
                    seq_axes: tuple = ()) -> torch.Tensor:
    """Pin the (batch[, seq]) dims' sharding of a (B,S,...) activation:
    a DTensor ``redistribute`` to Shard(0) on ``batch_axes`` (and Shard(1)
    on ``seq_axes``, sequence parallelism), replicated on its mesh's other
    axes.  A no-op when both are empty (single-device paths) and on a
    plain tensor, which holds the whole activation."""
    if (not batch_axes and not seq_axes) or not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, _batch_placements(
        x.device_mesh, tuple(x.shape), tuple(batch_axes), tuple(seq_axes)))


class _SeqBoundary(torch.autograd.Function):
    """Identity whose forward pins the primal's placement and whose
    backward passes the cotangent on with its sequence gathered (its
    batch split kept): the GEMM behind the boundary flattens (B, S) in
    its backward, which torch 2.11's DTensor refuses with S split."""

    @staticmethod
    def forward(ctx, x, batch_axes, seq_axes):
        ctx.batch_axes, ctx.seq_axes = batch_axes, seq_axes
        return constrain_batch(x, batch_axes, seq_axes)

    @staticmethod
    def backward(ctx, g):
        if ctx.seq_axes:
            g = constrain_batch(g, ctx.batch_axes, ())
        return g, None, None


def seq_boundary(x: torch.Tensor, batch_axes: tuple, seq_axes: tuple
                 ) -> torch.Tensor:
    """Sequence-parallel boundary: constrain the PRIMAL to (batch,
    seq-sharded), and the COTANGENT to the batch split alone: the
    reference's custom VJP leaves it unconstrained (pinning it
    seq-sharded too forces seq-sharded weight-gradient contractions that
    conflict with the tensor-parallel sharding on the same mesh axis),
    which on DTensor leaves it seq-sharded.  A no-op as
    ``constrain_batch``."""
    if (not batch_axes and not seq_axes) or not is_dtensor(x):
        return x
    return _SeqBoundary.apply(x, tuple(batch_axes), tuple(seq_axes))


def _letters_placements(letters: tuple, layout: str) -> tuple:
    """One placement a mesh dim for a tensor of ``layout`` (a letter a
    dim) when mesh dim i splits the dim named ``letters[i]`` (None:
    replicated)."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(layout.index(c)) if c is not None and c in layout
                 else Replicate() for c in letters)


def on_ranks(fn: Callable, args: tuple, layouts: tuple, out_layouts,
             keep: str, **kw):
    """``fn(*args, **kw)`` of DTensors, run on each rank's local tensors.

    ``layouts`` names the dims of each arg with one letter a dim (None
    for an arg that is not a tensor), ``out_layouts`` those of the output
    (a string, or a tuple of strings for a tuple of outputs).  The first
    DTensor arg decides the split: a mesh dim that shards one of its dims
    named in ``keep`` keeps that split, every other mesh dim is gathered
    (Replicate; a ``Partial`` is reduced).  Each arg is redistributed to
    the same split (a plain tensor counts as replicated), ``fn`` runs on
    the local tensors, and each output is wrapped back as a DTensor split
    the same way.  ``keep`` must hold only dims that ``fn`` does not mix.
    An arg that lacks a kept dim is read whole on every rank, so its
    gradient comes back as partial sums on that mesh dim."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    ref = next(i for i, a in enumerate(args) if is_dtensor(a))
    mesh = args[ref].device_mesh
    lay = layouts[ref]
    letters = tuple(lay[p.dim] if isinstance(p, Shard) and lay[p.dim] in keep
                    else None for p in args[ref].placements)
    sizes: dict[str, int] = {}
    local = []
    for a, lay in zip(args, layouts):
        if lay is None or not isinstance(a, torch.Tensor):
            local.append(a)
            continue
        if not is_dtensor(a):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        for c, n in zip(lay, a.shape):
            sizes.setdefault(c, n)
        pl = _letters_placements(letters, lay)
        grad = tuple(Partial() if c is not None and c not in lay else p
                     for c, p in zip(letters, pl))
        local.append(to_local(a, pl, grad))
    outs = fn(*local, **kw)
    single = isinstance(out_layouts, str)
    wrapped = []
    for o, lay in zip((outs,) if single else outs,
                      (out_layouts,) if single else out_layouts):
        missing = [c for c in letters if c is not None and c not in lay]
        if missing:
            raise ValueError(f"on_ranks: output {lay} lacks the split "
                             f"dims {missing}")
        # a split dim keeps its global size, any other is whole here
        shape = tuple(sizes[c] if c in letters else n
                      for c, n in zip(lay, o.shape))
        wrapped.append(_wrap_local(o, mesh, _letters_placements(letters, lay),
                                   shape))
    return wrapped[0] if single else tuple(wrapped)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward hands its cotangent on in the contiguous
    layout."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def to_local(a: torch.Tensor, placements: tuple, grad_placements=None
             ) -> torch.Tensor:
    """This rank's local tensor of DTensor ``a`` redistributed to
    ``placements``; its gradient goes back as a DTensor of
    ``grad_placements`` (default: ``placements``, a ``Partial`` as a
    ``Replicate``).  Where ``a`` already has ``placements`` no
    redistribution is recorded: its backward would reduce a partial
    gradient at once, and a partial one (a column product's input
    gradient) then stays partial, so that the gradients of q, k and v
    (of gate and up) are summed before one reduction, as XLA sums them.

    The gradient is made contiguous on its way back: DTensor runs each
    op on the local tensors but takes the output's global stride from
    its propagation on the global shape, which assumes the contiguous
    layout of its inputs, and later picks a view or a copy for a reshape
    by that global stride alone.  A local gradient in another layout
    breaks that.  With one head a rank, the backward of the attention
    scores' einsum (``_attention_dense``, its bmm) gives k's local
    gradient in (b, d, s) layout; the ``cat`` of RoPE's backward keeps
    it locally while DTensor records the contiguous stride, and the
    reshape of ``split_heads``' backward then views a local tensor that
    cannot be viewed.
    """
    if tuple(a.placements) != tuple(placements):
        a = a.redistribute(a.device_mesh, tuple(placements))
    local = a.to_local(grad_placements=grad_placements)
    return _ContiguousGrad.apply(local)


def _wrap_local(o: torch.Tensor, mesh, placements: tuple, shape: tuple
                ) -> torch.Tensor:
    """The DTensor of global ``shape`` whose local tensor on this rank is
    ``o`` (made contiguous: the global stride given is the contiguous
    one), without a collective."""
    from torch.distributed.tensor import DTensor
    stride, n = [], 1
    for size in reversed(shape):
        stride.insert(0, n)
        n *= size
    return DTensor.from_local(
        o.contiguous(), mesh, tuple(placements), run_check=False,
        shape=torch.Size(shape), stride=tuple(stride))


def _as_dtensor(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` as a DTensor on ``mesh``: a plain tensor counts as
    replicated."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def tp_matmul(x: torch.Tensor, w: torch.Tensor, kind: str, *,
              reduce: bool = True, scatter: bool = False) -> torch.Tensor:
    """``x @ w`` for a projection of (..., K) activations by a (K, N)
    weight, placed as the reference's plan places it, whatever DTensor's
    own propagation would pick.

    ``kind`` names the weight dim that its tensor-parallel split cuts:
    "column" (wq, wk, wv, w_gate, w_up, the unembedding: N) or "row" (wo,
    w_down: K).  A split of the other weight dim is FSDP's and is
    gathered.  Each mesh dim then plays one part:

    * it splits a row dim of ``x`` (the batch, or a sequence): the
      weight is gathered there and each rank takes its rows;
    * it splits the weight's tensor-parallel dim: in a column product
      ``x`` is read whole (a ``Partial`` reduced first) and each rank
      makes its slice of N; in a row product ``x`` comes split along K
      and each rank's product is a partial sum over that mesh dim, which
      is all-reduced, or with ``scatter`` reduce-scattered onto N (each
      rank its slice, for a consumer split so), or with ``reduce=False``
      left ``Partial`` for the caller (the reduce-scatter of
      ``seq_boundary`` under sequence parallelism);
    * it splits neither, where the plan leaves the weight whole over
      it (rwkv6's LoRAs and ``cm_wr``, whose logical axes map to no
      model axis): ``x`` and the weight are whole there and every rank
      repeats the product, as GSPMD would
      (``hw.cost.CostCounter.replicated`` names it).

    The product runs on each rank's local tensors (``to_local``, then
    ``DTensor.from_local``) with the gradient placements the split
    implies, so DTensor's propagation has no say in where the weights
    live.  Plain tensors multiply as they are."""
    if not (is_dtensor(x) or is_dtensor(w)):
        return x @ w
    if kind not in ("column", "row"):
        raise ValueError(f"tp_matmul: kind {kind!r} is not 'column' or "
                         "'row'")
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = (x if is_dtensor(x) else w).device_mesh
    x, w = _as_dtensor(x, mesh), _as_dtensor(w, mesh)
    last = x.ndim - 1
    tp = Shard(1 if kind == "column" else 0)
    rep = Replicate()
    xp, wp, out, xg, wg = [], [], [], [], []
    for a, b in zip(x.placements, w.placements):
        if isinstance(a, Shard) and a.dim != last:           # rows
            parts = (a, rep, a, a, Partial())
        elif b == tp and kind == "column":
            parts = (rep, b, Shard(last), Partial(), b)
        elif b == tp:                                         # row
            parts = (Shard(last), b, Partial(), Shard(last), b)
        else:                                                 # whole
            parts = (rep,) * 5
        for lst, p in zip((xp, wp, out, xg, wg), parts):
            lst.append(p)
    xl = to_local(x, tuple(xp), tuple(xg))
    wl = to_local(w, tuple(wp), tuple(wg))
    k, n = w.shape
    rows = x.numel() // k
    note_gemm_share("aten.mm", ((rows, k), (k, n)),
                    2 * xl.numel() * wl.shape[-1],
                    2 * rows * k * n / mesh.size())
    y = _wrap_local(xl @ wl, mesh, tuple(out), (*x.shape[:-1], n))
    if kind == "column" or not reduce:
        return y
    return y.redistribute(mesh, tuple(
        p if not p.is_partial() else Shard(last) if scatter else rep
        for p in y.placements))


def split_like(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(K, N) weight ``w``, whole where the plan leaves it, with its N
    split as ``like``'s columns where ``like`` splits them and ``w`` is
    replicated (a local slice; the gradient is gathered back): a
    column product by it then makes only the rank's columns, for a
    consumer split as ``like``'s output (rwkv6's ``w_lora_b`` feeds the
    decay of the heads that ``wr`` splits, and GSPMD splits it so).  A
    split that does not divide N, or a plain tensor, leaves it as it
    is."""
    if not (is_dtensor(w) and is_dtensor(like)):
        return w
    from torch.distributed.tensor import Replicate, Shard
    col = Shard(like.ndim - 1)
    pl = tuple(Shard(1) if q == col and p == Replicate() else p
               for p, q in zip(w.placements, like.placements))
    pieces = math.prod(w.device_mesh.size(i) for i, p in enumerate(pl)
                       if p == Shard(1))
    if pl == tuple(w.placements) or w.shape[1] % pieces:
        return w
    return w.redistribute(w.device_mesh, pl)


def vocab_split(logits: torch.Tensor) -> bool:
    """Whether ``logits`` (..., V) is a DTensor with its vocab split."""
    if not is_dtensor(logits):
        return False
    from torch.distributed.tensor import Shard
    return Shard(logits.ndim - 1) in logits.placements


def _all_reduce(t: torch.Tensor, op: str, groups: list) -> torch.Tensor:
    """``t`` all-reduced by ``op`` over each (mesh, mesh dim) of
    ``groups`` in turn."""
    from torch.distributed import _functional_collectives as funcol
    for g in groups:
        t = funcol.wait_tensor(funcol.all_reduce(t, op, g))
    return t


class _LogSumExpOverRanks(torch.autograd.Function):
    """``torch.logsumexp(lf, -1)`` of a row split over ``groups``, from the
    rank's slice ``lf``: the local max, all-reduced (MAX) as a constant
    shift, the local sum of exponentials, all-reduced (SUM), its log plus
    the shift.  The backward is torch's own, ``g * exp(lf - lse)``, on the
    rank's slice: one rank with the whole row gives torch's bits."""

    @staticmethod
    def forward(ctx, lf, groups):
        m = _all_reduce(torch.amax(lf, dim=-1, keepdim=True), "max", groups)
        m = m.masked_fill(m.abs() == math.inf, 0.0)
        se = _all_reduce(torch.exp(lf - m).sum(dim=-1), "sum", groups)
        lse = torch.log(se) + m.squeeze(-1)
        ctx.save_for_backward(lf, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        lf, lse = ctx.saved_tensors
        return g[..., None] * torch.exp(lf - lse[..., None]), None


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (SUM) over ``groups`` of partial sums that every rank
    then uses alike: the cotangent of each rank's part is the cotangent
    of the sum, unchanged."""

    @staticmethod
    def forward(ctx, x, groups):
        return _all_reduce(x, "sum", groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


def vocab_parallel_nll(lf: torch.Tensor, targets: torch.Tensor
                       ) -> torch.Tensor:
    """Next-token NLL (B,S) of fp32 logits ``lf`` (B,S,V), a DTensor with
    its vocab split (``vocab_split``), against int ``targets`` (B,S): the
    reference's ``logsumexp`` minus the one-hot contraction, computed on
    each rank's vocab slice so that no (B,S,V) tensor is whole on a rank.
    The log-sum-exp takes its max and its sum of exponentials over the
    ranks (``_LogSumExpOverRanks``); the true-class logit is the
    contraction with the rank's slice of the one-hot (targets offset by
    the slice's start, a target outside it matching nothing), summed over
    the ranks.  Rows keep the logits' batch (and sequence) split; the
    vocab must split evenly."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = lf.device_mesh
    vdim = lf.ndim - 1
    pl = tuple(Replicate() if p.is_partial() else p for p in lf.placements)
    rows = tuple(Replicate() if p == Shard(vdim) else p for p in pl)
    pieces = math.prod(mesh.size(i) for i, p in enumerate(pl)
                       if p == Shard(vdim))
    if lf.shape[-1] % pieces:
        raise ValueError(f"vocab_parallel_nll: a vocab of {lf.shape[-1]} "
                         f"does not split evenly in {pieces}")
    groups = [(mesh, i) for i, p in enumerate(pl)
              if p == Shard(vdim) and mesh.size(i) > 1]
    local = to_local(lf, pl)
    v = local.shape[-1]
    t = _as_dtensor(targets, mesh).redistribute(mesh, rows).to_local()
    t = t.long() - _split_index(mesh, pl, vdim) * v
    hit = (t >= 0) & (t < v)
    onehot = F.one_hot(torch.where(hit, t, 0), v).to(local.dtype) \
        * hit[..., None]
    true_logit = _SumOverRanks.apply(
        torch.einsum("bsv,bsv->bs", local, onehot), groups)
    nll = _LogSumExpOverRanks.apply(local, groups) - true_logit
    return _wrap_local(nll, mesh, rows, tuple(lf.shape[:-1]))


class _ReducedGrad(torch.autograd.Function):
    """Identity whose backward sums a partial cotangent (Partial ->
    Replicate on those mesh dims) before it goes on."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduce_partial(g) if is_dtensor(g) else g


def gather_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor with ``dim`` whole on every rank (its splits of ``dim``
    and its partial sums made Replicate, other splits kept), e.g. before
    a reshape that splits ``dim`` into pieces a mesh dim does not divide;
    a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dim %= x.ndim
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p == Shard(dim) or p.is_partial() else p
        for p in x.placements))


def _whole_heads(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` (..., n*hd) with its last dim gathered where it is split
    over more pieces than ``n`` heads divide (2 kv heads on a model dim
    of 4, whisper's 12 heads on 16); anything else as it is."""
    if is_dtensor(t):
        from torch.distributed.tensor import Shard
        pieces = math.prod(t.device_mesh.size(i)
                           for i, p in enumerate(t.placements)
                           if p == Shard(t.ndim - 1))
        if n % pieces:
            t = gather_dim(t, -1)
    return t


def _head_group_mesh(mesh, dim: int, groups: int):
    """``mesh`` with mesh dim ``dim`` (n ranks) unflattened into
    ("<name>.heads", "<name>.copies") of (``groups``, n // ``groups``)
    ranks, rank j of the old dim at (j // (n // groups), j % (n //
    groups)): a head group a "heads" rank, repeated over its "copies".
    Built once a (mesh, dim, groups), over the same ranks (every rank
    builds it at the same call, as a ``DeviceMesh`` needs); the new mesh
    names its parent in ``head_group_parent``."""
    cache = mesh.__dict__.setdefault("_head_group_meshes", {})
    if (dim, groups) not in cache:
        from torch.distributed.device_mesh import DeviceMesh
        from torch.utils._python_dispatch import _disable_current_modes
        ranks = mesh.mesh
        shape = (*ranks.shape[:dim], groups, ranks.shape[dim] // groups,
                 *ranks.shape[dim + 1:])
        names = list(mesh.mesh_dim_names)
        names[dim:dim + 1] = [f"{names[dim]}.heads", f"{names[dim]}.copies"]
        with _disable_current_modes():       # not a step's work
            grouped = DeviceMesh(mesh.device_type, ranks.reshape(shape),
                                 mesh_dim_names=tuple(names))
        grouped.head_group_parent = (mesh, dim)
        cache[(dim, groups)] = grouped
    return cache[(dim, groups)]


def _group_heads(t: torch.Tensor, n: int) -> torch.Tensor:
    """A DTensor (..., n*hd) whose last dim one mesh dim of m ranks splits
    where ``n`` heads do not divide m but g = gcd(n, m) > 1 does (whisper's
    12 heads on 16: 4 groups of 3 heads, each on 4 ranks), as a DTensor
    on ``_head_group_mesh``: each rank gathers its group's columns from
    the m // g ranks that share the group (an all-gather over "copies"),
    so that its heads are whole and split over "heads".  Anything else
    as it is (a split over several mesh dims, columns that the ranks do
    not divide, a mesh that does not span the process group)."""
    if not is_dtensor(t):
        return t
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    mesh, last = t.device_mesh, t.ndim - 1
    dims = [i for i, p in enumerate(t.placements) if p == Shard(last)]
    if len(dims) != 1 or any(p.is_partial() for p in t.placements):
        return t
    i = dims[0]
    m = mesh.size(i)
    g = math.gcd(n, m)
    if n % m == 0 or g == 1 or t.shape[-1] % m \
            or mesh.mesh.numel() != dist.get_world_size():
        return t
    grouped = _head_group_mesh(mesh, i, g)
    split = list(t.placements)
    split[i:i + 1] = [Shard(last), Shard(last)]
    local = _wrap_local(to_local(t, tuple(t.placements)), grouped,
                        tuple(split), tuple(t.shape))
    split[i + 1] = Replicate()
    return local.redistribute(grouped, tuple(split))


def _ungroup(t: torch.Tensor) -> torch.Tensor:
    """(..., n*hd) on a ``_head_group_mesh`` back on its parent mesh, its
    columns split over the parent dim as they came: each rank keeps its
    own columns of its group's (a local slice; the gradient gathers them
    over "copies").  Anything else as it is."""
    if not is_dtensor(t) or not hasattr(t.device_mesh, "head_group_parent"):
        return t
    from torch.distributed.tensor import Shard
    parent, i = t.device_mesh.head_group_parent
    pl = list(t.placements)
    pl[i + 1] = Shard(t.ndim - 1)
    local = to_local(t, tuple(pl))
    del pl[i + 1]
    return _wrap_local(local, parent, tuple(pl), tuple(t.shape))


def _on_mesh(t: torch.Tensor, grouped) -> torch.Tensor:
    """DTensor (or plain) ``t`` of the parent mesh of ``grouped`` as a
    DTensor on ``grouped``: the parent dim's placement on both of its
    dims, the local tensor as it is."""
    if not is_dtensor(t):
        return _as_dtensor(t, grouped)
    if t.device_mesh is grouped:
        return t
    i = grouped.head_group_parent[1]
    pl = list(t.placements)
    pl[i:i + 1] = [pl[i], pl[i]]
    return _wrap_local(to_local(t, tuple(t.placements)), grouped, tuple(pl),
                       tuple(t.shape))


def split_heads(t: torch.Tensor, n: int, hd: int, *,
                group: bool = False) -> torch.Tensor:
    """(..., n*hd) -> (..., n, hd).  A DTensor whose last dim is split
    over more pieces than ``n`` heads divide (2 kv heads on a model dim
    of 4) is gathered on that dim first, as GSPMD reshards the
    reference's reshape; with ``group`` (the q heads of a self- or
    cross-attention) and a common divisor of the heads and the pieces,
    only the rank's head group is gathered (``_group_heads``), and the
    heads are split over the groups as GSPMD splits them."""
    if group:
        t = _group_heads(t, n)
    t = _whole_heads(t, n)
    return t.reshape(*t.shape[:-1], n, hd)


def merge_heads(o: torch.Tensor) -> torch.Tensor:
    """(..., n, hd) -> (..., n*hd), ``split_heads``' inverse.  Heads split
    in groups come back to the parent mesh with each rank's columns of
    its group, the split of the row-parallel ``wo`` after them."""
    n, hd = o.shape[-2:]
    return _ungroup(o.reshape(*o.shape[:-2], n * hd))


def embed_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of ``table``, read by ``F.embedding``.  A sharded
    table's (DTensor shards its backward as the table) partial rows, where
    the vocab is split, are summed at once, so that a remat recompute
    reads a plain placement; the cotangent coming back is summed first
    where it is partial (an expert-sharded MoE block leaves it so), since
    the masked partial's backward takes no other partial.  A plain table
    goes through ``F.embedding`` too: indexing's backward (``index_put``
    with accumulation) sums a repeated id's gradients in another order,
    and a placed table would then get other bits than a plain one."""
    if is_dtensor(table):
        return _ReducedGrad.apply(reduce_partial(F.embedding(ids, table)))
    return F.embedding(ids, table)


def cache_write(dst: torch.Tensor, index: tuple, value: torch.Tensor
                ) -> None:
    """``dst[index] = value`` in place, ``index`` a tuple of ints over
    ``dst``'s leading dims.  On a DTensor (a cache placed by
    ``cache_shardings``) only the ranks that hold the indexed row write
    it, into their local tensor at the local index, with ``value``
    redistributed to the row's placements.  Mesh dims that split the same
    dim nest in mesh order, as DTensor splits them: each splits the chunk
    the ones before it left (``_split_index``)."""
    if not is_dtensor(dst):
        dst[index] = value
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = dst.device_mesh
    local_index = list(index)
    length = list(dst.shape)
    owner = True
    row = []
    for i, p in enumerate(dst.placements):
        if isinstance(p, Shard) and p.dim < len(index):
            chunk = -(-length[p.dim] // mesh.size(i))
            r = local_index[p.dim] // chunk
            owner &= r == mesh.get_local_rank(i)
            local_index[p.dim] -= r * chunk
            length[p.dim] = max(0, min(chunk, length[p.dim] - r * chunk))
            row.append(Replicate())
        elif isinstance(p, Shard):
            row.append(Shard(p.dim - len(index)))
        else:
            row.append(p)
    if not is_dtensor(value):
        value = DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    # every rank redistributes (a collective may run), the owners write
    value = value.redistribute(mesh, tuple(row)).to_local()
    if owner:
        dst.to_local()[tuple(local_index)] = value


def pad_dim(x: torch.Tensor, dim: int, length: int) -> torch.Tensor:
    """``x`` zero-padded at the end of ``dim`` to ``length`` (a prefill's
    cache to ``max_len``).  A DTensor pads on each rank's local tensor,
    ``dim`` gathered and every other split kept."""
    pad = [0, 0] * (x.ndim - 1 - dim) + [0, length - x.shape[dim]]
    if not is_dtensor(x):
        return F.pad(x, pad)
    lay = string.ascii_lowercase[:x.ndim]
    return on_ranks(F.pad, (x, pad), (lay, None), lay,
                    keep=lay.replace(lay[dim], ""))


def maybe_remat(body: Callable, remat: str) -> Callable:
    """``body`` under per-layer activation checkpointing when ``remat`` is
    "full" (the reference's ``maybe_remat`` around each scan body): its
    activations are recomputed in the backward, not kept."""
    if remat == "full":
        return functools.partial(checkpoint, body, use_reentrant=False)
    return body


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor | None, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    if scale is not None:
        y = y * (1.0 + scale.float())
    return y.to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor | None,
               bias: torch.Tensor | None, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


def nonparam_layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm (no scale/bias)."""
    return layer_norm(x, None, None, eps)


def apply_norm(kind: str, x: torch.Tensor, p: dict | None) -> torch.Tensor:
    if kind == "rms":
        return rms_norm(x, p["scale"] if p else None)
    if kind == "layernorm":
        return layer_norm(x, p["scale"] if p else None,
                          p.get("bias") if p else None)
    if kind == "nonparam":
        return nonparam_layer_norm(x)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# RoPE (split halves, float32)
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> cos/sin (..., S, head_dim//2), float32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., S, H, D). cos/sin: (..., S, D/2) broadcast over heads."""
    dt = x.dtype
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(dt)


# ---------------------------------------------------------------------------
# Attention (GQA, causal, sliding window)
# ---------------------------------------------------------------------------

def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B,S,K,D) -> (B,S,K*n_rep,D)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _attention_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool, window: int | None, q_offset: int,
                     softcap: float) -> torch.Tensor:
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    k = repeat_kv(k, h // kh)
    v = repeat_kv(v, h // kh)
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    logits = torch.where(mask[None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# above this many score elements per (B,H) pair, the dense path runs in
# q-chunks so the (B,H,Sq,Sk) transient stays bounded (as the reference)
_CHUNK_THRESHOLD = 1 << 26
_Q_CHUNK = 1024

SelfAttention = Callable[..., torch.Tensor]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              q_offset: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """q: (B,Sq,H,D), k/v: (B,Sk,K,D) with H % K == 0.  Returns (B,Sq,H,D).

    On CUDA, self-attention (Sq == Sk, ``q_offset`` 0, no softcap) runs
    the flash attention kernel, through ``KernelFn`` (backward: the dense
    math's) where autograd needs its gradient; so does a meta tensor under
    a ``hw.cost.CostCounter``, so that the dry-run counts the card's
    path.  Everything else runs the dense math, in q-chunks above
    ``_CHUNK_THRESHOLD`` score elements.  DTensors go rank by rank
    (``_attention_sharded``) through the same choice on their local
    tensors."""
    sq, sk = q.shape[1], k.shape[1]
    if is_dtensor(q):
        return _attention_sharded(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset, softcap=softcap)
    if (q.is_cuda or counts_meta(q)) and sq == sk and q_offset == 0 \
            and not softcap:
        if needs_grad(q, k, v):
            return KernelFn.apply(flash_attention, _attention_torch,
                                  {"causal": causal, "window": window},
                                  q, k, v)
        return flash_attention(q, k, v, causal=causal, window=window)
    return _attention_torch(q, k, v, causal=causal, window=window,
                            q_offset=q_offset, softcap=softcap)


def _split_index(mesh, placements: tuple, dim: int) -> int:
    """Which of the ``prod(n)`` equal chunks of ``dim`` this rank holds
    under ``placements`` (the mesh dims that shard ``dim`` nest in mesh
    order, the first the major one, as DTensor splits)."""
    from torch.distributed.tensor import Shard
    idx = 0
    for i, p in enumerate(placements):
        if p == Shard(dim):
            idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx


def _attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       **kw) -> torch.Tensor:
    """Attention of DTensors, rank by rank: ``attention`` on each rank's
    own batch rows and heads, so a rank computes what one card computes
    (on CUDA the flash kernel forward and the dense math's backward).
    q keeps its Shard(0) and Shard(2) (heads dividing the mesh dim), k
    and v take the same where their kv heads divide too; where they do
    not (fewer kv heads than ranks, as MQA), k and v are read whole and
    each rank takes the kv heads its q heads use.  Attention mixes
    neither rows nor heads, so nothing else is exchanged.  q heads that
    a mesh dim does not divide come split in groups
    (``split_heads(group=True)``: whisper's 12 heads on 16 ranks, 4
    groups of 3) on a ``_head_group_mesh``, k and v are put on that mesh
    as they are, and each rank runs its group's heads: only the ranks
    that share a group repeat its attention, as GSPMD splits the
    reference's heads by their greatest common divisor with the mesh
    dim.  Where none divides (an odd head count on an even dim), every
    rank repeats the whole.  Repeats are named in
    ``hw.cost.CostCounter.replicated``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = q.device_mesh
    if hasattr(mesh, "head_group_parent"):
        k, v = _on_mesh(k, mesh), _on_mesh(v, mesh)
    h, kh = q.shape[2], k.shape[2]
    qp, kp = [], []
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        if p == Shard(0):
            qp.append(p)
            kp.append(p)
        elif p == Shard(2) and h % n == 0:
            qp.append(p)
            kp.append(p if kh % n == 0 else Replicate())
        else:
            qp.append(Replicate())
            kp.append(Replicate())
    whole_kv = any(a == Shard(2) and b != Shard(2) for a, b in zip(qp, kp))
    if whole_kv:
        kp = [Replicate() if b == Shard(2) else b for b in kp]
    grad = tuple(Partial() if a == Shard(2) and b != Shard(2) else b
                 for a, b in zip(qp, kp))
    ql = to_local(q, tuple(qp))
    kl, vl = (to_local(t if is_dtensor(t) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False), tuple(kp), grad)
        for t in (k, v))
    if whole_kv:
        hl = ql.shape[2]
        h0 = _split_index(mesh, tuple(qp), 2) * hl
        rep = h // kh
        if hl % rep and rep % hl:
            # the rank's q heads straddle kv groups unevenly (H=12, K=3
            # on 2 ranks): a kv head for each q head
            kl, vl = (repeat_kv(t, rep)[:, :, h0:h0 + hl] for t in (kl, vl))
        else:
            first, last = h0 // rep, (h0 + hl - 1) // rep
            kl, vl = kl[:, :, first:last + 1], vl[:, :, first:last + 1]
    note_gemm_share("attention", (tuple(q.shape), tuple(k.shape)),
                    4 * ql.numel() * k.shape[1],
                    4 * q.numel() * k.shape[1] / mesh.size())
    o = attention(ql, kl, vl, **kw)
    return _wrap_local(o, mesh, qp, (*q.shape[:3], v.shape[3]))


def _attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool, window: int | None, q_offset: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """The dense math, in q-chunks above ``_CHUNK_THRESHOLD`` score
    elements."""
    sq, sk = q.shape[1], k.shape[1]
    if sq * sk < _CHUNK_THRESHOLD or sq <= _Q_CHUNK or sq % _Q_CHUNK:
        return _attention_dense(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, softcap=softcap)
    outs = [_attention_dense(q[:, st:st + _Q_CHUNK], k, v, causal=causal,
                             window=window, q_offset=q_offset + st,
                             softcap=softcap)
            for st in range(0, sq, _Q_CHUNK)]
    return torch.cat(outs, dim=1)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    softcap: float = 0.0) -> torch.Tensor:
    """Unmasked attention of q (B,Sq,H,D) over k/v (B,Sk,K,D), as the
    reference's: ``attention`` with ``causal=False`` (the dense math where
    Sq != Sk).  On DTensors it runs rank by rank as self-attention does
    (``_attention_sharded``), the frontend's or encoder's k/v split as
    q is; a plain k/v (an unsharded frontend) counts as replicated."""
    return attention(q, k, v, causal=False, window=None, softcap=softcap)


def _decode_logits(q: torch.Tensor, k_cache: torch.Tensor, cache_len,
                   window: int | None, offset: int = 0) -> torch.Tensor:
    """The masked fp32 scores (B,H,1,S) of q against a cache slice whose
    first position is ``offset``."""
    b, s, kh, d = k_cache.shape
    h = q.shape[2]
    kq = repeat_kv(k_cache, h // kh)
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kq.float()) * scale
    kpos = torch.arange(s, device=q.device)[None, None, None, :]
    if offset:
        kpos = kpos + offset
    n = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1, 1, 1)
    valid = kpos < n
    if window is not None:
        valid &= kpos >= n - window
    return torch.where(valid, logits, -1e30)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     window: int | None = None) -> torch.Tensor:
    """Single-token decode: q (B,1,H,D), caches (B,S,K,D) with valid
    prefix ``cache_len``.  Position of q is cache_len-1 (the newest token
    is already written into the cache).  A DTensor cache (placed by
    ``serving.kvcache.cache_shardings``) goes to ``_decode_sharded``."""
    if is_dtensor(k_cache):
        return _decode_sharded(q, k_cache, v_cache, cache_len, window)
    h, kh = q.shape[2], k_cache.shape[2]
    logits = _decode_logits(q, k_cache, cache_len, window)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, repeat_kv(v_cache, h // kh))


def _decode_sharded(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, cache_len,
                    window: int | None) -> torch.Tensor:
    """``decode_attention`` on a placed cache, rank by rank.  q takes the
    cache's split of rows (Shard(0)) and kv heads (Shard(2), the
    head-sharded policy); a mesh dim that splits the cache's sequence
    (Shard(1), the sequence-sharded policy) leaves q whole and runs
    flash-decoding: an all-reduce over that mesh dim takes the max of the
    ranks' scores, each rank sums the exponentials and the
    exponential-weighted v of its own positions against that max, and a
    second all-reduce adds them up (a mesh dim of size 1 holds every
    position and needs neither).  A replicated cache runs
    ``decode_attention``'s own math on every rank."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = k_cache.device_mesh
    rows = [is_dtensor(q) and q.placements[i] == Shard(0)
            for i in range(mesh.ndim)]
    qp, kp, seq_dims = [], [], []
    for i, p in enumerate(k_cache.placements):
        if p in (Shard(0), Shard(2)):
            qp.append(p)
            kp.append(p)
        elif p == Shard(1) and mesh.size(i) == 1:
            qp.append(Replicate())       # one rank holds every position
            kp.append(p)
        elif p == Shard(1):
            qp.append(Replicate())
            kp.append(p)
            seq_dims.append(i)
        else:                   # replicated, or a split of the head dim
            qp.append(Replicate())
            kp.append(Replicate())
    if not is_dtensor(q):
        q = DTensor.from_local(q, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    ql = q.redistribute(mesh, tuple(qp)).to_local()
    kl = k_cache.redistribute(mesh, tuple(kp)).to_local()
    vl = v_cache.redistribute(mesh, tuple(kp)).to_local()
    if not seq_dims:
        o = decode_attention(ql, kl, vl, cache_len, window=window)
    else:
        s_loc = kl.shape[1]
        if s_loc * math.prod(mesh.size(i) for i in seq_dims) != \
                k_cache.shape[1]:
            raise ValueError(f"decode: a cache of {k_cache.shape[1]} "
                             "positions does not split evenly over "
                             f"mesh dims {seq_dims}")
        offset = _split_index(mesh, tuple(kp), 1) * s_loc
        logits = _decode_logits(ql, kl, cache_len, window, offset)
        m = logits.amax(dim=-1, keepdim=True)                   # (B,H,1,1)
        for i in seq_dims:
            m = funcol.all_reduce(m, "max", (mesh, i))
        e = torch.exp(logits - m)
        h, kh = ql.shape[2], kl.shape[2]
        o_part = torch.einsum("bhqk,bkhd->bqhd", e,
                              repeat_kv(vl, h // kh).float())
        b, _, hh, d = o_part.shape
        packed = torch.cat([o_part.reshape(b, hh * d),
                            e.sum(dim=-1).reshape(b, hh)], dim=1)
        for i in seq_dims:
            packed = funcol.all_reduce(packed, "sum", (mesh, i))
        o_sum = packed[:, :hh * d].reshape(b, 1, hh, d)
        l_sum = packed[:, hh * d:].reshape(b, 1, hh, 1)
        o = (o_sum / l_sum).to(ql.dtype)
    o = _wrap_local(o, mesh, qp, (*q.shape[:3], v_cache.shape[3]))
    # the rows go back to q's split where the cache split them otherwise
    # (vlm's cross cache carries the batch axis on its sequence and the
    # model axis on its rows), as the reference splits them: wo then
    # runs on the rank's rows and its columns, repeated nowhere
    back = tuple(Shard(0) if r else Replicate() if p == Shard(0) else p
                 for r, p in zip(rows, o.placements))
    if not any(rows) or back == tuple(o.placements):
        return o
    return o.redistribute(mesh, back)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_swiglu(p: dict, x: torch.Tensor, *, reduce: bool = True
               ) -> torch.Tensor:
    """SwiGLU MLP: gate and up column-parallel, down row-parallel
    (``tp_matmul``; ``reduce=False`` leaves a sharded output's partial
    sum to the caller)."""
    dt = x.dtype
    gate = tp_matmul(x, p["w_gate"].to(dt), "column")
    up = tp_matmul(x, p["w_up"].to(dt), "column")
    act = F.silu(gate.float()).to(dt) * up
    return tp_matmul(act, p["w_down"].to(dt), "row", reduce=reduce)


def mlp_gelu(p: dict, x: torch.Tensor, *, reduce: bool = True
             ) -> torch.Tensor:
    """GELU MLP, placed as ``mlp_swiglu``; with a down bias the partial sum
    is reduced before the bias is added."""
    dt = x.dtype
    h = tp_matmul(x, p["w_up"].to(dt), "column")
    if "b_up" in p:
        h = h + p["b_up"].to(dt)
    h = F.gelu(h.float(), approximate="tanh").to(dt)
    out = tp_matmul(h, p["w_down"].to(dt), "row",
                    reduce=reduce or "b_down" in p)
    if "b_down" in p:
        out = out + p["b_down"].to(dt)
    return out


def apply_mlp(kind: str, p: dict, x: torch.Tensor, *, reduce: bool = True
              ) -> torch.Tensor:
    mlp = mlp_swiglu if kind == "swiglu" else mlp_gelu
    return mlp(p, x, reduce=reduce)


# ---------------------------------------------------------------------------
# MoE (GShard-style capacity dispatch; top-1 and top-2)
# ---------------------------------------------------------------------------

# dispatch-group size: a longer sequence is split into groups of this many
# tokens (the reference's 4096), so capacity does not grow with S
MOE_GROUP = 4096


def moe_capacity(s: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Slots per expert in a group of ``s`` tokens: ceil(int(f*S*k) / E),
    at least 4 and at most ``s`` (so 1 at decode)."""
    capacity = max(4, -(-int(capacity_factor * s * top_k) // n_experts))
    return min(capacity, s)


def moe_route(p: dict, x: torch.Tensor, top_k: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router's fp32 softmax probs (B,S,E) and its top-k gate values
    and expert indices (B,S,k).  A stable descending sort breaks ties by
    the lower index, as ``lax.top_k`` does (``torch.topk`` does not); the
    gate values keep the gradient of the probs they were taken from."""
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, vals[..., :top_k], idx[..., :top_k]


def moe_block(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> (out, aux_loss).  Experts stacked on dim 0 of
    p['w_gate'|'w_up'|'w_down']: (E, D, F) / (E, F, D); p['router'] (D, E)
    read in fp32.

    The reference's GShard GROUPED dispatch: each batch row (or each
    ``MOE_GROUP``-token piece of a longer one) is a group with its own
    capacity, and dense one-hot dispatch/combine tensors (B, S, E, C) move
    tokens to the experts' buffers.  A token's slot-j route goes to the
    expert's next buffer position after every earlier route to that
    expert (all of slot j-1's, kept or dropped); a route at or past
    capacity is dropped and the token keeps only its residual there.  Aux
    is the Switch load-balancing loss of slot 0, in fp32.

    On DTensors the routing (``_moe_routing``: the sort, one-hots and
    position ``cumsum`` of a group) runs on each rank's own rows
    (``on_ranks``), and the expert products on each rank's local tensors
    (``_moe_experts_sharded``): its rows, and its experts (expert
    parallelism) or its slice of each expert's FFN (the plan's fallback,
    ``rules["expert"] = ()``), the output a partial sum over the mesh dims
    that split experts or FFN, all-reduced.  Aux is the mean over the
    global batch, as the reference's sharded step computes it."""
    b, s, d = x.shape
    dt = x.dtype
    if s > MOE_GROUP:
        if s % MOE_GROUP:
            raise ValueError(f"moe_block: S={s} above {MOE_GROUP} must be a "
                             f"multiple of it")
        out, aux = moe_block(p, x.reshape(b * (s // MOE_GROUP), MOE_GROUP, d),
                             n_experts=n_experts, top_k=top_k,
                             capacity_factor=capacity_factor)
        return out.reshape(b, s, d), aux
    route = functools.partial(
        _moe_routing, n_experts=n_experts, top_k=top_k,
        capacity=moe_capacity(s, n_experts, top_k, capacity_factor))
    if not is_dtensor(x):
        combine, dispatch, aux_rows = route(x, p["router"])
        aux = n_experts * torch.mean(aux_rows)
        return _moe_experts(p["w_gate"], p["w_up"], p["w_down"], x,
                            dispatch, combine), aux
    combine, dispatch, aux_rows = on_ranks(
        route, (x, p["router"]), ("bsd", "de"), ("bsec", "bsec", "b"),
        keep="b")
    aux = n_experts * torch.mean(aux_rows)
    return reduce_partial(_moe_experts_sharded(p, x, dispatch, combine)), aux


def _moe_experts(w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor, x: torch.Tensor,
                 dispatch: torch.Tensor, combine: torch.Tensor
                 ) -> torch.Tensor:
    """The experts' SwiGLU on their capacity buffers and the combine back
    to the tokens: (B,S,D) out of x (B,S,D), dispatch/combine (B,S,E,C)
    and stacked weights (E,D,F)/(E,F,D)."""
    dt = x.dtype
    expert_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(dt), x)
    gate = torch.einsum("ebcd,edf->ebcf", expert_in, w_gate.to(dt))
    up = torch.einsum("ebcd,edf->ebcf", expert_in, w_up.to(dt))
    act = F.silu(gate.float()).to(dt) * up
    expert_out = torch.einsum("ebcf,efd->ebcd", act, w_down.to(dt))
    return torch.einsum("bsec,ebcd->bsd", combine.to(dt), expert_out)


def _moe_experts_sharded(p: dict, x: torch.Tensor, dispatch: torch.Tensor,
                         combine: torch.Tensor) -> torch.Tensor:
    """``_moe_experts`` of DTensors on each rank's local tensors.  Each mesh
    dim plays one part: it splits x's rows (the weights are gathered
    there, FSDP), or the experts (x read whole, the rank's slice of the
    dispatch and combine taken on their E dim), or each expert's FFN
    (x, dispatch and combine whole, gate and up split on F, down on its F
    rows), or nothing (every rank repeats the products, named in
    ``hw.cost.CostCounter.replicated``).  The output is the rank's rows,
    a ``Partial`` over the expert and FFN dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    ws = [_as_dtensor(p[k], mesh) for k in ("w_gate", "w_up", "w_down")]
    rep = Replicate()
    # per tensor (x, dispatch, combine, gate/up, down, out): placement,
    # and gradient placement
    pl = [[] for _ in range(6)]
    gr = [[] for _ in range(6)]
    for a, b in zip(x.placements, ws[0].placements):
        if isinstance(a, Shard) and a.dim == 0:                   # rows
            parts = ((a, a), (a, a), (a, a), (rep, Partial()),
                     (rep, Partial()), (a, a))
        elif b == Shard(0):                                       # experts
            parts = ((rep, Partial()), (Shard(2),) * 2, (Shard(2),) * 2,
                     (b, b), (b, b), (Partial(), Partial()))
        elif b == Shard(2):                                       # FFN
            parts = ((rep, Partial()), (rep, rep), (rep, Partial()),
                     (b, b), (Shard(1),) * 2, (Partial(), Partial()))
        else:                                                     # whole
            parts = ((rep, rep),) * 6
        for i, (q, g) in enumerate(parts):
            pl[i].append(q)
            gr[i].append(g)
    pl, gr = [tuple(t) for t in pl], [tuple(t) for t in gr]
    xl = to_local(x, pl[0], gr[0])
    dl = dispatch.redistribute(mesh, pl[1]).to_local()
    cl = to_local(combine, pl[2], gr[2])
    wl = [to_local(w, pl[3 if i < 2 else 4], gr[3 if i < 2 else 4])
          for i, w in enumerate(ws)]
    d, f = ws[0].shape[1:]
    sizes = [dict(zip("bsecdf", (*t.shape, d, ff)))
             for t, ff in ((dispatch, f), (dl, wl[0].shape[2]))]
    for eq in ("bsec,bsd->ebcd", "ebcd,edf->ebcf", "ebcd,edf->ebcf",
               "ebcf,efd->ebcd", "bsec,ebcd->bsd"):
        whole, mine = (2 * math.prod(n[c] for c in set(eq) - set(",->"))
                       for n in sizes)
        note_gemm_share(f"einsum {eq}", tuple(
            tuple(sizes[0][c] for c in term)
            for term in eq.split("->")[0].split(",")), mine,
            whole / mesh.size())
    out = _moe_experts(*wl, xl, dl, cl)
    return _wrap_local(out, mesh, pl[5], tuple(x.shape))


def _moe_routing(x: torch.Tensor, router: torch.Tensor, *, n_experts: int,
                 top_k: int, capacity: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One group a row: the fp32 combine weights and the boolean dispatch
    (B,S,E,C), and each row's load-balancing term (B,) (the sum over
    experts of mean prob times slot-0 load), of ``moe_block``."""
    b, s, _ = x.shape
    probs, gate_vals, gate_idx = moe_route({"router": router}, x, top_k)
    me = probs.mean(dim=1)                                         # (B,E)
    ce = F.one_hot(gate_idx[..., 0], n_experts).float().mean(dim=1)
    aux_rows = torch.sum(me * ce, dim=-1)

    slots = torch.arange(capacity, device=x.device)
    combine = torch.zeros((b, s, n_experts, capacity), dtype=torch.float32,
                          device=x.device)
    dispatch = torch.zeros((b, s, n_experts, capacity), dtype=torch.bool,
                           device=x.device)
    occupancy = torch.zeros((b, n_experts), dtype=torch.long,
                            device=x.device)
    for slot in range(top_k):
        onehot = F.one_hot(gate_idx[..., slot], n_experts)        # (B,S,E)
        pos = torch.cumsum(onehot, dim=1) - 1 + occupancy[:, None, :]
        pos = torch.where(onehot > 0, pos, -1)
        occupancy = occupancy + onehot.sum(dim=1)
        # a kept route's buffer position; -1 and positions past capacity
        # match no slot
        oh_cap = pos[..., None] == slots                          # (B,S,E,C)
        combine = combine + oh_cap * gate_vals[..., slot, None, None]
        dispatch |= oh_cap
    return combine, dispatch, aux_rows


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma)
# ---------------------------------------------------------------------------

RglruScan = Callable[[torch.Tensor, torch.Tensor],
                    tuple[torch.Tensor, torch.Tensor]]


def rglru_scan(a: torch.Tensor, x: torch.Tensor,
               h0: torch.Tensor | None = None, *,
               scan: RglruScan | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + sqrt(1-a_t^2) * x_t, elementwise.

    a, x: (B,S,R) with a in (0,1).  Returns (h (B,S,R) in x's dtype,
    h_last (B,R) float32).  From h = 0 (prefill) the scan runs ``scan``,
    by default the RG-LRU wrapper (the kernel on CUDA, the exact
    sequential scan on the CPU); with a carried ``h0`` (decode) it runs
    the plain scan from ``h0``, which is the reference's fold of ``h0``
    into step 0.  The reference's associative scan sums in another order:
    the two agree to about 1e-5 in float32.  DTensors run rank by rank
    (``on_ranks``): rows and channels keep their split, a split sequence
    is gathered, and the same scan runs on the local tensors."""
    if is_dtensor(a) or is_dtensor(x):
        return on_ranks(rglru_scan, (a, x, h0), ("bsr", "bsr", "br"),
                        ("bsr", "br"), keep="br", scan=scan)
    if h0 is not None:
        return rglru_plain(a, x, h0)
    return (scan or rglru)(a, x)


def _rglru_decay(p: dict, x: torch.Tensor, c: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The float32 input gate and the float32 decay a of the RG-LRU."""
    dt = x.dtype
    # (R, R) weights split on their input rows: row products, each
    # reduce-scattered onto the channel split x has
    gate_x, gate_a = (torch.sigmoid(tp_matmul(x, p[w].to(dt), "row",
                                              scatter=True).float())
                      for w in ("w_gx", "w_ga"))
    log_a = -c * gate_a * F.softplus(p["log_a"].float())
    return gate_x, torch.exp(log_a)


def rglru_block(p: dict, x: torch.Tensor, h0: torch.Tensor | None = None,
                c: float = 8.0, *, scan: RglruScan | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Griffin's recurrent block core: input/recurrence gates + RG-LRU.

    x: (B,S,R).  p: log_a (R,) float32, w_gx/w_ga (R,R).  The decay a is
    cast to x's dtype before the scan and the gated input is rounded to
    it, as in the reference."""
    dt = x.dtype
    gate_x, a = _rglru_decay(p, x, c)
    gated_x = (x.float() * gate_x).to(dt)
    return rglru_scan(a.to(dt), gated_x, h0, scan=scan)


def rglru_step(p: dict, x_t: torch.Tensor, h_prev: torch.Tensor,
               c: float = 8.0) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step: x_t (B,R), h_prev (B,R) -> (out, h_new), with the
    decay and gated input kept in float32 (the reference's step form)."""
    gate_x, a = _rglru_decay(p, x_t, c)
    xg = x_t.float() * gate_x
    h = a * h_prev.float() + torch.sqrt(
        torch.clamp(1.0 - a * a, min=1e-12)) * xg
    return h.to(x_t.dtype), h


# ---------------------------------------------------------------------------
# RWKV6 decode step (prefill runs the WKV6 kernel or its plain version)
# ---------------------------------------------------------------------------

def rwkv6_step(r_t: torch.Tensor, k_t: torch.Tensor, v_t: torch.Tensor,
               w_t: torch.Tensor, u: torch.Tensor, state: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step. r_t..w_t: (B,H,D); state (B,H,D,D) float32."""
    rf, kf, vf, wf = (t.float() for t in (r_t, k_t, v_t, w_t))
    uf = u.float()
    kv = torch.einsum("bhd,bhv->bhdv", kf, vf)
    out = torch.einsum("bhd,bhdv->bhv", rf, state + uf[None, :, :, None] * kv)
    new_state = state * wf[..., None] + kv
    return out.to(r_t.dtype), new_state
