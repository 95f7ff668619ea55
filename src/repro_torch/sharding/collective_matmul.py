"""Chunked collective matmul: overlap the weight all-gather with compute.

Port of ``repro.sharding.collective_matmul``, the Strategy-4 analogue:
while one product runs, the link (the "second pipe") passes the next
shard of the weight around a ring.  The reference writes it with
``shard_map`` and ``lax.ppermute``; here each rank of the ring's mesh
axis multiplies the shard it holds and passes it to its neighbour with
``torch.distributed.batch_isend_irecv`` on the axis's process group, so
after n steps every rank has consumed every shard.  On CUDA the sends
and receives are issued from a side stream, so the transfer of shard
i+1 runs beside product i; the caller's stream waits for the received
shard only before the next product.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.launch.mesh import mesh_sizes


def ring_ag_matmul(x: torch.Tensor, w_local: torch.Tensor, *, mesh,
                   axis: str = "model") -> torch.Tensor:
    """y = x @ w with w (K, N) row-sharded over ``axis`` of ``mesh``:
    ``w_local`` is this rank's (K/n, N) shard, the one at its coordinate
    on ``axis``.  x: (..., K), replicated over ``axis`` (each step
    consumes the k-slice that matches the shard it holds).  Returns the
    full (..., N) on every rank of the ring.  At an axis of size 1 this
    is one product and no transfer."""
    import torch.distributed as dist

    n = mesh_sizes(mesh)[axis]
    k = w_local.shape[0]
    if x.shape[-1] != n * k:
        raise ValueError(f"x has K={x.shape[-1]}, the ring {n} shards of "
                         f"{k} rows")
    if n == 1:
        return torch.matmul(x, w_local)
    group = mesh.get_group(axis)
    idx = mesh.get_local_rank(axis)
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    side = torch.cuda.Stream(device=w_local.device) if w_local.is_cuda \
        else None
    acc = None
    w_cur = w_local.contiguous()
    for i in range(n):
        # after i rotations this rank holds the shard that started on the
        # rank i places before it on the ring
        src = (idx - i) % n
        reqs, w_nxt = [], None
        if i < n - 1:
            w_nxt = torch.empty_like(w_cur)
            ops = [dist.P2POp(dist.isend, w_cur, nxt, group),
                   dist.P2POp(dist.irecv, w_nxt, prv, group)]
            if side is not None:
                side.wait_stream(torch.cuda.current_stream(w_cur.device))
            with (torch.cuda.stream(side) if side is not None
                  else contextlib.nullcontext()):
                reqs = dist.batch_isend_irecv(ops)
        part = torch.matmul(x[..., src * k:(src + 1) * k], w_cur)
        acc = part if acc is None else acc + part
        for r in reqs:
            r.wait()
        if w_nxt is not None:
            w_cur = w_nxt
    return acc


def reference_ag_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w)
