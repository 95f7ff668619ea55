"""The backward of a forward-only kernel: the vector-Jacobian product of
its plain, differentiable version, recomputed on the saved inputs.

None of the Pallas kernels the port replaces has a backward (the
reference differentiates its jnp math), so none of the CUDA kernels has
one: a wrapper calls its kernel through ``KernelFn`` with its plain
version, and only where ``needs_grad``.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence

import torch

from repro_torch.hw import cost


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record a call on ``tensors``: only then does
    a wrapper go through its ``torch.autograd.Function`` (and save its
    inputs); otherwise, as in serving under ``no_grad``, it launches the
    kernel directly."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def vjp(fn: Callable, inputs: Sequence[torch.Tensor],
        needs_input_grad: Sequence[bool],
        cotangents: Sequence[torch.Tensor | None], **kw) -> tuple:
    """The gradients of ``fn(*inputs, **kw)`` for the inputs that
    ``needs_input_grad`` marks (None for the others) under the
    ``cotangents`` of its outputs (one tensor or a tuple); a cotangent
    that is None counts as zeros, and an input that the outputs with a
    cotangent do not depend on gets zeros (e.g. r and u under the WKV6
    final state's cotangent alone)."""
    leaves = [t.detach().requires_grad_(need)
              for t, need in zip(inputs, needs_input_grad)]
    wanted = [t for t in leaves if t.requires_grad]
    with torch.enable_grad():
        outs = fn(*leaves, **kw)
        if isinstance(outs, torch.Tensor):
            outs = (outs,)
        pairs = [(o, g) for o, g in zip(outs, cotangents) if g is not None]
        if pairs:
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], wanted, [g for _, g in pairs],
                allow_unused=True, materialize_grads=True))
        else:
            grads = iter([None] * len(wanted))
    return tuple(next(grads) if t.requires_grad else None for t in leaves)


class KernelFn(torch.autograd.Function):
    """A forward-only kernel under autograd.

    ``KernelFn.apply(launch, plain, kw, *inputs)`` returns
    ``launch(*inputs, **kw)`` (the wrapper's counted kernel launch); its
    backward is ``vjp(plain, inputs, ...)`` with the same ``kw``, on the
    saved inputs.  A cotangent that is None counts as zeros."""

    @staticmethod
    def forward(ctx, launch, plain, kw, *inputs):
        ctx.save_for_backward(*inputs)
        ctx.plain, ctx.kw = plain, kw
        ctx.set_materialize_grads(False)
        return launch(*inputs, **kw)

    @staticmethod
    def backward(ctx, *cotangents):
        inputs, need = ctx.saved_tensors, ctx.needs_input_grad[3:]

        def grads():
            return vjp(ctx.plain, inputs, need, cotangents, **ctx.kw)

        counter = cost.current() if inputs[0].device.type == "meta" else None
        if counter is None:
            return (None, None, None, *grads())
        # the dry-run counts the recomputed VJP once for each shape
        key = (ctx.plain, tuple(sorted(ctx.kw.items())), need,
               *(_layout(t) for t in (*inputs, *cotangents)))
        return (None, None, None, *counter.repeat(key, grads))


def _layout(t: torch.Tensor | None):
    return None if t is None else (tuple(t.shape), t.stride(), t.dtype)
