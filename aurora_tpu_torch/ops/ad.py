"""Gradients of the hand-written kernels (port of ``aurora_tpu/ops/ad.py``).

A kernel launched through ``ctypes`` returns a tensor autograd knows nothing of: without
this module a train step on the card would stop its gradients at the first kernel, without
an error. :func:`kernel_with_plain_grad` pairs a kernel with a differentiable PyTorch
function of the same math, as ``kernel_with_xla_grad`` (``aurora_tpu/ops/ad.py:32-67``)
pairs a Pallas kernel with its XLA reference: the forward launches the kernel and saves its
inputs; the backward recomputes the plain math on detached copies of them and takes
``torch.autograd.grad`` of it, for the inputs whose gradient is asked for only. The two
forwards differ by rounding, which does not matter to a gradient. The JAX package has no
backward kernel, so neither has the port; the backward's products are PyTorch's.

Under LoRA-only training nothing upstream of the backbone asks for a gradient, so the
encoder's kernels never enter this module, and the decoder's compute the gradient of their
input and no weight gradient (XLA's dead-code elimination does the same for the JAX step).

A :class:`Chunks` plan runs the backward over slices of the inputs along one axis (windows,
rows or token columns), so that the transients of the recompute (an f32 hidden layer, the
logits) stay bounded at the full grid: the gradients of the sliced inputs are written slice
by slice, those of the whole inputs (the weights) summed over the chunks in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

__all__ = ["GRAD_CHUNK_BYTES", "Chunks", "chunk_bounds", "kernel_with_plain_grad",
           "needs_grad"]

# The most that the largest f32 intermediate of one chunk's recompute may take (a K3 hidden
# layer, a K2 chunk's logits, a K4 chunk's mix); the JAX package's budgets are 192-256 MiB
# (``aurora_tpu/model/swin3d.py:440-455``, ``aurora_tpu/ops/mlp.py:69-79``).
GRAD_CHUNK_BYTES = 512 << 20


@dataclasses.dataclass(frozen=True)
class Chunks:
    """A chunk plan of a backward. ``dims``: for each input, the axis it is sliced along, or
    None for an input that enters every chunk whole (a weight, whose gradient is summed over
    the chunks in f32); ``out_dim``: the output's axis; ``bounds``: the ``(start, stop)`` of
    each chunk along those axes, covering each index once."""

    dims: tuple[Optional[int], ...]
    out_dim: int
    bounds: tuple[tuple[int, int], ...]


def chunk_bounds(n: int, step: int) -> tuple[tuple[int, int], ...]:
    """``(start, stop)`` of consecutive chunks of ``step`` (the last may be shorter) over
    ``range(n)``."""
    step = max(1, min(step, n))
    return tuple((a, min(a + step, n)) for a in range(0, n, step))


def needs_grad(*args) -> bool:
    """Whether a call on ``args`` must go through its ``Function``: grad mode is on and a
    tensor among them requires a gradient."""
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args)


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


class _KernelGrad(torch.autograd.Function):
    """Forward: ``kernel(*args)`` under ``no_grad``, the tensor inputs saved. Backward:
    ``torch.autograd.grad`` of ``grad_fn(*args, part=...)`` recomputed on them."""

    @staticmethod
    def forward(ctx, kernel, grad_fn, chunks, *args):
        ctx.grad_fn, ctx.chunks = grad_fn, chunks
        ctx.args = [None if isinstance(a, torch.Tensor) else a for a in args]
        ctx.tensors = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        ctx.save_for_backward(*(args[i] for i in ctx.tensors))
        with torch.no_grad():
            return kernel(*args)

    @staticmethod
    def backward(ctx, g):
        args = list(ctx.args)
        for i, t in zip(ctx.tensors, ctx.saved_tensors):
            args[i] = t
        want = [i for i in ctx.tensors if ctx.needs_input_grad[3 + i]]
        grads: list = [None] * len(args)
        if want:
            _backward(ctx.grad_fn, ctx.chunks, args, want, g, grads)
        return (None, None, None, *grads)


def _backward(grad_fn, chunks: Optional[Chunks], args: list, want: list, g, grads: list):
    """Fill ``grads[i]`` for each ``i`` in ``want``: one pass over the whole inputs, or one
    pass a chunk of ``chunks``."""
    parts = [None] if chunks is None else chunks.bounds
    sums = {}
    for part in parts:
        sub = list(args)
        if part is not None:
            a, b = part
            for i, d in enumerate(chunks.dims):
                if d is not None:
                    sub[i] = args[i].narrow(d, a, b - a)
        with torch.enable_grad():
            leaves = {}
            for i in want:
                leaves[i] = sub[i] = sub[i].detach().requires_grad_(True)
            for i, t in enumerate(sub):
                if isinstance(t, torch.Tensor) and i not in leaves:
                    sub[i] = t.detach()
            out = grad_fn(*sub, part=None if part is None else slice(*part))
            gp = g if part is None else g.narrow(chunks.out_dim, part[0], part[1] - part[0])
            got = torch.autograd.grad(out, [leaves[i] for i in want], gp, allow_unused=True)
        for i, gi in zip(want, got):
            if gi is None:
                gi = torch.zeros_like(leaves[i])
            if part is None:
                grads[i] = gi
            elif chunks.dims[i] is not None:
                if grads[i] is None:
                    grads[i] = torch.empty_like(args[i])
                grads[i].narrow(chunks.dims[i], part[0], part[1] - part[0]).copy_(gi)
            elif i in sums:
                sums[i] += gi.to(sums[i].dtype)
            else:
                sums[i] = gi.to(_acc(gi.dtype))
    for i, s in sums.items():
        grads[i] = s.to(args[i].dtype)


def kernel_with_plain_grad(
    kernel: Callable[..., torch.Tensor],
    grad_fn: Callable[..., torch.Tensor],
    chunks: Optional[Chunks] = None,
) -> Callable[..., torch.Tensor]:
    """A differentiable call of ``kernel``: ``f(*args)`` launches ``kernel(*args)`` and is
    differentiated as ``grad_fn(*args, part=None)``.

    ``kernel`` and ``grad_fn`` take the same positional arguments and return one tensor of
    the same shape; arguments that are not tensors (shapes, group ids, flags) pass through
    and get no gradient (a constant tensor is detached at the call site). With
    ``chunks`` the backward calls ``grad_fn`` once a chunk, on the sliced inputs, with
    ``part`` the chunk's ``slice`` along the sliced axes (for a function that must cut a
    constant of its own to the chunk, such as a window mask)."""
    def f(*args):
        return _KernelGrad.apply(kernel, grad_fn, chunks, *args)

    return f
