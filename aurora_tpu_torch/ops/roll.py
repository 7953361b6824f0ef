"""K1: the 3-axis cyclic roll of the Swin shifted windows.

Replaces ``aurora_tpu/ops/roll.py::roll3d_pallas`` (``pl.pallas_call`` at ``roll.py:81``):
``roll(x, shifts, dims=(1, 2, 3))`` over ``(B, C, H, W, D)`` tokens in one pass, bit-exact.

Kernel (``csrc/roll.cu``): a gather copy. Each thread moves one 16-byte vector of a token
row from its source row ``((c - s0) % C, (h - s1) % H, (w - s2) % W)``. Bound on the card:
bytes, one read and one write of the tensor (2 x 265 MB at stage 1, ~0.16 ms at 3.35 TB/s);
the design reads each byte once and writes it once, with 16-byte accesses that are
contiguous within a row.

Gradient: a roll's vjp is the roll by the negated shifts, exact, so the backward of a
launch is one more launch of the same kernel (counted under ``roll3d_bwd``), as the JAX
package's vjp of ``jnp.roll`` is a roll (``aurora_tpu/ops/roll.py:101-106``).
"""

from __future__ import annotations

import ctypes

import torch

from aurora_tpu_torch.ops import _lib

__all__ = ["roll3d", "roll3d_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int


def roll3d_plain(x: torch.Tensor, shifts: tuple[int, int, int]) -> torch.Tensor:
    """Plain version: three per-axis rotations, each a concatenation of two slices
    (what ``jnp.roll`` lowers to)."""
    for dim, s in zip((1, 2, 3), shifts):
        n = x.shape[dim]
        s = int(s) % n
        if s:
            x = torch.cat((x.narrow(dim, n - s, s), x.narrow(dim, 0, n - s)), dim=dim)
    return x


def roll3d(x: torch.Tensor, shifts: tuple[int, int, int]) -> torch.Tensor:
    """``roll(x, shifts, dims=(1, 2, 3))`` for ``x: (B, C, H, W, D)``.

    CPU tensors take :func:`roll3d_plain`; CUDA tensors launch the kernel, and when ``x``
    requires a gradient under grad mode, through :class:`_Roll`, whose backward launches it
    again with the shifts negated.
    """
    if x.device.type == "cpu":
        return roll3d_plain(x, shifts)
    if x.requires_grad and torch.is_grad_enabled():
        return _Roll.apply(x, tuple(shifts))
    return _roll3d_launch(x, shifts, "roll3d")


class _Roll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shifts):
        ctx.shifts = shifts
        return _roll3d_launch(x, shifts, "roll3d")

    @staticmethod
    def backward(ctx, g):
        back = tuple(-int(s) for s in ctx.shifts)
        return _roll3d_launch(g.contiguous(), back, "roll3d_bwd"), None


def _roll3d_launch(x: torch.Tensor, shifts, key: str) -> torch.Tensor:
    """One launch of the kernel on ``x``, counted under ``LAUNCHES[key]``."""
    B, C, H, W, D = x.shape
    _lib.require(x, "x", x.dtype)
    row_bytes = D * x.element_size()
    if row_bytes % 16:
        raise ValueError(f"roll3d needs rows of a multiple of 16 bytes, got {row_bytes}")
    s0, s1, s2 = (int(s) % n for s, n in zip(shifts, (C, H, W)))
    out = torch.empty_like(x)
    fn = _lib.kernel("roll", "roll3d", [_P, _P] + [_I] * 8 + [_P])
    err = fn(x.data_ptr(), out.data_ptr(), B, C, H, W, row_bytes, s0, s1, s2, _lib.stream(x))
    _lib.check(err, "roll3d")
    _lib.LAUNCHES[key] += 1
    return out
