"""K1: the 3-axis cyclic roll of the Swin shifted windows.

Replaces ``aurora_tpu/ops/roll.py::roll3d_pallas`` (``pl.pallas_call`` at ``roll.py:81``):
``roll(x, shifts, dims=(1, 2, 3))`` over ``(B, C, H, W, D)`` tokens in one pass, bit-exact.

Kernel (``csrc/roll.cu``): a gather copy. Each thread moves one 16-byte vector of a token
row from its source row ``((c - s0) % C, (h - s1) % H, (w - s2) % W)``. Bound on the card:
bytes, one read and one write of the tensor (2 x 265 MB at stage 1, ~0.16 ms at 3.35 TB/s);
the design reads each byte once and writes it once, with 16-byte accesses that are
contiguous within a row.
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

    CPU tensors take :func:`roll3d_plain`; CUDA tensors launch the kernel.
    """
    if x.device.type == "cpu":
        return roll3d_plain(x, shifts)
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
    _lib.LAUNCHES["roll3d"] += 1
    return out
