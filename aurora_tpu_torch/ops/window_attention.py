"""K2: shifted-window attention with the block's attention tail.

Replaces ``aurora_tpu/model/swin3d.py::_attn_windows_5d_fused_pallas`` (``pl.pallas_call``
at ``swin3d.py:924``; body ``_qkv_attn_tail_body`` at ``:561-596``). Input and output are
the padded 5D tokens ``(B, Cp, Hp, Wp, D)``; windows of ``N = prod(ws)`` tokens are read
in place, tokens in (wc, wh, ww) partition order.

Numerics (``swin3d.py:573-596``): ``qkv = round(x @ Wqkv) + bqkv`` (bias added after the
rounding, in the token dtype); per head f32 logits ``q.k / sqrt(dh)`` plus the mask (0 for
equal group ids, -100 otherwise; no mask in unshifted blocks, where pad tokens take part);
softmax weights rounded to the token dtype; f32-accumulated ``w @ v`` rounded; tail
``x + LN(round(attn @ Wproj + bproj)) * scale + shift`` with f32 ``bproj``, a two-pass f32
LayerNorm (eps 1e-5) and the residual added in f32.

Kernel (``csrc/window_attention.cu``), two launches behind one wrapper:

(a) one block of 9 warps per (window, head). It streams the window's rows through the
    ``(D, 3 dh)`` weight slice of its head on bf16 ``mma.sync`` tiles, keeps the head's
    q, k and v (144 x 64 each) in shared memory, computes the logits 16 query rows per warp
    in registers with the mask formed from the ``(nW, N)`` group ids, an f32 softmax, and
    ``w @ v``, and writes the head's slice of the attention output. The qkv tensor and the
    logits never reach device memory.
(b) a row kernel: ``proj -> LN -> * scale + shift -> + x`` on whole rows (a tile of rows
    runs the projection chunk by chunk into shared memory, then the LayerNorm).

The attention output (D wide) makes one round trip through device memory between the two;
removing it is the first redesign item. Bound on the card: operations (qkv, logits, w@v
and proj in bf16 at 989 TF/s).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from aurora_tpu_torch.model.nn import acc_dtype
from aurora_tpu_torch.ops import _lib
from aurora_tpu_torch.ops.masks import bias_from_groups, group_ids_tensor

__all__ = [
    "window_partition",
    "window_reverse",
    "window_attention_tail",
    "window_attention_tail_plain",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def window_partition(x: torch.Tensor, ws: tuple[int, int, int]) -> torch.Tensor:
    """``(B, C, H, W, D) -> (B, nW, N, D)``, windows in (C1, H1, W1) order, tokens in
    (wc, wh, ww) order."""
    B, C, H, W, D = x.shape
    x = x.reshape(B, C // ws[0], ws[0], H // ws[1], ws[1], W // ws[2], ws[2], D)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(B, -1, ws[0] * ws[1] * ws[2], D)


def window_reverse(w: torch.Tensor, ws: tuple[int, int, int], C: int, H: int, W: int):
    """Inverse of :func:`window_partition`."""
    B, D = w.shape[0], w.shape[-1]
    x = w.reshape(B, C // ws[0], H // ws[1], W // ws[2], ws[0], ws[1], ws[2], D)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, C, H, W, D)


def _layernorm_rows(y: torch.Tensor, eps: float) -> torch.Tensor:
    mean = y.mean(-1, keepdim=True)
    var = (y - mean).square().mean(-1, keepdim=True)
    return (y - mean) * torch.rsqrt(var + eps)


def window_attention_tail_plain(
    xp: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    wproj: torch.Tensor,
    bproj: torch.Tensor,
    shift: torch.Tensor,
    scale: torch.Tensor,
    groups: Optional[np.ndarray],
    ws: tuple[int, int, int],
    num_heads: int,
    ln_eps: float = 1e-5,
) -> torch.Tensor:
    """Plain version of :func:`window_attention_tail`: window partition, the math of
    ``_attn_tail_xla_ref`` (``swin3d.py:458-521``), window reverse."""
    dt, acc = xp.dtype, acc_dtype(xp.dtype)
    B, Cp, Hp, Wp, D = xp.shape
    h, dh = num_heads, D // num_heads
    xw = window_partition(xp, ws)
    nW, N = xw.shape[1], xw.shape[2]
    x2 = xw.reshape(B, nW * N, D)
    qkv = (x2.to(acc) @ wqkv.to(dt).to(acc)).to(dt) + bqkv.to(dt)
    qkv = qkv.reshape(B, nW, N, 3, h, dh).to(acc)
    q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    logits = torch.einsum("bwqhd,bwkhd->bwhqk", q, k) * (1.0 / math.sqrt(dh))
    if groups is not None:
        g = group_ids_tensor(groups, xp.device)
        logits = logits + bias_from_groups(g, acc)[None, :, None]
    wgt = torch.softmax(logits, dim=-1).to(dt).to(acc)
    attn = torch.einsum("bwhqk,bwkhd->bwqhd", wgt, v).to(dt).reshape(B, nW * N, D)
    y = (attn.to(acc) @ wproj.to(dt).to(acc) + bproj.to(acc)).to(dt)
    ln = _layernorm_rows(y.to(acc), ln_eps)
    out = x2.to(acc) + (ln * scale.to(acc)[:, None, :] + shift.to(acc)[:, None, :])
    return window_reverse(out.to(dt).reshape(B, nW, N, D), ws, Cp, Hp, Wp)


def window_attention_tail(
    xp: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    wproj: torch.Tensor,
    bproj: torch.Tensor,
    shift: torch.Tensor,
    scale: torch.Tensor,
    groups: Optional[np.ndarray],
    ws: tuple[int, int, int],
    num_heads: int,
    ln_eps: float = 1e-5,
) -> torch.Tensor:
    """Window attention plus tail over padded tokens ``xp: (B, Cp, Hp, Wp, D)``.

    ``wqkv``: ``(D, 3D)`` (LoRA folded in), ``bqkv``: ``(3D,)``; ``wproj``: ``(D, D)``,
    ``bproj``: ``(D,)``; ``shift``/``scale``: per-batch FiLM ``(B, D)``; ``groups``: the
    ``(nW, N)`` group ids of a shifted block, or None (no mask). Returns the post-residual
    tokens, same shape as ``xp``.

    CPU tensors take :func:`window_attention_tail_plain`; CUDA tensors launch the kernel,
    which takes bf16 tokens, windows of 144 tokens and a head dim of 64.
    """
    if xp.device.type == "cpu":
        return window_attention_tail_plain(
            xp, wqkv, bqkv, wproj, bproj, shift, scale, groups, ws, num_heads, ln_eps
        )
    B, Cp, Hp, Wp, D = xp.shape
    N = ws[0] * ws[1] * ws[2]
    _lib.require(xp, "xp", torch.bfloat16)
    if N != 144 or D != 64 * num_heads or D % 128:
        raise ValueError(
            f"window_attention kernel: needs N=144, dh=64, D % 128 == 0; got N={N}, "
            f"D={D}, heads={num_heads}"
        )
    if Cp % ws[0] or Hp % ws[1] or Wp % ws[2]:
        raise ValueError(f"padded grid {(Cp, Hp, Wp)} is not a multiple of the window {ws}")
    bf = torch.bfloat16
    wqkv_t = wqkv.to(bf).t().contiguous()  # (3D, D)
    wproj_t = wproj.to(bf).t().contiguous()  # (D, D)
    bqkv_b = bqkv.to(bf).contiguous()
    bproj_f = bproj.to(torch.float32).contiguous()
    shf = shift.to(torch.float32).reshape(B, D).contiguous()
    scf = scale.to(torch.float32).reshape(B, D).contiguous()
    gid = None
    if groups is not None:
        gid = group_ids_tensor(groups, xp.device)
        nW = (Cp // ws[0]) * (Hp // ws[1]) * (Wp // ws[2])
        _lib.require(gid, "groups", torch.int32, (nW, N))
    attn = torch.empty_like(xp)
    out = torch.empty_like(xp)
    fn = _lib.kernel(
        "window_attention", "window_attention_tail", [_P] * 10 + [_I] * 9 + [_F, _P]
    )
    err = fn(
        xp.data_ptr(), wqkv_t.data_ptr(), bqkv_b.data_ptr(),
        None if gid is None else gid.data_ptr(),
        wproj_t.data_ptr(), bproj_f.data_ptr(), shf.data_ptr(), scf.data_ptr(),
        attn.data_ptr(), out.data_ptr(),
        B, Cp, Hp, Wp, D, ws[0], ws[1], ws[2], num_heads, float(ln_eps), _lib.stream(xp),
    )
    _lib.check(err, "window_attention_tail")
    _lib.LAUNCHES["window_attention"] += 1
    return out
