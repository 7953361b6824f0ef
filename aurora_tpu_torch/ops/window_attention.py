"""K2, K6 and K7: window attention over windows of 144 tokens, with the block's optional
attention tail.

* K2 :func:`window_attention_tail` replaces ``aurora_tpu/model/swin3d.py::
  _attn_windows_5d_fused_pallas`` (``pl.pallas_call`` at ``swin3d.py:924``). Input and
  output are the padded 5D tokens ``(B, Cp, Hp, Wp, D)``; windows are read in place, tokens
  in (wc, wh, ww) partition order (``attention_impl="pallas"``).
* K6 :func:`window_attention_windowed` replaces ``_attn_windows_qkv_fused_pallas``
  (``pl.pallas_call`` at ``swin3d.py:772``): the same over partitioned windows
  ``(B, nW, N, D)`` (``attention_impl="pallas_windowed"``).
* K7 :func:`sdpa_windows` replaces ``_sdpa_windows_fused_pallas`` (``pl.pallas_call`` at
  ``swin3d.py:651``): the attention core alone over packed qkv ``(B, nW, N, 3D)``, features
  (q|k|v) x head x dh. No model route reaches it, in the JAX package as here; it is the
  direct test of the core's mask and padding semantics.

Numerics (``_qkv_attn_tail_body``, ``swin3d.py:561-596``, and ``_heads_attention``,
``:524-558``): ``qkv = round(x @ Wqkv) + bqkv`` (bias added after the rounding, in the token
dtype); per head f32 logits ``q.k / sqrt(dh)`` plus the mask (0 for equal group ids, -100
otherwise; no mask in unshifted blocks, where pad tokens take part); softmax weights rounded
to the token dtype; f32-accumulated ``w @ v`` rounded. With ``tail = (wproj, bproj, shift,
scale)``: ``x + LN(round(attn @ Wproj + bproj)) * scale + shift`` with f32 ``bproj``, a
two-pass f32 LayerNorm (eps 1e-5) and the residual added in f32. Without it the attention
output is returned, before proj.

Kernels (``csrc/window_attention.cu``), two CUDA launches behind a K2 / K6 call without the
tail and four with it, all on the shared Hopper headers and PyTorch's current stream:

1. qkv: the persistent TMA + ``wgmma`` ring of ``csrc/gemm_sm90.cuh`` over the token rows in
   their stored order, ``Wqkv (D, 3D)`` read as stored; the epilogue rounds, adds the bf16
   bias and rounds again into a ``(rows, 3D)`` bf16 scratch.
2. core: K7's ring kernel (``csrc/sdpa_sm90.cuh``: two blocks of 9 warps an SM, a 2-stage
   ring of q/k/v boxes by TMA, ``ldmatrix`` core, mask bits). K6 reads the scratch's packed
   rows through a 2D tensor map; K2 reads each window in place through a 5D tensor map of
   the scratch (box ``{64, ws2, ws1, ws0, 1}``), which lands in ``window_partition``'s token
   order, and writes each token's result to its own row of the 5D grid.
3. with the tail, proj on the same ring (``Wproj`` as stored, f32 bias) with a LayerNorm
   statistics epilogue: per row and 256-column tile a mean and a centred sum of squares;
4. with the tail, K3's row kernel: the statistics merged exactly, FiLM, the residual ``x``.

The wrapper allocates the scratch: qkv (796 / 398 / 226 MB at the three backbone stages of
the 0.25 deg model), and with the tail the attention output and the statistics. Weights are
passed as stored, with no transposed copy; a cast happens only where one is not already
bf16 (``Wqkv``, ``bqkv``, ``Wproj``) or f32 (``bproj``, FiLM). Bound on the card: operations (qkv, logits, w@v and proj in bf16 at
989 TF/s).

K7 is a kernel of its own (``csrc/sdpa.cu`` on ``csrc/sdpa_sm90.cuh``), bound by bytes:
persistent blocks, two to an SM, walk runs of (window, head) units through a two-stage ring
that TMA loads fill while the core of the unit before computes; fragments by ``ldmatrix``,
the mask as a template parameter kept as bits in registers.

Gradients (:mod:`aurora_tpu_torch.ops.ad`, as the JAX package's ``kernel_with_xla_grad`` at
``swin3d.py:671-681``, ``:795-805``, ``:949-961``): under grad mode a call whose inputs require
a gradient launches the kernels and saves its inputs; the backward differentiates the plain
math with the qkv, ``w @ v`` and proj products in bf16 (f32 logits), chunk of windows by chunk
(for K2, of rows of windows of the padded grid) so that a chunk's f32 logits stay under
``ad.GRAD_CHUNK_BYTES`` (the JAX package's chunks at ``swin3d.py:466-500``), the mask cut to
the chunk and the weights' gradients summed over the chunks in f32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from aurora_tpu_torch.model.nn import acc_dtype, matmul_acc
from aurora_tpu_torch.ops import _lib, ad
from aurora_tpu_torch.ops.masks import bias_from_groups, group_ids_tensor
from aurora_tpu_torch.ops.mlp import film_layernorm_residual

__all__ = [
    "window_partition",
    "window_reverse",
    "window_attention_tail",
    "window_attention_tail_plain",
    "window_attention_windowed",
    "window_attention_windowed_plain",
    "sdpa_windows",
    "sdpa_windows_plain",
    "check_sdpa_windows_shape",
    "check_window_attention_shape",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
Tail = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


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


# ------------------------------------------------------------------------ plain versions


def _sdpa(qkv: torch.Tensor, ids: Optional[torch.Tensor], num_heads: int, fast: bool):
    """``_heads_attention_xla`` (``swin3d.py:415-436``) on packed ``(B, nW, N, 3D)`` rows with
    the ``(nW, N)`` group ids or None: f32 logits, the weights rounded, ``w @ v`` rounded;
    with ``fast`` the ``w @ v`` product in the tokens' dtype (f32 accumulation on the card)."""
    dt, acc = qkv.dtype, acc_dtype(qkv.dtype)
    B, nW, N, D3 = qkv.shape
    D = D3 // 3
    h, dh = num_heads, D // num_heads
    qkv = qkv.reshape(B, nW, N, 3, h, dh)
    q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    logits = torch.einsum("bwqhd,bwkhd->bwhqk", q.to(acc), k.to(acc)) * (1.0 / math.sqrt(dh))
    if ids is not None:
        logits = logits + bias_from_groups(ids, acc)[None, :, None]
    wgt = torch.softmax(logits, dim=-1).to(dt)
    if fast:
        out = torch.einsum("bwhqk,bwkhd->bwqhd", wgt, v)
    else:
        out = torch.einsum("bwhqk,bwkhd->bwqhd", wgt.to(acc), v.to(acc)).to(dt)
    return out.reshape(B, nW, N, D)


def _windowed(xw, wqkv, bqkv, ids, num_heads, tail, ln_eps, fast: bool) -> torch.Tensor:
    """``_attn_tail_xla_ref`` (``swin3d.py:458-521``) over ``(B, nW, N, D)`` windows."""
    dt = xw.dtype
    B, nW, N, D = xw.shape
    qkv = matmul_acc(xw, wqkv.to(dt), fast).to(dt) + bqkv.to(dt)
    attn = _sdpa(qkv, ids, num_heads, fast)
    if tail is None:
        return attn
    wproj, bproj, shift, scale = tail
    y = (matmul_acc(attn.reshape(B, nW * N, D), wproj.to(dt), fast)
         + bproj.to(acc_dtype(dt))).to(dt)
    out = film_layernorm_residual(y, xw.reshape(B, nW * N, D), shift, scale, 0.0, ln_eps)
    return out.reshape(B, nW, N, D)


def _ids(groups: Optional[np.ndarray], device, part: Optional[slice] = None):
    """The group ids on ``device`` (None without a mask), cut to the windows ``part``."""
    if groups is None:
        return None
    ids = group_ids_tensor(groups, device)
    return ids if part is None else ids[part]


def sdpa_windows_plain(
    qkv: torch.Tensor, groups: Optional[np.ndarray], num_heads: int
) -> torch.Tensor:
    """Plain version of :func:`sdpa_windows` (``_heads_attention_xla``,
    ``swin3d.py:415-436``)."""
    return _sdpa(qkv, _ids(groups, qkv.device), num_heads, fast=False)


def window_attention_windowed_plain(
    xw: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    groups: Optional[np.ndarray],
    num_heads: int,
    tail: Optional[Tail] = None,
    ln_eps: float = 1e-5,
) -> torch.Tensor:
    """Plain version of :func:`window_attention_windowed` (``_attn_tail_xla_ref``,
    ``swin3d.py:458-521``)."""
    return _windowed(xw, wqkv, bqkv, _ids(groups, xw.device), num_heads, tail, ln_eps,
                     fast=False)


def window_attention_tail_plain(
    xp: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    groups: Optional[np.ndarray],
    ws: tuple[int, int, int],
    num_heads: int,
    tail: Optional[Tail] = None,
    ln_eps: float = 1e-5,
) -> torch.Tensor:
    """Plain version of :func:`window_attention_tail`: window partition, the windowed
    math, window reverse."""
    _, Cp, Hp, Wp, _ = xp.shape
    out = window_attention_windowed_plain(
        window_partition(xp, ws), wqkv, bqkv, groups, num_heads, tail, ln_eps
    )
    return window_reverse(out, ws, Cp, Hp, Wp)


# ------------------------------------------------------------- what the backward differentiates
# The plain math with bf16 products (``fast``), on one chunk of windows: ``part`` is the
# chunk's slice of windows (K6, K7) or of the padded grid's rows (K2), the mask cut to it.


def _tail(wproj, bproj, shift, scale) -> Optional[Tail]:
    return None if wproj is None else (wproj, bproj, shift, scale)


def _sdpa_windows_grad(qkv, groups, num_heads, part=None):
    return _sdpa(qkv, _ids(groups, qkv.device, part), num_heads, fast=True)


def _windowed_grad(xw, wqkv, bqkv, groups, num_heads, wproj, bproj, shift, scale, ln_eps,
                   part=None):
    return _windowed(xw, wqkv, bqkv, _ids(groups, xw.device, part), num_heads,
                     _tail(wproj, bproj, shift, scale), ln_eps, fast=True)


def _tail_grad(xp, wqkv, bqkv, groups, ws, num_heads, wproj, bproj, shift, scale, ln_eps,
               part=None):
    _, Cp, Hp, Wp, _ = xp.shape
    ids = _ids(groups, xp.device)
    if ids is not None and part is not None:  # windows in (C1, H1, W1) order: cut H1
        ids = ids.reshape(Cp // ws[0], -1, Wp // ws[2], ids.shape[-1])
        ids = ids[:, part.start // ws[1]:part.stop // ws[1]].reshape(-1, ids.shape[-1])
    out = _windowed(window_partition(xp, ws), wqkv, bqkv, ids, num_heads,
                    _tail(wproj, bproj, shift, scale), ln_eps, fast=True)
    return window_reverse(out, ws, Cp, Hp, Wp)


def _window_chunks(n: int, per_unit: int, unit: int, n_args: int, dim: int) -> ad.Chunks:
    """The backward's chunks along axis ``dim`` of the first of ``n_args`` arguments (the
    rest whole), in steps of ``unit`` indices (a window, or a padded-grid row of windows),
    each step holding ``per_unit`` bytes of f32 logits, under ``ad.GRAD_CHUNK_BYTES``."""
    steps = max(1, ad.GRAD_CHUNK_BYTES // per_unit)
    return ad.Chunks((dim,) + (None,) * (n_args - 1), dim, ad.chunk_bounds(n, steps * unit))


# ------------------------------------------------------------------------ kernels


def _check_heads(N: int, D: int, num_heads: int, what: str) -> None:
    if N != 144 or D != 64 * num_heads or D % 128:
        raise ValueError(
            f"{what} kernel: needs N=144, dh=64, D % 128 == 0; got N={N}, D={D}, "
            f"heads={num_heads}"
        )


def check_sdpa_windows_shape(shape: tuple, num_heads: int) -> tuple[int, int, int]:
    """``(B, nW, D)`` of a packed ``(B, nW, 144, 3D)`` tensor the K7 kernel takes, or
    ``ValueError`` naming the shape: windows of 144 tokens, ``3D`` packed features with a
    head dim of 64 and ``D`` a multiple of 128, row and unit counts within 32 bits."""
    if len(shape) != 4 or shape[3] % 3:
        raise ValueError(f"sdpa_windows kernel: needs (B, nW, 144, 3D), got {tuple(shape)}")
    B, nW, N, D3 = shape
    _check_heads(N, D3 // 3, num_heads, f"sdpa_windows {tuple(shape)}")
    if B * nW * max(N, num_heads) >= 2**31:
        raise ValueError(f"sdpa_windows kernel: too many rows or units in {tuple(shape)}")
    return B, nW, D3 // 3


WINDOW_ATTENTION_D = (512, 1024, 2048)


def check_window_attention_shape(
    shape: tuple, num_heads: int, ws: Optional[tuple[int, int, int]] = None
) -> tuple[int, int, int]:
    """``(B, nW, rows)`` of the tokens K2 and K6 take on the card, or ``ValueError`` naming
    the shape. K2: ``shape = (B, Cp, Hp, Wp, D)`` with windows ``ws`` in place; K6:
    ``shape = (B, nW, N, D)`` and ``ws`` None. ``D`` in (512, 1024, 2048) (``3D`` is whole
    256-column tiles of the qkv product, and the LayerNorm statistics come in 256-column
    tiles), a head dim of 64, windows of 144 tokens, a grid of whole windows, at most
    ``2**24`` rows."""
    what = f"window_attention kernel {tuple(shape)}, heads {num_heads}"
    if len(shape) != (5 if ws is not None else 4):
        raise ValueError(f"{what}: needs (B, Cp, Hp, Wp, D) with ws, or (B, nW, 144, D)")
    B, D = shape[0], shape[-1]
    if D not in WINDOW_ATTENTION_D:
        raise ValueError(f"{what}: D={D} is not one of 512, 1024, 2048")
    if D != 64 * num_heads:
        raise ValueError(f"{what}: head dim D / heads = {D / num_heads:g}, needs 64")
    if ws is None:
        nW, N = shape[1], shape[2]
    else:
        Cp, Hp, Wp = shape[1:4]
        N = ws[0] * ws[1] * ws[2]
        if Cp % ws[0] or Hp % ws[1] or Wp % ws[2]:
            raise ValueError(f"{what}: padded grid {(Cp, Hp, Wp)} is not a multiple of the "
                             f"window {tuple(ws)}")
        nW = (Cp // ws[0]) * (Hp // ws[1]) * (Wp // ws[2])
    if N != 144:
        raise ValueError(f"{what}: windows of N={N} tokens, needs 144")
    rows = B * nW * N
    if not 0 < rows <= 2**24:
        raise ValueError(f"{what}: {rows} token rows, needs 1..2**24")
    return B, nW, rows


def _group_ids(groups: Optional[np.ndarray], nW: int, device) -> Optional[torch.Tensor]:
    if groups is None:
        return None
    gid = group_ids_tensor(groups, device)
    _lib.require(gid, "groups", torch.int32, (nW, 144))
    return gid


# csrc/window_attention.cu::window_attention
_WINDOW_ATTENTION_ARGS = [_P] * 12 + [_I] * 10 + [_F, _P]


def _window_attention_call(
    fn, x, wqkv, bqkv, groups, num_heads, tail, ln_eps, nW, rows, geom5d, ws, what
) -> torch.Tensor:
    """Run ``fn`` (``window_attention`` of ``csrc/window_attention.cu``, or an ablated copy)
    as K2 (``geom5d = (Cp, Hp, Wp)``) or K6 (``geom5d = (0, 0, 0)``): 2 CUDA launches
    without the tail, 4 with it. Allocates the scratch; the weights go as stored (a cast
    only to bf16 / f32 where they are stored otherwise)."""
    B, D = x.shape[0], x.shape[-1]
    bf, f32 = torch.bfloat16, torch.float32
    ops = {"wqkv": (wqkv.to(bf).contiguous(), (D, 3 * D)),
           "bqkv": (bqkv.to(bf).contiguous(), (3 * D,))}
    qkv = x.new_empty(rows, 3 * D)
    attn = torch.empty_like(x)
    out = stats = None
    if tail is not None:
        wproj, bproj, shift, scale = tail
        ops.update(
            wproj=(wproj.to(bf).contiguous(), (D, D)),
            bproj=(bproj.to(f32).contiguous(), (D,)),
            shift=(shift.to(f32).reshape(B, D).contiguous(), (B, D)),
            scale=(scale.to(f32).reshape(B, D).contiguous(), (B, D)),
        )
        stats = torch.empty(rows, D // 256, 2, dtype=f32, device=x.device)
        out = torch.empty_like(x)
    # The tensor maps' bases and the kernels' 16-byte loads and stores need 16-byte
    # alignment; fresh allocations and parameters have it, a view may not.
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: the tokens must be 16-byte aligned")
    for name, (t, shape) in ops.items():
        _lib.require(t, name, t.dtype, shape)
        if t.device != x.device or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be on {x.device}, 16-byte aligned")
    gid = _group_ids(groups, nW, x.device)
    ptr = {k: t.data_ptr() for k, (t, _) in ops.items()}
    err = fn(
        x.data_ptr(), ptr["wqkv"], ptr["bqkv"], None if gid is None else gid.data_ptr(),
        *(ptr.get(k) for k in ("wproj", "bproj", "shift", "scale")),
        qkv.data_ptr(), attn.data_ptr(), None if stats is None else stats.data_ptr(),
        None if out is None else out.data_ptr(),
        B, nW, *geom5d, D, *ws, num_heads, float(ln_eps), _lib.stream(x),
    )
    _lib.check(err, what)
    return attn if out is None else out


def _launch_window_attention(x, *args, what: str) -> torch.Tensor:
    """K2 or K6 (arguments as :func:`_window_attention_call`), counted in ``LAUNCHES``."""
    fn = _lib.kernel("window_attention", "window_attention", _WINDOW_ATTENTION_ARGS)
    out = _window_attention_call(fn, x, *args, what)
    _lib.LAUNCHES[what] += 1
    return out


def window_attention_tail(
    xp: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    groups: Optional[np.ndarray],
    ws: tuple[int, int, int],
    num_heads: int,
    tail: Optional[Tail] = None,
    ln_eps: float = 1e-5,
) -> torch.Tensor:
    """K2: window attention over padded tokens ``xp: (B, Cp, Hp, Wp, D)``.

    ``wqkv``: ``(D, 3D)`` (LoRA folded in), ``bqkv``: ``(3D,)``; ``groups``: the ``(nW, N)``
    group ids of a shifted block, or None (no mask); ``tail``: ``(wproj (D, D) with LoRA
    folded in, bproj (D,), shift (B, D), scale (B, D))`` or None. Returns the post-residual
    tokens with the tail, else the attention output before proj; same shape as ``xp``.

    CPU tensors take :func:`window_attention_tail_plain`; CUDA tensors launch the kernels
    (2 CUDA launches, 4 with the tail), which take bf16 tokens of the shapes
    :func:`check_window_attention_shape` passes.
    """
    if xp.device.type == "cpu":
        return window_attention_tail_plain(xp, wqkv, bqkv, groups, ws, num_heads, tail, ln_eps)
    args = (xp, wqkv, bqkv, groups, ws, num_heads, *(tail or (None,) * 4), ln_eps)
    if ad.needs_grad(*args):
        return _window_attention_tail_differentiable(*args)
    return _window_attention_tail_launch(*args)


def _window_attention_tail_differentiable(*args):
    xp, ws, num_heads = args[0], args[4], args[5]
    B, Cp, Hp, Wp, _ = xp.shape
    N = ws[0] * ws[1] * ws[2]
    row = B * num_heads * N * N * 4 * (Cp // ws[0]) * (Wp // ws[2])  # a row of windows
    chunks = _window_chunks(Hp, row, ws[1], len(args), 2)
    return ad.kernel_with_plain_grad(_window_attention_tail_launch, _tail_grad,
                                     chunks=chunks)(*args)


def _window_attention_tail_launch(xp, wqkv, bqkv, groups, ws, num_heads, wproj, bproj, shift,
                                  scale, ln_eps):
    _lib.require(xp, "xp", torch.bfloat16)
    _, nW, rows = check_window_attention_shape(tuple(xp.shape), num_heads, ws)
    return _launch_window_attention(
        xp, wqkv, bqkv, groups, num_heads, _tail(wproj, bproj, shift, scale), ln_eps, nW, rows,
        tuple(xp.shape[1:4]), ws, what="window_attention",
    )


def window_attention_windowed(
    xw: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    groups: Optional[np.ndarray],
    num_heads: int,
    tail: Optional[Tail] = None,
    ln_eps: float = 1e-5,
) -> torch.Tensor:
    """K6: window attention over partitioned windows ``xw: (B, nW, N, D)``; arguments and
    result as :func:`window_attention_tail`, in the windows' layout.

    CPU tensors take :func:`window_attention_windowed_plain`; CUDA tensors launch the
    kernels (2 CUDA launches, 4 with the tail), which take bf16 tokens of the shapes
    :func:`check_window_attention_shape` passes.
    """
    if xw.device.type == "cpu":
        return window_attention_windowed_plain(xw, wqkv, bqkv, groups, num_heads, tail, ln_eps)
    args = (xw, wqkv, bqkv, groups, num_heads, *(tail or (None,) * 4), ln_eps)
    if ad.needs_grad(*args):
        return _window_attention_windowed_differentiable(*args)
    return _window_attention_windowed_launch(*args)


def _window_attention_windowed_differentiable(*args):
    xw, num_heads = args[0], args[4]
    B, nW, N, _ = xw.shape
    chunks = _window_chunks(nW, B * num_heads * N * N * 4, 1, len(args), 1)
    return ad.kernel_with_plain_grad(_window_attention_windowed_launch, _windowed_grad,
                                     chunks=chunks)(*args)


def _window_attention_windowed_launch(xw, wqkv, bqkv, groups, num_heads, wproj, bproj, shift,
                                      scale, ln_eps):
    _lib.require(xw, "xw", torch.bfloat16)
    _, nW, rows = check_window_attention_shape(tuple(xw.shape), num_heads)
    return _launch_window_attention(
        xw, wqkv, bqkv, groups, num_heads, _tail(wproj, bproj, shift, scale), ln_eps, nW, rows,
        (0, 0, 0), (0, 0, 0), what="window_attention_windowed",
    )


def sdpa_windows(
    qkv: torch.Tensor, groups: Optional[np.ndarray], num_heads: int
) -> torch.Tensor:
    """K7: masked per-head attention over packed window rows ``qkv: (B, nW, N, 3D)``
    (features (q|k|v) x head x dh) -> ``(B, nW, N, D)``; ``groups`` as in
    :func:`window_attention_tail`.

    CPU tensors take :func:`sdpa_windows_plain`; CUDA tensors launch the kernel, which takes
    bf16 rows of the shapes :func:`check_sdpa_windows_shape` passes.
    """
    if qkv.device.type == "cpu":
        return sdpa_windows_plain(qkv, groups, num_heads)
    args = (qkv, groups, num_heads)
    if ad.needs_grad(*args):
        return _sdpa_windows_differentiable(*args)
    return _sdpa_windows_launch(*args)


def _sdpa_windows_differentiable(qkv, groups, num_heads):
    B, nW, N, _ = qkv.shape
    chunks = _window_chunks(nW, B * num_heads * N * N * 4, 1, 3, 1)
    return ad.kernel_with_plain_grad(_sdpa_windows_launch, _sdpa_windows_grad,
                                     chunks=chunks)(qkv, groups, num_heads)


def _sdpa_windows_launch(qkv, groups, num_heads):
    _lib.require(qkv, "qkv", torch.bfloat16)
    B, nW, D = check_sdpa_windows_shape(tuple(qkv.shape), num_heads)
    gid = _group_ids(groups, nW, qkv.device)
    out = qkv.new_empty(B, nW, 144, D)
    fn = _lib.kernel("sdpa", "sdpa_windows", [_P] * 3 + [_I] * 4 + [_P])
    err = fn(
        qkv.data_ptr(), None if gid is None else gid.data_ptr(), out.data_ptr(),
        B, nW, D, num_heads, _lib.stream(qkv),
    )
    _lib.check(err, "sdpa_windows")
    _lib.LAUNCHES["sdpa_windows"] += 1
    return out
