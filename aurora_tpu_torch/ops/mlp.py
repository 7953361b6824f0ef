"""K3, K8 and K5: the MLP branch and the attention tail of a Swin block on rows of tokens.

* K3 ``mlp_adaln_residual``: ``x + LN(mlp(x)) * (scale_bias + scale) + shift``, replacing
  ``aurora_tpu/ops/mlp.py::mlp_adaln_residual_fused`` (``pl.pallas_call`` at ``mlp.py:419``).
  The Swin blocks call it with their FiLM modulations (``mlp_impl="fused"``); the perceiver
  MLP halves call it with ``scale_bias=0`` and the LayerNorm affine in the FiLM slot
  (``aurora_tpu/model/perceiver.py:341-351``) on every route.
* K8 ``mlp_fused``: ``mlp(x)`` alone, replacing ``mlp_fused`` (``pl.pallas_call`` at
  ``mlp.py:278``), for ``mlp_impl="pallas"`` (``swin3d.py:1358-1363``).
* K5 ``linear_adaln_residual``: ``shortcut + LN(x @ W + b) * (scale_bias + scale) + shift``,
  replacing ``linear_adaln_residual_fused`` (``pl.pallas_call`` at ``mlp.py:604``): the
  attention tail after un-windowing under ``attention_impl="xla", mlp_impl="fused"``
  (``swin3d.py:1319-1323``).

Numerics (``mlp.py:87-112``, ``:587-601``): each GEMM accumulates in f32, adds the f32 bias
and is rounded to the input dtype; GELU is the exact erf form in f32, rounded; LayerNorm is
two-pass in f32 with eps 1e-5 (hard-coded in K5, as at ``mlp.py:599``); the residual is added
in f32 and the result rounded.

Kernels (``csrc/mlp.cu``), on the TMA + ``wgmma`` mainloop of ``csrc/gemm_sm90.cuh`` (one
persistent block an SM, (2 x 64) x 256 tiles, every weight read as stored: no transposed
copy) and the product and row kernels of ``csrc/gemm_rows_sm90.cuh``:

* K3 and K8 are two products, chunk of rows by chunk of rows (:func:`mlp_row_chunks`):
  ``mlp_fc1_kernel`` writes ``hid = bf16(GELU(bf16(x W1 + b1)))`` to a scratch of at most
  256 MB, fc2 (``gemm_bias_kernel``) reads it back by TMA and writes ``y = bf16(hid W2 +
  b2)``, which is K8's result. For K3 it also writes each row's mean and centred sum of
  squares per 256-column tile, and ``ln_rows_kernel`` (a warp a row) merges them exactly,
  normalises, applies FiLM and the residual in place. The hidden cannot stay on chip at
  these widths: a consumer warpgroup's 64 x 256 f32 tile is 128 registers a thread and fc2
  needs D / 256 such tiles beside fc1's own. The round trip (1.06 GB each way at stage 1,
  0.63 ms of memory time under ~1.1 ms of tensor-core time) is the design's known distance
  from the bound, which stays the operations' (``4 * rows * D * Hd`` bf16 flops; 1.1 ms per
  backbone call at 989 TF/s). The GELU of a tile is as long as its products at D = 512, so
  each warp parks the rounded pre-activations in shared memory (64 KB a block, which leaves
  a ring of 3 stages) and applies the GELU during the next tile's first 8 K steps, while its
  own asynchronous products run (that hides only part of it: arithmetic and ``wgmma`` of one
  SM hardly overlap, PERF.md). ptxas: 168 registers at launch (consumers 232, producer 40),
  no spills; 222,256 and 214,080 bytes of dynamic shared memory (fc1, fc2); the row kernel
  32 registers.
* K5 is K2's tail on rows, two launches: proj with the f32 bias and the LayerNorm statistics
  (``gemm_bias_kernel<EPI_BIAS_STATS>``, ``w`` as stored), then ``ln_rows_kernel`` with the
  shortcut as the residual, ``scale_bias + scale`` as the gain and FiLM row ``row / L``. It
  takes D in (512, 1024, 2048) (:func:`check_linear_shape`). Its bound is bytes at D = 512,
  operations above.

Gradients (:mod:`aurora_tpu_torch.ops.ad`, the counterpart of the JAX package's
``kernel_with_xla_grad`` at ``mlp.py:302-314``, ``:445-536``, ``:629-645``): under grad mode a
call whose inputs require a gradient launches the kernels and saves its inputs; the backward
differentiates the plain math with bf16 products (:func:`aurora_tpu_torch.model.nn.matmul_acc`
with ``fast``), chunk of rows by chunk of rows so that the f32 hidden layer of a chunk stays
under ``ad.GRAD_CHUNK_BYTES``, the weights' gradients summed over the chunks in f32.

Times in PERF.md.
"""

from __future__ import annotations

import ctypes

import torch

from aurora_tpu_torch.model.nn import acc_dtype, matmul_acc
from aurora_tpu_torch.ops import _lib, ad

__all__ = [
    "MLP_SCRATCH_BYTES",
    "check_linear_shape",
    "check_mlp_shape",
    "film_layernorm_residual",
    "linear_adaln_residual",
    "linear_adaln_residual_plain",
    "mlp_adaln_residual",
    "mlp_adaln_residual_plain",
    "mlp_fused",
    "mlp_fused_plain",
    "mlp_row_chunks",
]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
MLP_SCRATCH_BYTES = 256 << 20  # the most a call allocates for the hidden activations
# csrc/mlp.cu::mlp_rows
_MLP_ROWS_ARGS = [_P] * 10 + [_F, _I, _L, _L, _I, _I, _F, _I, _P]
# csrc/mlp.cu::linear_adaln_residual
_LINEAR_ARGS = [_P] * 6 + [_F, _P, _P, _I, _L, _I, _F, _P]


def film_layernorm_residual(
    y: torch.Tensor,
    residual: torch.Tensor,
    shift: torch.Tensor,
    scale: torch.Tensor,
    scale_bias: float = 0.0,
    ln_eps: float = 1e-5,
) -> torch.Tensor:
    """``residual + LN(y) * (scale_bias + scale) + shift`` over ``(B, L, D)`` rows with
    FiLM ``(B, D)``: two-pass LayerNorm statistics and the sum in f32 (f64 for f64 inputs),
    rounded to the residual's dtype. The epilogue of the plain versions of K2-K6."""
    dt, acc = residual.dtype, acc_dtype(residual.dtype)
    yf = y.to(acc)
    mean = yf.mean(-1, keepdim=True)
    var = (yf - mean).square().mean(-1, keepdim=True)
    ln = (yf - mean) * torch.rsqrt(var + ln_eps)
    mod = ln * (scale_bias + scale.to(acc)[:, None, :]) + shift.to(acc)[:, None, :]
    return (residual.to(acc) + mod).to(dt)


def _mlp(x, w1, b1, w2, b2, fast: bool) -> torch.Tensor:
    dt, acc = x.dtype, acc_dtype(x.dtype)
    hid = (matmul_acc(x, w1.to(dt), fast) + b1.to(acc)).to(dt)
    hid = torch.nn.functional.gelu(hid.to(acc)).to(dt)
    return (matmul_acc(hid, w2.to(dt), fast) + b2.to(acc)).to(dt)


def mlp_fused_plain(
    x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor
) -> torch.Tensor:
    """Plain version of :func:`mlp_fused`."""
    return _mlp(x, w1, b1, w2, b2, fast=False)


def _mlp_fused_grad(x, w1, b1, w2, b2, part=None):
    """What the backward of :func:`mlp_fused` differentiates: the plain math, bf16 products."""
    return _mlp(x, w1, b1, w2, b2, fast=True)


def mlp_adaln_residual_plain(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    shift: torch.Tensor,
    scale: torch.Tensor,
    scale_bias: float = 0.0,
    ln_eps: float = 1e-5,
) -> torch.Tensor:
    """Plain version of :func:`mlp_adaln_residual` (``x: (B, L, D)``, FiLM ``(B, D)``)."""
    y = mlp_fused_plain(x, w1, b1, w2, b2)
    return film_layernorm_residual(y, x, shift, scale, scale_bias, ln_eps)


def _mlp_adaln_residual_grad(x, w1, b1, w2, b2, shift, scale, scale_bias, ln_eps, part=None):
    """What the backward of :func:`mlp_adaln_residual` differentiates."""
    y = _mlp(x, w1, b1, w2, b2, fast=True)
    return film_layernorm_residual(y, x, shift, scale, scale_bias, ln_eps)


def linear_adaln_residual_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    shortcut: torch.Tensor,
    shift: torch.Tensor,
    scale: torch.Tensor,
    scale_bias: float = 0.0,
) -> torch.Tensor:
    """Plain version of :func:`linear_adaln_residual`."""
    return _linear_adaln_residual(x, w, b, shortcut, shift, scale, scale_bias, fast=False)


def _linear_adaln_residual(x, w, b, shortcut, shift, scale, scale_bias, fast: bool):
    dt, acc = x.dtype, acc_dtype(x.dtype)
    y = (matmul_acc(x, w.to(dt), fast) + b.to(acc)).to(dt)
    return film_layernorm_residual(y, shortcut, shift, scale, scale_bias, 1e-5)


def _linear_adaln_residual_grad(x, w, b, shortcut, shift, scale, scale_bias, part=None):
    """What the backward of :func:`linear_adaln_residual` differentiates."""
    return _linear_adaln_residual(x, w, b, shortcut, shift, scale, scale_bias, fast=True)


def _row_chunks(x: torch.Tensor, n_args: int, f32_per_row: int, dim: int = 1) -> ad.Chunks:
    """The backward's chunks of rows (axis ``dim`` of ``x``, the first of ``n_args``
    arguments; the rest whole): as many rows as keep ``f32_per_row`` f32 values a row,
    over the whole batch, under ``ad.GRAD_CHUNK_BYTES``."""
    per = 4 * f32_per_row * max(1, x.numel() // (x.shape[dim] * x.shape[-1]))
    return ad.Chunks((dim,) + (None,) * (n_args - 1), dim,
                     ad.chunk_bounds(x.shape[dim], ad.GRAD_CHUNK_BYTES // per))


def _same_device(x: torch.Tensor, **tensors: torch.Tensor) -> None:
    for n, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{n} must be on {x.device}")


def check_mlp_shape(M: int, D: int, Hd: int) -> None:
    """The shapes K3 and K8 take on the card: M rows of D in (512, 1024, 2048) features (a
    tile is 256 columns and fc1 spreads a tile's GELU over 8 K steps of 64) and a hidden
    width that is a multiple of 256, at least 512. Raises ``ValueError`` otherwise."""
    if D not in (512, 1024, 2048):
        raise ValueError(f"mlp kernel: D={D} is not one of 512, 1024, 2048 (M={M}, hidden={Hd})")
    if Hd < 512 or Hd % 256:
        raise ValueError(f"mlp kernel: hidden={Hd} is not a multiple of 256 >= 512 (M={M}, D={D})")
    if not 0 < M < 2**31:
        raise ValueError(f"mlp kernel: M={M} rows (D={D}, hidden={Hd})")


def check_linear_shape(M: int, D: int) -> None:
    """The shapes K5 takes on the card: M rows of D in (512, 1024, 2048) features (its
    product's column tiles and the row kernel's 256-column statistics), at most 2^24 rows.
    Raises ``ValueError`` otherwise."""
    if D not in (512, 1024, 2048):
        raise ValueError(
            f"linear_adaln_residual kernel: D={D} is not one of 512, 1024, 2048 (M={M})")
    if not 0 < M <= 2**24:
        raise ValueError(f"linear_adaln_residual kernel: M={M} rows (D={D})")


def mlp_row_chunks(M: int, Hd: int, cap: int = MLP_SCRATCH_BYTES) -> list[tuple[int, int]]:
    """``(first row, rows)`` of the chunks K3 / K8 run one after the other, so that the bf16
    hidden activations of a chunk (``rows * Hd * 2`` bytes) fit ``cap``: every chunk but the
    last has the most rows that do, a multiple of 128 (a tile's rows)."""
    rows = cap // (2 * Hd) // 128 * 128
    if rows <= 0:
        raise ValueError(f"mlp kernel: {cap} bytes of scratch hold no 128 rows of hidden={Hd}")
    return [(r0, min(rows, M - r0)) for r0 in range(0, M, rows)]


def _mlp_operands(x, w1, b1, w2, b2):
    """K3's and K8's operands: the weights as stored, ``(in, out)`` bf16 (no copy where they
    are stored so), the biases f32; all checked."""
    bf, f32 = torch.bfloat16, torch.float32
    D, Hd = x.shape[-1], w1.shape[1]
    _lib.require(x, "x", bf)
    check_mlp_shape(x.numel() // D, D, Hd)
    ops = (w1.to(bf).contiguous(), b1.to(f32).contiguous(),
           w2.to(bf).contiguous(), b2.to(f32).contiguous())
    for t, name, shape in zip(ops, ("w1", "b1", "w2", "b2"), ((D, Hd), (Hd,), (Hd, D), (D,))):
        _lib.require(t, name, t.dtype, shape)
    return ops


def _mlp_rows(fn, x, ops, out, film=None) -> None:
    """Run ``fn`` (``mlp_rows`` of ``csrc/mlp.cu``) chunk by chunk on ``x``, ``out``:
    ``(M, D)`` bf16. ``film``: K3's ``(shift, scale, scale_bias, rows_per_batch, ln_eps)``
    with ``shift``/``scale`` ``(B, D)`` f32, or None for K8. Allocates the scratch."""
    M, D = x.shape
    w1, b1, w2, b2 = ops
    Hd = w1.shape[1]
    chunks = mlp_row_chunks(M, Hd)
    most = chunks[0][1]
    hid = torch.empty(most * Hd, dtype=torch.bfloat16, device=x.device)
    if film is None:
        film_args = (None, None, None, 0.0)
        per_batch, eps = 1, 0.0
    else:
        shift, scale, scale_bias, per_batch, eps = film
        stats = torch.empty(most * (D // 256) * 2, dtype=torch.float32, device=x.device)
        film_args = (stats.data_ptr(), shift.data_ptr(), scale.data_ptr(), float(scale_bias))
    for r0, rows in chunks:
        err = fn(
            x.data_ptr() + 2 * r0 * D, w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            hid.data_ptr(), out.data_ptr() + 2 * r0 * D, *film_args,
            rows, r0, per_batch, D, Hd, float(eps), int(film is not None), _lib.stream(x),
        )
        _lib.check(err, "mlp_rows")


def mlp_adaln_residual(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    shift: torch.Tensor,
    scale: torch.Tensor,
    scale_bias: float = 0.0,
    ln_eps: float = 1e-5,
) -> torch.Tensor:
    """``x + LN(fc2(GELU(fc1 x))) * (scale_bias + scale) + shift`` for ``x: (B, L, D)``,
    weights ``(in, out)``, FiLM ``shift``/``scale`` ``(B, D)``.

    CPU tensors take :func:`mlp_adaln_residual_plain`; CUDA tensors launch the kernels, which
    take bf16 tokens of the shapes of :func:`check_mlp_shape` (D in (512, 1024, 2048), a
    hidden width that is a multiple of 256).
    """
    if x.device.type == "cpu":
        return mlp_adaln_residual_plain(x, w1, b1, w2, b2, shift, scale, scale_bias, ln_eps)
    args = (x, w1, b1, w2, b2, shift, scale, scale_bias, ln_eps)
    if ad.needs_grad(*args):
        return _mlp_adaln_residual_differentiable(*args)
    return _mlp_adaln_residual_launch(*args)


def _mlp_adaln_residual_differentiable(*args):
    x, w1 = args[:2]
    return ad.kernel_with_plain_grad(_mlp_adaln_residual_launch, _mlp_adaln_residual_grad,
                                     chunks=_row_chunks(x, len(args), w1.shape[1]))(*args)


def _mlp_adaln_residual_launch(x, w1, b1, w2, b2, shift, scale, scale_bias, ln_eps):
    B, L, D = x.shape
    ops = _mlp_operands(x, w1, b1, w2, b2)
    shf = shift.to(torch.float32).reshape(B, D).contiguous()
    scf = scale.to(torch.float32).reshape(B, D).contiguous()
    _same_device(x, w1=ops[0], b1=ops[1], w2=ops[2], b2=ops[3], shift=shf, scale=scf)
    out = torch.empty_like(x)
    fn = _lib.kernel("mlp", "mlp_rows", _MLP_ROWS_ARGS)
    _mlp_rows(fn, x.view(B * L, D), ops, out.view(B * L, D), (shf, scf, scale_bias, L, ln_eps))
    _lib.LAUNCHES["mlp_adaln_residual"] += 1
    return out


def mlp_fused(
    x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor
) -> torch.Tensor:
    """``fc2(GELU(fc1 x))`` for ``x: (..., D)``, weights ``(in, out)``.

    CPU tensors take :func:`mlp_fused_plain`; CUDA tensors launch the kernels (K3's two
    products; fc2's epilogue adds the bias and rounds), which take bf16 tokens of the shapes
    of :func:`check_mlp_shape`.
    """
    if x.device.type == "cpu":
        return mlp_fused_plain(x, w1, b1, w2, b2)
    args = (x, w1, b1, w2, b2)
    if ad.needs_grad(*args):
        return _mlp_fused_differentiable(*args)
    return _mlp_fused_launch(*args)


def _mlp_fused_differentiable(*args):
    x, w1 = args[:2]
    chunks = _row_chunks(x, len(args), w1.shape[1], dim=max(0, x.dim() - 2))
    return ad.kernel_with_plain_grad(_mlp_fused_launch, _mlp_fused_grad, chunks=chunks)(*args)


def _mlp_fused_launch(x, w1, b1, w2, b2):
    D = x.shape[-1]
    ops = _mlp_operands(x, w1, b1, w2, b2)
    _same_device(x, w1=ops[0], b1=ops[1], w2=ops[2], b2=ops[3])
    out = torch.empty_like(x)
    fn = _lib.kernel("mlp", "mlp_rows", _MLP_ROWS_ARGS)
    _mlp_rows(fn, x.view(-1, D), ops, out.view(-1, D))
    _lib.LAUNCHES["mlp_fused"] += 1
    return out


def linear_adaln_residual(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    shortcut: torch.Tensor,
    shift: torch.Tensor,
    scale: torch.Tensor,
    scale_bias: float = 0.0,
) -> torch.Tensor:
    """``shortcut + LN(x @ w + b) * (scale_bias + scale) + shift`` for ``x``/``shortcut``
    ``(B, L, D)``, ``w: (D, D)``, FiLM ``(B, D)``.

    CPU tensors take :func:`linear_adaln_residual_plain`; CUDA tensors launch the kernels,
    which take bf16 tokens of the shapes of :func:`check_linear_shape`.
    """
    if x.device.type == "cpu":
        return linear_adaln_residual_plain(x, w, b, shortcut, shift, scale, scale_bias)
    args = (x, w, b, shortcut, shift, scale, scale_bias)
    if ad.needs_grad(*args):
        return _linear_adaln_residual_differentiable(*args)
    return _linear_adaln_residual_launch(*args)


def _linear_adaln_residual_differentiable(*args):
    x = args[0]
    bounds = _row_chunks(x, len(args), 2 * x.shape[-1]).bounds  # y and its LayerNorm, f32
    chunks = ad.Chunks((1, None, None, 1, None, None, None), 1, bounds)  # x and shortcut
    return ad.kernel_with_plain_grad(_linear_adaln_residual_launch, _linear_adaln_residual_grad,
                                     chunks=chunks)(*args)


def _linear_adaln_residual_launch(x, w, b, shortcut, shift, scale, scale_bias):
    B, L, D = x.shape
    _lib.require(x, "x", torch.bfloat16)
    _lib.require(shortcut, "shortcut", torch.bfloat16, (B, L, D))
    check_linear_shape(B * L, D)
    ops = {
        "w": w.to(torch.bfloat16).contiguous(), "b": b.to(torch.float32).contiguous(),
        "shift": shift.to(torch.float32).reshape(B, D).contiguous(),
        "scale": scale.to(torch.float32).reshape(B, D).contiguous(),
    }
    for name, shape in (("w", (D, D)), ("b", (D,)), ("shift", (B, D)), ("scale", (B, D))):
        _lib.require(ops[name], name, ops[name].dtype, shape)
    # The tensor maps' bases and the kernels' 16-byte loads and stores need 16-byte alignment.
    for name, tensor in (("x", x), ("shortcut", shortcut), ("w", ops["w"])):
        if tensor.data_ptr() % 16:
            raise ValueError(f"linear_adaln_residual: {name} must be 16-byte aligned")
    _same_device(x, shortcut=shortcut, **ops)
    stats = torch.empty(B * L, D // 256, 2, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    fn = _lib.kernel("mlp", "linear_adaln_residual", _LINEAR_ARGS)
    err = fn(
        x.data_ptr(), ops["w"].data_ptr(), ops["b"].data_ptr(), shortcut.data_ptr(),
        ops["shift"].data_ptr(), ops["scale"].data_ptr(), float(scale_bias), stats.data_ptr(),
        out.data_ptr(), B * L, L, D, 1e-5, _lib.stream(x),
    )
    _lib.check(err, "linear_adaln_residual")
    _lib.LAUNCHES["linear_adaln_residual"] += 1
    return out
