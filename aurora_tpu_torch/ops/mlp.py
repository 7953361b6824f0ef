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

Kernels (``csrc/mlp.cu``). K3 and K8 are one kernel with two epilogues: a block of 8 warps
owns a tile of ``16 * 8 / CW`` rows (``CW = D / 256``) for the whole hidden dimension. It
keeps the row tile in shared memory, walks the hidden dimension in chunks of 64 (fc1 on bf16
``mma.sync`` tensor-core tiles, GELU, the rounded chunk into shared memory) and accumulates
fc2 in registers, 128 f32 per thread, so the 4D-wide hidden never reaches device memory.
K3 then runs LayerNorm, FiLM and the residual on the accumulators; K8 adds the bias and
rounds. Bound on the card: operations (``4 * rows * D * 4D`` bf16 flops; about 1.1 ms per
backbone call at 989 TF/s). This first design runs ~19x over it: its time is flat across
the three stages (PERF.md) although the weight bytes each block streams from L2 grow 4x per
stage, so what holds it back is the issue rate of its unstaged, unpipelined ``mma.sync``
loop at one block per SM (255 registers), not the weights. K5 is the row kernel of
``csrc/row_tail.cuh`` (K2's tail) with the shortcut as its residual; its bound is bytes.
"""

from __future__ import annotations

import ctypes

import torch

from aurora_tpu_torch.model.nn import acc_dtype
from aurora_tpu_torch.ops import _lib

__all__ = [
    "film_layernorm_residual",
    "linear_adaln_residual",
    "linear_adaln_residual_plain",
    "mlp_adaln_residual",
    "mlp_adaln_residual_plain",
    "mlp_fused",
    "mlp_fused_plain",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


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


def mlp_fused_plain(
    x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor
) -> torch.Tensor:
    """Plain version of :func:`mlp_fused`."""
    dt, acc = x.dtype, acc_dtype(x.dtype)
    hid = (x.to(acc) @ w1.to(dt).to(acc) + b1.to(acc)).to(dt)
    hid = torch.nn.functional.gelu(hid.to(acc)).to(dt)
    return (hid.to(acc) @ w2.to(dt).to(acc) + b2.to(acc)).to(dt)


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
    dt, acc = x.dtype, acc_dtype(x.dtype)
    y = (x.to(acc) @ w.to(dt).to(acc) + b.to(acc)).to(dt)
    return film_layernorm_residual(y, shortcut, shift, scale, scale_bias, 1e-5)


def _same_device(x: torch.Tensor, **tensors: torch.Tensor) -> None:
    for n, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{n} must be on {x.device}")


def _check_mlp(D: int, Hd: int, w2: torch.Tensor, what: str) -> None:
    if D not in (256, 512, 1024, 2048) or Hd % 64 or tuple(w2.shape) != (Hd, D):
        raise ValueError(f"{what} kernel: unsupported D={D}, hidden={Hd}")


def _mlp_weights(w1, b1, w2, b2):
    """The kernels' operands: weights transposed to ``(out, in)`` bf16 (rows are
    B-fragment columns), biases f32."""
    bf, f32 = torch.bfloat16, torch.float32
    return (
        w1.to(bf).t().contiguous(), b1.to(f32).contiguous(),
        w2.to(bf).t().contiguous(), b2.to(f32).contiguous(),
    )


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

    CPU tensors take :func:`mlp_adaln_residual_plain`; CUDA tensors launch the kernel,
    which takes bf16 tokens with D in (256, 512, 1024, 2048) and a hidden width that is a
    multiple of 64.
    """
    if x.device.type == "cpu":
        return mlp_adaln_residual_plain(x, w1, b1, w2, b2, shift, scale, scale_bias, ln_eps)
    B, L, D = x.shape
    Hd = w1.shape[1]
    _lib.require(x, "x", torch.bfloat16)
    _check_mlp(D, Hd, w2, "mlp_adaln_residual")
    w1t, b1f, w2t, b2f = _mlp_weights(w1, b1, w2, b2)
    shf = shift.to(torch.float32).reshape(B, D).contiguous()
    scf = scale.to(torch.float32).reshape(B, D).contiguous()
    _same_device(x, w1t=w1t, w2t=w2t, b1=b1f, b2=b2f, shift=shf, scale=scf)
    out = torch.empty_like(x)
    fn = _lib.kernel("mlp", "mlp_adaln_residual", [_P] * 8 + [_F, _I, _I, _I, _I, _F, _P])
    err = fn(
        x.data_ptr(), w1t.data_ptr(), b1f.data_ptr(), w2t.data_ptr(), b2f.data_ptr(),
        shf.data_ptr(), scf.data_ptr(), out.data_ptr(), float(scale_bias),
        B * L, L, D, Hd, float(ln_eps), _lib.stream(x),
    )
    _lib.check(err, "mlp_adaln_residual")
    _lib.LAUNCHES["mlp_adaln_residual"] += 1
    return out


def mlp_fused(
    x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor
) -> torch.Tensor:
    """``fc2(GELU(fc1 x))`` for ``x: (..., D)``, weights ``(in, out)``.

    CPU tensors take :func:`mlp_fused_plain`; CUDA tensors launch the kernel (K3's loop with
    a bias-and-round epilogue), which takes bf16 tokens with D in (256, 512, 1024, 2048) and
    a hidden width that is a multiple of 64.
    """
    if x.device.type == "cpu":
        return mlp_fused_plain(x, w1, b1, w2, b2)
    D, Hd = x.shape[-1], w1.shape[1]
    _lib.require(x, "x", torch.bfloat16)
    _check_mlp(D, Hd, w2, "mlp_fused")
    w1t, b1f, w2t, b2f = _mlp_weights(w1, b1, w2, b2)
    _same_device(x, w1t=w1t, w2t=w2t, b1=b1f, b2=b2f)
    out = torch.empty_like(x)
    fn = _lib.kernel("mlp", "mlp_fused", [_P] * 6 + [_I, _I, _I, _P])
    err = fn(
        x.data_ptr(), w1t.data_ptr(), b1f.data_ptr(), w2t.data_ptr(), b2f.data_ptr(),
        out.data_ptr(), x.numel() // D, D, Hd, _lib.stream(x),
    )
    _lib.check(err, "mlp_fused")
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

    CPU tensors take :func:`linear_adaln_residual_plain`; CUDA tensors launch the kernel,
    which takes bf16 tokens with D a multiple of 64 up to 1024, or of 128 up to 2048.
    """
    if x.device.type == "cpu":
        return linear_adaln_residual_plain(x, w, b, shortcut, shift, scale, scale_bias)
    B, L, D = x.shape
    _lib.require(x, "x", torch.bfloat16)
    _lib.require(shortcut, "shortcut", torch.bfloat16, (B, L, D))
    if tuple(w.shape) != (D, D) or D > 2048 or D % (64 if D <= 1024 else 128):
        raise ValueError(f"linear_adaln_residual kernel: unsupported D={D}, w {tuple(w.shape)}")
    wt = w.to(torch.bfloat16).t().contiguous()
    bf = b.to(torch.float32).contiguous()
    shf = shift.to(torch.float32).reshape(B, D).contiguous()
    gain = (scale_bias + scale.to(torch.float32)).reshape(B, D).contiguous()
    _same_device(x, w=wt, b=bf, shift=shf, scale=gain)
    out = torch.empty_like(x)
    fn = _lib.kernel("mlp", "linear_adaln_residual", [_P] * 7 + [_I, _I, _I, _F, _P])
    err = fn(
        x.data_ptr(), wt.data_ptr(), bf.data_ptr(), shortcut.data_ptr(), shf.data_ptr(),
        gain.data_ptr(), out.data_ptr(), B * L, L, D, 1e-5, _lib.stream(x),
    )
    _lib.check(err, "linear_adaln_residual")
    _lib.LAUNCHES["linear_adaln_residual"] += 1
    return out
