"""K3: the whole MLP branch of a block, ``x + LN(mlp(x)) * (scale_bias + scale) + shift``.

Replaces ``aurora_tpu/ops/mlp.py::mlp_adaln_residual_fused`` (``pl.pallas_call`` at
``mlp.py:419``). The Swin blocks call it with their FiLM modulations; the perceiver MLP
halves call it with ``scale_bias=0`` and the LayerNorm affine in the FiLM slot
(``aurora_tpu/model/perceiver.py:341-351``).

Numerics (``mlp.py:87-112``): fc1 accumulates in f32, adds the f32 bias and is rounded to
the input dtype; exact-erf GELU in f32, rounded; fc2 accumulates in f32, adds the f32 bias
and is rounded; two-pass f32 LayerNorm (eps 1e-5); the residual is added in f32 and the
result rounded.

Kernel (``csrc/mlp.cu``): one block of 8 warps owns a tile of ``16 * 8 / CW`` rows
(``CW = D / 256``) for the whole hidden dimension. It keeps the row tile in shared memory,
walks the hidden dimension in chunks of 64 (fc1 on bf16 ``mma.sync`` tensor-core tiles,
GELU, the rounded chunk into shared memory) and accumulates fc2 in registers, 128 f32 per
thread, so the 4D-wide hidden never reaches device memory. LayerNorm, FiLM and the residual
run on the accumulators. Bound on the card: operations (``4 * rows * D * 4D`` bf16 flops;
about 1.1 ms per backbone call at 989 TF/s). This first design runs ~19x over it: its time
is flat across the three stages (PERF.md) although the weight bytes each block streams
from L2 grow 4x per stage, so what holds it back is the issue rate of its unstaged,
unpipelined ``mma.sync`` loop at one block per SM (255 registers), not the weights.
"""

from __future__ import annotations

import ctypes

import torch

from aurora_tpu_torch.model.nn import acc_dtype
from aurora_tpu_torch.ops import _lib

__all__ = ["mlp_adaln_residual", "mlp_adaln_residual_plain"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


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
    dt, acc = x.dtype, acc_dtype(x.dtype)
    B, L, D = x.shape
    x2 = x.reshape(B * L, D)
    hid = x2.to(acc) @ w1.to(dt).to(acc) + b1.to(acc)
    hid = torch.nn.functional.gelu(hid.to(dt).to(acc)).to(dt)
    y = (hid.to(acc) @ w2.to(dt).to(acc) + b2.to(acc)).to(dt)
    yf = y.reshape(B, L, -1).to(acc)
    mean = yf.mean(-1, keepdim=True)
    var = (yf - mean).square().mean(-1, keepdim=True)
    ln = (yf - mean) * torch.rsqrt(var + ln_eps)
    mod = ln * (scale_bias + scale.to(acc)[:, None, :]) + shift.to(acc)[:, None, :]
    return (x.to(acc) + mod).to(dt)


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
    if D not in (256, 512, 1024, 2048) or Hd % 64 or tuple(w2.shape) != (Hd, D):
        raise ValueError(f"mlp_adaln_residual kernel: unsupported D={D}, hidden={Hd}")
    w1t = w1.to(torch.bfloat16).t().contiguous()  # (Hd, D): rows are B-fragment columns
    w2t = w2.to(torch.bfloat16).t().contiguous()  # (D, Hd)
    b1f = b1.to(torch.float32).contiguous()
    b2f = b2.to(torch.float32).contiguous()
    shf = shift.to(torch.float32).reshape(B, D).contiguous()
    scf = scale.to(torch.float32).reshape(B, D).contiguous()
    for t, n in ((w1t, "w1"), (w2t, "w2"), (b1f, "b1"), (b2f, "b2"), (shf, "shift")):
        if t.device != x.device:
            raise ValueError(f"{n} must be on {x.device}")
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
