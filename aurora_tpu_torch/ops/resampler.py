"""K4: the shared-query perceiver attention core of the level (de-)aggregation.

Replaces ``aurora_tpu/ops/resampler.py::perceiver_core_fused`` (``pl.pallas_call`` at
``resampler.py:254``). Per token column of the k-major context ``(K, M, D)``: the k (f32)
and v projections, the logits of every (query, head) against the shared queries, a
softmax over the level axis K, the weighted value sum, the out-projection, ``ln1`` and the
query residual, giving ``(M, Q, D_out)``.

Numerics (``xla_ref_m``, ``resampler.py:276-329``): k and the logits are f32 (bf16 q/k was
measured at 2e-1 end-to-end error, ``aurora_tpu/model/perceiver.py:145-152``); under
``value_bf16`` the value projection runs on bf16-rounded context and weights with f32
accumulation and is rounded, the softmax weights are rounded, and the weighted sum
accumulates in bf16 level by level (``resampler.py:204-206``); the out-projection
accumulates in f32 and is rounded; LayerNorm is two-pass f32 with the affine ``ln1``, then
the f32 query residual, then one rounding to the output dtype.

Kernel (``csrc/resampler.cu``), two launches behind one wrapper:

(a) one block per (tile of 32 columns, head). Each thread owns one column and an eighth of
    the head dim; it accumulates k (f32 products) and v (bf16 operands, f32 sums) for all K
    levels in registers while the context streams through shared memory, then reduces the
    per-query logits across the 8 threads of its column, takes the softmax over K and
    writes the head's slice of the bf16 weighted sum ``o: (M, Q, inner)``. k, v, the logits
    and the softmax weights never reach device memory.
(b) the row kernel of K2(b): ``round(o @ Wout) -> LN(ln1) -> + queries`` on whole rows.

Bound on the card: operations. The f32 k-projection (``K*M*D*inner`` multiply-adds, ~442
GFLOP at the aggregation shape) runs outside the tensor cores at 67 TF/s, ~6.6 ms; the
context read is ~0.5 ms. This simple design also runs the v-projection on the f32 pipes.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from aurora_tpu_torch.model.nn import acc_dtype
from aurora_tpu_torch.ops import _lib

__all__ = ["perceiver_core", "perceiver_core_plain"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _ln_affine(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float):
    mean = y.mean(-1, keepdim=True)
    var = (y - mean).square().mean(-1, keepdim=True)
    return (y - mean) * torch.rsqrt(var + eps) * w + b


def perceiver_core_plain(
    ctx: torch.Tensor,
    wk: torch.Tensor,
    wv: torch.Tensor,
    qh: torch.Tensor,
    wout: torch.Tensor,
    ln1_w: torch.Tensor,
    ln1_b: torch.Tensor,
    queries: torch.Tensor,
    *,
    scale: float,
    ln_eps: float = 1e-5,
    value_bf16: bool = False,
) -> torch.Tensor:
    """Plain version of :func:`perceiver_core`."""
    K, M, D = ctx.shape
    Q, h, dh = qh.shape
    inner = h * dh
    dt = ctx.dtype
    acc = acc_dtype(dt)
    out_dt = torch.bfloat16 if value_bf16 else dt
    vdt = torch.bfloat16 if value_bf16 else dt
    x2 = ctx.reshape(K * M, D)
    k = x2.to(acc) @ wk.to(dt).to(acc)
    v = (x2.to(vdt).to(acc) @ wv.to(vdt).to(acc)).to(vdt)
    logits = torch.einsum("kmhd,qhd->kmqh", k.reshape(K, M, h, dh), qh.to(acc)) * scale
    w = torch.softmax(logits, dim=0).to(vdt)  # (K, M, Q, h)
    v4 = v.reshape(K, M, 1, h, dh)
    o = w[0][..., None] * v4[0]  # (M, Q, h, dh), rounded like the kernel's bf16 products
    for kk in range(1, K):
        o = o + w[kk][..., None] * v4[kk]
    attn = (o.reshape(M * Q, inner).to(acc) @ wout.to(out_dt).to(acc)).to(out_dt)
    ln = _ln_affine(attn.to(acc), ln1_w.to(acc), ln1_b.to(acc), ln_eps)
    return (ln.reshape(M, Q, -1) + queries.to(acc)[None]).to(out_dt)


def perceiver_core(
    ctx: torch.Tensor,
    wk: torch.Tensor,
    wv: torch.Tensor,
    qh: torch.Tensor,
    wout: torch.Tensor,
    ln1_w: torch.Tensor,
    ln1_b: torch.Tensor,
    queries: torch.Tensor,
    *,
    scale: float,
    ln_eps: float = 1e-5,
    value_bf16: bool = False,
    lnk: Optional[tuple] = None,
) -> torch.Tensor:
    """Shared-query cross-attention core.

    ``ctx``: ``(K, M, D)`` k-major context; ``wk``/``wv``: ``(D, inner)`` (the halves of
    ``to_kv``); ``qh``: ``(Q, h, dh)`` projected queries; ``wout``: ``(inner, D_out)``;
    ``queries``: ``(Q, D_out)``, the residual added after ``ln1``. Returns
    ``(M, Q, D_out)``, bf16 under ``value_bf16``, else in the context dtype.

    CPU tensors take :func:`perceiver_core_plain`; CUDA tensors launch the kernel, which
    takes an f32 context with ``value_bf16``, K in (3, 13) and a head dim in (32, 64).
    The stabilising ``ln_k`` of ``stabilise_level_agg`` is not ported yet.
    """
    if lnk is not None:
        raise NotImplementedError("ln_k (stabilise_level_agg) is not ported yet")
    if ctx.device.type == "cpu":
        return perceiver_core_plain(
            ctx, wk, wv, qh, wout, ln1_w, ln1_b, queries,
            scale=scale, ln_eps=ln_eps, value_bf16=value_bf16,
        )
    K, M, D = ctx.shape
    Q, h, dh = qh.shape
    inner = h * dh
    D_out = wout.shape[1]
    _lib.require(ctx, "ctx", torch.float32)
    if not value_bf16 or (K, dh) not in ((13, 32), (3, 64)) or D % 32 or inner % 128:
        raise ValueError(
            f"perceiver_core kernel: needs value_bf16 and (K, dh) in ((13, 32), (3, 64)); "
            f"got value_bf16={value_bf16}, K={K}, dh={dh}, D={D}"
        )
    if D_out not in (512, 1024, 2048):
        raise ValueError(f"perceiver_core kernel: unsupported D_out={D_out}")
    wk_f = wk.to(torch.float32).contiguous()
    wv_b = wv.to(torch.bfloat16).contiguous()
    qh_f = qh.to(torch.float32).reshape(Q, inner).contiguous()
    wout_t = wout.to(torch.bfloat16).t().contiguous()  # (D_out, inner)
    lw = ln1_w.to(torch.float32).contiguous()
    lb = ln1_b.to(torch.float32).contiguous()
    qres = queries.to(torch.float32).contiguous()
    o = torch.empty(M, Q, inner, device=ctx.device, dtype=torch.bfloat16)
    out = torch.empty(M, Q, D_out, device=ctx.device, dtype=torch.bfloat16)
    fn = _lib.kernel("resampler", "perceiver_core", [_P] * 10 + [_I] * 7 + [_F, _F, _P])
    err = fn(
        ctx.data_ptr(), wk_f.data_ptr(), wv_b.data_ptr(), qh_f.data_ptr(),
        wout_t.data_ptr(), lw.data_ptr(), lb.data_ptr(), qres.data_ptr(),
        o.data_ptr(), out.data_ptr(), K, M, D, h, dh, Q, D_out, float(scale), float(ln_eps),
        _lib.stream(ctx),
    )
    _lib.check(err, "perceiver_core")
    _lib.LAUNCHES["perceiver_core"] += 1
    return out
