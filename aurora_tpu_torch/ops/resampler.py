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

With ``lnk = (weight, bias)`` (the ``ln_k`` of ``stabilise_level_agg``,
``resampler.py:169-172``) the f32 k of every (level, column) passes a two-pass f32
LayerNorm over the whole ``inner`` axis, all heads together, with eps fixed at 1e-5 (not
``ln_eps``) and an f32 affine, before the logits.

Kernel (``csrc/resampler.cu``), six launches behind one wrapper call (one count in
``LAUNCHES``), on the shared Hopper headers:

0. the fold (once a call): k enters the result only through the logits, so
   ``logits = ctx @ Wkq`` with ``Wkq[c, (q, h)] = scale * sum_d wk[c, h dh + d] qh[q, h, d]``
   (the JAX kernel's ``k @ wq_bd`` re-associated: 442 -> 41 GFLOP of f32 work at the
   aggregation shape). With ``lnk``, ``k - mean(k) = ctx @ Wc`` with the centred weights
   ``Wc = wk - rowmean(wk)``, so ``logits = rstd * (ctx @ Wkq') + const`` (``Wkq'`` folds the
   ``ln_k`` weight into ``Wc``, ``const`` its bias) and only ``rstd`` needs ``ctx @ Wc``,
   of which each row's sum of squares is kept. Sums in f64 on the card;
1. the f32 logits on the FFMA pipes, one pass over the context that also writes its bf16
   rounding (with ``lnk`` also the bf16 remainder); with ``lnk`` then ``ctx @ Wc`` on the
   TMA + ``wgmma`` ring in three bf16 parts (context and ``Wc`` each a bf16 value plus a bf16
   remainder; the logits stay at f32's level), keeping each row's sum of squares;
2. ``v`` on the TMA + ``wgmma`` ring of ``gemm_rows_sm90.cuh``, ``wv`` read as stored;
3. the mix: per (column, query, head) the softmax over K, the weights rounded, the
   level-order bf16 sum, into ``o (M, Q, inner)``;
4. the out-projection on the same ring, ``wout`` as stored, with LayerNorm statistics per
   256-column tile;
5. the row kernel: ``ln1``, the f32 query residual of period Q, one rounding.

Launches 1-5 run once for each chunk of token columns (:func:`perceiver_column_chunks`), so
that their scratch stays under :data:`PERCEIVER_SCRATCH_BYTES`.
``tests/test_torch_resampler_redesign.py`` repeats the kernels' arithmetic in PyTorch.

Bound on the card: operations, the folded f32 logits at 67 TF/s and the bf16 products at
989 TF/s (with ``lnk``, the three parts of ``ctx @ Wc`` among them). Times in ``PERF.md``.

Gradient (:mod:`aurora_tpu_torch.ops.ad`, as the JAX package's chunked vjp at
``resampler.py:331-381``): under grad mode a call whose inputs require a gradient launches
the kernels and saves its inputs; the backward differentiates the plain math (the v and
out-projection products in bf16, k and the logits in f32, as ``xla_ref_m``) chunk of
columns by chunk of columns, the weights' gradients summed over the chunks in f32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from aurora_tpu_torch.model.nn import acc_dtype, matmul_acc
from aurora_tpu_torch.ops import _lib, ad

__all__ = [
    "PERCEIVER_SCRATCH_BYTES",
    "check_perceiver_shape",
    "perceiver_column_bytes",
    "perceiver_column_chunks",
    "perceiver_core",
    "perceiver_core_plain",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PERCEIVER_SCRATCH_BYTES = 512 << 20  # the most a call allocates for one chunk's scratch
# csrc/resampler.cu::perceiver_core
_PERCEIVER_CORE_ARGS = [_P] * 21 + [_I] * 8 + [_F, _F, _P]


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
    lnk: Optional[tuple] = None,
) -> torch.Tensor:
    """Plain version of :func:`perceiver_core`."""
    return _perceiver(ctx, wk, wv, qh, wout, ln1_w, ln1_b, queries, scale, ln_eps, value_bf16,
                      *(lnk or (None, None)), fast=False)


def _perceiver(ctx, wk, wv, qh, wout, ln1_w, ln1_b, queries, scale, ln_eps, value_bf16,
               lnk_w, lnk_b, fast: bool) -> torch.Tensor:
    K, M, D = ctx.shape
    Q, h, dh = qh.shape
    inner = h * dh
    dt = ctx.dtype
    acc = acc_dtype(dt)
    out_dt = torch.bfloat16 if value_bf16 else dt
    vdt = torch.bfloat16 if value_bf16 else dt
    x2 = ctx.reshape(K * M, D)
    k = matmul_acc(x2, wk.to(dt), fast)
    if lnk_w is not None:
        k = _ln_affine(k, lnk_w.to(acc), lnk_b.to(acc), 1e-5)
    v = matmul_acc(x2.to(vdt), wv.to(vdt), fast).to(vdt)
    logits = torch.einsum("kmhd,qhd->kmqh", k.reshape(K, M, h, dh), qh.to(acc)) * scale
    w = torch.softmax(logits, dim=0).to(vdt)  # (K, M, Q, h)
    v4 = v.reshape(K, M, 1, h, dh)
    o = w[0][..., None] * v4[0]  # (M, Q, h, dh), rounded like the kernel's bf16 products
    for kk in range(1, K):
        o = o + w[kk][..., None] * v4[kk]
    attn = matmul_acc(o.reshape(M * Q, inner), wout.to(out_dt), fast).to(out_dt)
    ln = _ln_affine(attn.to(acc), ln1_w.to(acc), ln1_b.to(acc), ln_eps)
    return (ln.reshape(M, Q, -1) + queries.to(acc)[None]).to(out_dt)


def _perceiver_core_grad(ctx, wk, wv, qh, wout, ln1_w, ln1_b, queries, scale, ln_eps,
                         value_bf16, lnk_w, lnk_b, part=None):
    """What the backward of :func:`perceiver_core` differentiates (one chunk of columns)."""
    return _perceiver(ctx, wk, wv, qh, wout, ln1_w, ln1_b, queries, scale, ln_eps, value_bf16,
                      lnk_w, lnk_b, fast=True)


def check_perceiver_shape(
    K: int, M: int, D: int, heads: int, dh: int, Q: int, D_out: int, value_bf16: bool = True
) -> None:
    """The shapes K4 takes on the card: ``value_bf16``; ``(K, dh)`` in ``((13, 32), (3, 64))``
    (the aggregation and the de-aggregation); ``D`` a multiple of 64 (a K step of the ring);
    ``inner = heads * dh`` a multiple of 256 up to 2048 (a column tile of the ring; the mix
    gives a column at most a block); ``D_out`` in ``(512, 1024, 2048)`` (the row kernel's
    tiles). Raises ``ValueError`` otherwise."""
    if not value_bf16 or (K, dh) not in ((13, 32), (3, 64)):
        raise ValueError(
            f"perceiver_core kernel: needs value_bf16 and (K, dh) in ((13, 32), (3, 64)); "
            f"got value_bf16={value_bf16}, K={K}, dh={dh}"
        )
    inner = heads * dh
    if D <= 0 or D % 64 or inner % 256 or inner > 2048:
        raise ValueError(
            f"perceiver_core kernel: needs D % 64 == 0 and inner % 256 == 0 up to 2048; got "
            f"D={D}, inner={inner}"
        )
    if D_out not in (512, 1024, 2048):
        raise ValueError(f"perceiver_core kernel: D_out={D_out} is not one of 512, 1024, 2048")
    if M <= 0:
        raise ValueError(f"perceiver_core kernel: M={M} columns")


def perceiver_column_bytes(K: int, D: int, inner: int, Q: int, heads: int, D_out: int,
                           lnk: bool) -> int:
    """The scratch K4's launches 1-5 take for one token column: the bf16 context (with
    ``lnk`` also its remainder and the sums of squares), bf16 v, the f32 logits, bf16 ``o``
    and the row statistics."""
    return (K * D * 2 + (K * D * 2 + K * -(-inner // 256) * 4 if lnk else 0) + K * inner * 2
            + K * Q * heads * 4 + Q * inner * 2 + Q * -(-D_out // 256) * 8)


def perceiver_column_chunks(
    M: int, K: int, D: int, inner: int, Q: int, heads: int, D_out: int, lnk: bool,
    cap: int = PERCEIVER_SCRATCH_BYTES,
) -> list[tuple[int, int]]:
    """``(first column, columns)`` of the chunks K4's launches 1-5 run one after the other, so
    that a chunk's scratch (:func:`perceiver_column_bytes` a column) fits ``cap``: as few
    chunks as fit, every one but the last of the same multiple of 128 columns."""
    per_col = perceiver_column_bytes(K, D, inner, Q, heads, D_out, lnk)
    most = min(cap // per_col, 65535 * 128 // K) // 128 * 128
    if most <= 0:
        raise ValueError(f"perceiver_core kernel: {cap} bytes of scratch hold no 128 columns "
                         f"({per_col} bytes a column)")
    n = -(-M // most)  # chunks
    if n == 1:
        return [(0, M)]
    even = -(-M // n)
    cols = -(-even // 128) * 128  # <= most: even <= most, a multiple of 128
    return [(m0, min(cols, M - m0)) for m0 in range(0, M, cols)]


def _perceiver_core_call(fn, ctx, wk, wv, qh, wout, ln1_w, ln1_b, queries, scale, ln_eps,
                         value_bf16, lnk) -> torch.Tensor:
    """Run ``fn`` (``perceiver_core`` of ``csrc/resampler.cu``, or an ablated copy): the fold,
    then launches 1-5 chunk by chunk of columns. Allocates the scratch; the weights go as
    stored (a cast only to bf16 / f32 where they are stored otherwise)."""
    K, M, D = ctx.shape
    Q, h, dh = qh.shape
    inner, D_out = h * dh, wout.shape[1]
    bf, f32 = torch.bfloat16, torch.float32
    _lib.require(ctx, "ctx", f32)
    check_perceiver_shape(K, M, D, h, dh, Q, D_out, value_bf16)
    ops = {
        "wk": (wk.to(f32).contiguous(), (D, inner)),
        "wv": (wv.to(bf).contiguous(), (D, inner)),
        "qh": (qh.to(f32).reshape(Q, inner).contiguous(), (Q, inner)),
        "wout": (wout.to(bf).contiguous(), (inner, D_out)),
        "ln1_w": (ln1_w.to(f32).contiguous(), (D_out,)),
        "ln1_b": (ln1_b.to(f32).contiguous(), (D_out,)),
        "queries": (queries.to(f32).contiguous(), (Q, D_out)),
    }
    if lnk is not None:
        ops.update(lnk_w=(lnk[0].to(f32).contiguous(), (inner,)),
                   lnk_b=(lnk[1].to(f32).contiguous(), (inner,)))
    # The tensor maps' bases and the kernels' 16-byte loads and stores need 16-byte
    # alignment; fresh allocations and parameters have it, a view may not.
    if ctx.data_ptr() % 16:
        raise ValueError("perceiver_core: the context must be 16-byte aligned")
    for name, (t, shape) in ops.items():
        _lib.require(t, name, t.dtype, shape)
        if t.device != ctx.device or t.data_ptr() % 16:
            raise ValueError(f"perceiver_core: {name} must be on {ctx.device}, 16-byte aligned")
    QH, ln_k = Q * h, lnk is not None
    mc = perceiver_column_chunks(M, K, D, inner, Q, h, D_out, ln_k)[0][1]

    def new(*shape, dtype=bf, when=True):
        return torch.empty(*shape, dtype=dtype, device=ctx.device) if when else None

    scratch = dict(
        wb=new(D, -(-QH // 64) * 64, dtype=f32), cst=new(QH, dtype=f32, when=ln_k),
        w3=new(3 * D, inner, when=ln_k), ctxb=new(K * mc, D), ctxlo=new(K * mc, D, when=ln_k),
        v=new(K * mc, inner), logits=new(K * mc, QH, dtype=f32),
        sq=new(K * mc, inner // 256, dtype=f32, when=ln_k), o=new(mc, Q, inner),
        stats=new(mc * Q, D_out // 256, 2, dtype=f32),
    )
    out = new(M, Q, D_out)
    ptr = {k: t.data_ptr() for k, (t, _) in ops.items()}
    err = fn(
        ctx.data_ptr(), *(ptr[k] for k in ("wk", "wv", "qh", "wout", "ln1_w", "ln1_b", "queries")),
        ptr.get("lnk_w"), ptr.get("lnk_b"),
        *(None if t is None else t.data_ptr() for t in scratch.values()), out.data_ptr(),
        K, M, mc, D, h, dh, Q, D_out, float(scale), float(ln_eps), _lib.stream(ctx),
    )
    _lib.check(err, "perceiver_core")
    return out


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
    ``queries``: ``(Q, D_out)``, the residual added after ``ln1``; ``lnk``: the
    ``(inner,)`` weight and bias of the stabilising ``ln_k``, or None. Returns
    ``(M, Q, D_out)``, bf16 under ``value_bf16``, else in the context dtype.

    CPU tensors take :func:`perceiver_core_plain`; CUDA tensors launch the kernels, which
    take an f32 context with ``value_bf16`` and the shapes of :func:`check_perceiver_shape`.
    """
    if ctx.device.type == "cpu":
        return perceiver_core_plain(
            ctx, wk, wv, qh, wout, ln1_w, ln1_b, queries,
            scale=scale, ln_eps=ln_eps, value_bf16=value_bf16, lnk=lnk,
        )
    args = (ctx, wk, wv, qh, wout, ln1_w, ln1_b, queries, scale, ln_eps, value_bf16,
            *(lnk or (None, None)))
    if ad.needs_grad(*args):
        return _perceiver_core_differentiable(*args)
    return _perceiver_core_launch(*args)


def _perceiver_core_differentiable(*args):
    ctx, qh, wout = args[0], args[3], args[4]
    K, M, D = ctx.shape
    Q, h, dh = qh.shape
    # A column's f32 intermediates: context, k, v, logits and weights; o, out-projection and
    # LayerNorm.
    per_col = 4 * (K * (D + 2 * h * dh + 2 * Q * h) + Q * (h * dh + 2 * wout.shape[1]))
    chunks = ad.Chunks((1,) + (None,) * (len(args) - 1), 0,
                       ad.chunk_bounds(M, ad.GRAD_CHUNK_BYTES // per_col))
    return ad.kernel_with_plain_grad(_perceiver_core_launch, _perceiver_core_grad,
                                     chunks=chunks)(*args)


def _perceiver_core_launch(ctx, wk, wv, qh, wout, ln1_w, ln1_b, queries, scale, ln_eps,
                           value_bf16, lnk_w, lnk_b):
    fn = _lib.kernel("resampler", "perceiver_core", _PERCEIVER_CORE_ARGS)
    out = _perceiver_core_call(fn, ctx, wk, wv, qh, wout, ln1_w, ln1_b, queries, scale, ln_eps,
                               value_bf16, None if lnk_w is None else (lnk_w, lnk_b))
    _lib.LAUNCHES["perceiver_core"] += 1
    return out
