"""The redesigned K4 ``perceiver_core`` and K5 ``linear_adaln_residual`` on the CPU: what can be
held here without the card.

* ``perceiver_core_mirror`` (below) repeats K4's kernels' arithmetic in PyTorch: the fold of
  ``wk`` (and with ``ln_k`` its centring, weight and bias) into the logit weights, the logits from
  them (with ``ln_k``, ``rstd`` from ``ctx @ Wc`` in three bf16 parts), v from
  the rounded context, the level-order mix, the out-projection, the LayerNorm merged from
  per-256-column-tile statistics and the f32 query residual of period Q, chunk by chunk of
  columns. It is held to ``perceiver_core_plain`` at 1e-12 in float64 and by the branch
  error in f32 (1e-5) and with bf16 values (1e-2, one flipped bf16 rounding is up to 7.8e-3
  of a value), for both (K, dh) pairs of the model, with and without ``ln_k``, at a ragged
  M split into chunks.
* The folded logits (with ``ln_k``: ``rstd`` from the three bf16 parts) against the direct
  ones (``k = ctx @ wk``, then ``k . qh``) in f32 at the model's widths, each within 2e-6 of
  the largest logit of the float64 result; ``rstd`` from one bf16 product is not (over 5e-5).
* The column chunks cover every column once under the scratch cap; the shape rules of K4
  and K5 take the model's shapes and refuse others.
"""

import numpy as np
import pytest
import torch

from aurora_tpu_torch.model.nn import acc_dtype
from aurora_tpu_torch.ops import mlp, resampler
from aurora_tpu_torch.tools import branch_err

# ------------------------------------------------------------------------------ the mirror


def fold_logit_weights(wk: torch.Tensor, qh: torch.Tensor, scale: float, lnk=None) -> tuple:
    """K4's folded logit weights, as its fold launch (``csrc/resampler.cu``) computes them:
    sums in float64, the results rounded to float32 (kept in float64 for float64 weights).

    Returns ``(wkq, wc, const)``: ``wkq (D, Q h)`` with ``ctx @ wkq`` the logits (columns in
    ``(q, h)`` order, ``scale`` included); with ``lnk``, ``wkq`` holds the ``ln_k`` weight
    folded into the centred weights, ``wc (D, inner)`` the centred weights (``ctx @ wc`` is
    ``k - mean(k)``) and ``const (Q h,)`` the folded ``ln_k`` bias, so that the logits are
    ``rstd * (ctx @ wkq) + const``; else ``wc`` and ``const`` are None."""
    dt = torch.float64 if wk.dtype == torch.float64 else torch.float32
    f64 = torch.float64
    Q, h, dh = qh.shape
    w, q = wk.to(f64), qh.to(f64)
    wc = const = None
    if lnk is not None:
        centred = w - w.mean(-1, keepdim=True)
        w = centred * lnk[0].to(f64)
        wc = centred.to(dt)
        const = scale * torch.einsum("hd,qhd->qh", lnk[1].to(f64).reshape(h, dh), q)
        const = const.reshape(Q * h).to(dt)
    wkq = scale * torch.einsum("chd,qhd->cqh", w.reshape(-1, h, dh), q)
    wkq = wkq.reshape(-1, Q * h).to(dt)
    return wkq, wc, const


def _sums_of_squares(x, wc):
    """Each row's sum of squares of ``x @ wc``, as K4 computes it: in f32, the product in
    three bf16 parts (``x`` and ``wc`` each a bf16 value plus a bf16 remainder: hi hi + lo hi +
    hi lo), summed per 256-column tile, then over the tiles; in float64 the exact product."""
    if x.dtype == torch.float64:
        s = x @ wc
    else:
        bf = torch.bfloat16
        hi, w_hi = x.to(bf).float(), wc.to(bf).float()
        lo, w_lo = (x - hi).to(bf).float(), (wc - w_hi).to(bf).float()
        s = hi @ w_hi + lo @ w_hi + hi @ w_lo
    tile = 256 if s.shape[-1] % 256 == 0 else s.shape[-1]
    return s.square().reshape(s.shape[0], -1, tile).sum(-1).sum(-1, keepdim=True)


def perceiver_core_mirror(
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
    lnk=None,
    cap: int = resampler.PERCEIVER_SCRATCH_BYTES,
) -> torch.Tensor:
    """``perceiver_core_plain``'s function computed the way K4's kernels compute it: chunk by
    chunk of columns; logits from the folded weights (with ``lnk``, ``rstd`` from the sums of
    squares of :func:`_sums_of_squares`); v from the rounded context; the
    level-order mix; the out-projection rounded; LayerNorm from the mean and centred sum of
    squares of each 256-column tile, merged exactly; the f32 query residual of period Q."""
    K, M, D = ctx.shape
    Q, h, dh = qh.shape
    inner, D_out = h * dh, wout.shape[1]
    dt = ctx.dtype
    acc = acc_dtype(dt)
    out_dt = vdt = torch.bfloat16 if value_bf16 else dt
    wkq, wc, const = fold_logit_weights(wk, qh, scale, lnk)
    tile = 256 if D_out % 256 == 0 else D_out
    out = torch.empty(M, Q, D_out, dtype=out_dt)
    chunks = resampler.perceiver_column_chunks(M, K, D, inner, Q, h, D_out, lnk is not None, cap)
    for m0, mc in chunks:
        x = ctx[:, m0:m0 + mc].reshape(K * mc, D).to(acc)
        logits = x @ wkq.to(acc)  # (K mc, Q h)
        if lnk is not None:
            rstd = torch.rsqrt(_sums_of_squares(x, wc.to(acc)) / inner + 1e-5)
            logits = rstd * logits + const.to(acc)
        v = (x.to(vdt).to(acc) @ wv.to(vdt).to(acc)).to(vdt).reshape(K, mc, 1, h, dh)
        w = torch.softmax(logits.reshape(K, mc, Q, h), dim=0).to(vdt)
        o = w[0][..., None] * v[0]
        for kk in range(1, K):
            o = o + w[kk][..., None] * v[kk]
        y = (o.reshape(mc * Q, inner).to(acc) @ wout.to(out_dt).to(acc)).to(out_dt).to(acc)
        yt = y.reshape(mc * Q, D_out // tile, tile)
        mean_t = yt.sum(-1) * (1.0 / tile)
        m2_t = (yt - mean_t[..., None]).square().sum(-1)
        mean = mean_t.sum(-1, keepdim=True) / (D_out // tile)
        m2 = (m2_t + tile * (mean_t - mean).square()).sum(-1, keepdim=True)
        ln = (y - mean) * torch.rsqrt(m2 / D_out + ln_eps) * ln1_w.to(acc) + ln1_b.to(acc)
        out[m0:m0 + mc] = (queries.to(acc)[None] + ln.reshape(mc, Q, D_out)).to(out_dt)
    return out


# (K, dh): the aggregation (13 levels to 3 latent ones, head dim 32) and the de-aggregation
# (3 latent levels to 13, head dim 64).
KD = [(13, 32), (3, 64)]


def _inputs(K, dh, dtype, h=2, M=300, seed=0):
    rng = np.random.default_rng(seed)
    Q = 3 if K == 13 else 5
    D = inner = h * dh

    def f(*shape, std=1.0):
        return torch.from_numpy(std * rng.standard_normal(shape)).to(dtype)

    a = dict(ctx=f(K, M, D), wk=f(D, inner, std=0.3), wv=f(D, inner, std=0.3), qh=f(Q, h, dh),
             wout=f(inner, D, std=0.3), ln1_w=1 + f(D, std=0.1), ln1_b=f(D, std=0.1),
             queries=f(Q, D))
    return a, (1 + f(inner, std=0.2), f(inner, std=0.2))


@pytest.mark.parametrize("form", ["f64", "f32", "bf16"])
@pytest.mark.parametrize("with_lnk", [False, True], ids=["plain_k", "ln_k"])
@pytest.mark.parametrize("K,dh", KD, ids=["agg", "de-agg"])
def test_mirror_of_the_kernels_equals_the_plain_version(K, dh, with_lnk, form):
    dtype = torch.float64 if form == "f64" else torch.float32
    a, lnk = _inputs(K, dh, dtype)
    Q, h, _ = a["qh"].shape
    D = h * dh
    kw = dict(scale=dh**-0.5, value_bf16=form == "bf16", lnk=lnk if with_lnk else None)
    # A cap of 130 columns' scratch: chunks of 128, 128 and 44 columns.
    cap = 130 * resampler.perceiver_column_bytes(K, D, D, Q, h, D, with_lnk)
    assert resampler.perceiver_column_chunks(300, K, D, D, Q, h, D, with_lnk, cap) == [
        (0, 128), (128, 128), (256, 44)]
    want = resampler.perceiver_core_plain(**a, **kw)
    got = perceiver_core_mirror(**a, **kw, cap=cap)
    assert got.dtype == want.dtype and got.shape == want.shape
    if form == "f64":
        assert (got - want).abs().max().item() <= 1e-12 * want.abs().max().item()
    else:
        err = branch_err(got, want, a["queries"][None])[1]
        assert err <= (1e-5 if form == "f32" else 1e-2), err


@pytest.mark.parametrize("K,D,h,Q,with_lnk", [
    (13, 512, 16, 3, False), (13, 512, 16, 3, True), (3, 1024, 16, 13, False),
], ids=["agg", "agg-ln_k", "de-agg"])
def test_folded_logits_match_the_direct_ones_in_f32(K, D, h, Q, with_lnk):
    rng = np.random.default_rng(K + D)
    M, dh = 128, D // h
    scale = dh**-0.5
    ctx = rng.standard_normal((K * M, D))
    wk = 0.05 * rng.standard_normal((D, D))
    qh = rng.standard_normal((Q, h, dh))
    lnk = (1 + 0.1 * rng.standard_normal(D), 0.1 * rng.standard_normal(D))

    def direct(dtype):
        t = lambda x: torch.from_numpy(x).to(dtype)  # noqa: E731
        k = t(ctx) @ t(wk)
        if with_lnk:
            mean = k.mean(-1, keepdim=True)
            var = (k - mean).square().mean(-1, keepdim=True)
            k = (k - mean) * torch.rsqrt(var + 1e-5) * t(lnk[0]) + t(lnk[1])
        return torch.einsum("rhd,qhd->rqh", k.reshape(-1, h, dh), t(qh)).reshape(-1, Q * h) * scale

    want = direct(torch.float64)
    f32 = torch.float32
    x = torch.from_numpy(ctx).to(f32)
    wkq, wc, const = fold_logit_weights(
        torch.from_numpy(wk).to(f32), torch.from_numpy(qh).to(f32), scale,
        tuple(torch.from_numpy(v).to(f32) for v in lnk) if with_lnk else None)
    folded = x @ wkq
    if with_lnk:  # rstd from the three bf16 parts of ctx @ wc, as the kernels take it
        folded = torch.rsqrt(_sums_of_squares(x, wc) / D + 1e-5) * folded + const
    top = want.abs().max().item()
    for got in (folded, direct(f32)):
        assert (got.double() - want).abs().max().item() <= 2e-6 * top
    if with_lnk:  # the remainders are needed: ctx @ wc from one bf16 product is not f32-level
        bf = torch.bfloat16
        s = x.to(bf).float() @ wc.to(bf).float()
        rstd = torch.rsqrt(s.square().sum(-1, keepdim=True) / D + 1e-5)
        one_part = rstd * (x @ wkq) + const
        assert (one_part.double() - want).abs().max().item() > 5e-5 * top


# ------------------------------------------------------------------------------ chunks


@pytest.mark.parametrize("M,K,D,h,Q,with_lnk,n", [
    (64800, 13, 512, 16, 3, False, 4), (64800, 13, 512, 16, 3, True, 6),
    (64800, 3, 1024, 16, 13, False, 6), (1800, 13, 512, 16, 3, True, 1),
    (1800, 3, 1024, 16, 13, False, 1), (1, 3, 1024, 16, 13, False, 1),
])
def test_column_chunks_cover_every_column_once_under_the_cap(M, K, D, h, Q, with_lnk, n):
    chunks = resampler.perceiver_column_chunks(M, K, D, D, Q, h, D, with_lnk)
    per_col = resampler.perceiver_column_bytes(K, D, D, Q, h, D, with_lnk)
    assert len(chunks) == n
    seen = np.zeros(M, np.int32)
    for m0, cols in chunks:
        assert cols > 0 and cols * per_col <= resampler.PERCEIVER_SCRATCH_BYTES
        seen[m0:m0 + cols] += 1
    assert seen.min() == 1 and seen.max() == 1
    assert all(cols == chunks[0][1] and cols % 128 == 0 for _, cols in chunks[:-1])
    assert chunks[0][1] == max(cols for _, cols in chunks)  # the scratch is sized by the first


def test_column_chunks_refuse_a_cap_below_128_columns():
    per_col = resampler.perceiver_column_bytes(13, 512, 512, 3, 16, 512, False)
    assert resampler.perceiver_column_chunks(1000, 13, 512, 512, 3, 16, 512, False,
                                             cap=128 * per_col) == [
        (m0, min(128, 1000 - m0)) for m0 in range(0, 1000, 128)]
    with pytest.raises(ValueError, match="scratch"):
        resampler.perceiver_column_chunks(1000, 13, 512, 512, 3, 16, 512, False,
                                          cap=127 * per_col)


# ------------------------------------------------------------------------------ shape rules


@pytest.mark.parametrize("K,M,D,h,dh,Q,D_out", [
    (13, 64800, 512, 16, 32, 3, 512), (3, 64800, 1024, 16, 64, 13, 1024),
    (13, 1800, 512, 16, 32, 3, 512), (3, 1, 1024, 16, 64, 13, 1024),
    (13, 100, 256, 8, 32, 3, 2048),
])
def test_perceiver_shape_rule_takes_the_models_shapes(K, M, D, h, dh, Q, D_out):
    resampler.check_perceiver_shape(K, M, D, h, dh, Q, D_out, True)


@pytest.mark.parametrize("K,M,D,h,dh,Q,D_out,value_bf16,word", [
    (13, 64800, 512, 16, 32, 3, 512, False, "value_bf16=False"),
    (13, 64800, 512, 8, 64, 3, 512, True, "dh=64"),
    (3, 64800, 1024, 32, 32, 13, 1024, True, "K=3"),
    (5, 64800, 512, 16, 32, 3, 512, True, "K=5"),
    (13, 64800, 544, 16, 32, 3, 512, True, "D=544"),
    (13, 64800, 512, 12, 32, 3, 512, True, "inner=384"),
    (3, 64800, 1024, 64, 64, 13, 1024, True, "inner=4096"),
    (13, 64800, 512, 16, 32, 3, 768, True, "D_out=768"),
    (13, 0, 512, 16, 32, 3, 512, True, "M=0"),
])
def test_perceiver_shape_rule_refuses_other_shapes(K, M, D, h, dh, Q, D_out, value_bf16, word):
    with pytest.raises(ValueError) as e:
        resampler.check_perceiver_shape(K, M, D, h, dh, Q, D_out, value_bf16)
    assert word in str(e.value)


@pytest.mark.parametrize("M,D", [(259200, 512), (64800, 1024), (16200, 2048), (7200, 512),
                                 (1, 512)])
def test_linear_shape_rule_takes_the_backbones_shapes(M, D):
    mlp.check_linear_shape(M, D)


@pytest.mark.parametrize("M,D,word", [
    (1000, 256, "D=256"), (1000, 768, "D=768"), (1000, 4096, "D=4096"), (0, 512, "M=0"),
    (2**24 + 1, 512, f"M={2**24 + 1}"),
])
def test_linear_shape_rule_refuses_other_shapes(M, D, word):
    with pytest.raises(ValueError) as e:
        mlp.check_linear_shape(M, D)
    assert word in str(e.value) and f"D={D}" in str(e.value)
