"""Float32 K4 (the perceiver core) and K5 (the linear AdaLN residual) with their products on the
tensor cores, each in three TF32 parts (``csrc/resampler_f32.cu`` and ``csrc/mlp_f32.cu`` on
``csrc/gemm_tf32x3_sm90.cuh``), on the CPU.

* A mirror of float32 K4's launches with its products as the kernel takes them (``a_hi w_hi +
  a_hi w_lo + a_lo w_hi``, the parts from ``tf32_split``: ``tests/test_torch_f32_gemm.py::
  tf32x3_matmul``): the fold in float64, one product of the chunk's context rows with ``[Wv |
  Wkq | Wc]`` (the logit columns padded with zeros to 128, ``Wc`` with ``ln_k`` only, kept as
  each row's sums of squares per tile), the level-order mix in f32, the out-projection, the row
  kernel; chunk by chunk of columns (the extension of ``tests/test_torch_f32.py::
  perceiver_core_f32_mirror``). Against the JAX package's ``perceiver_core_fused(value_bf16=
  False)`` in interpret mode at both (K, dh), with and without ``ln_k``, over three chunks of
  columns, at ``chip_smoke.py``'s float32 bound 1e-4 by its measure (the branch error over the
  query residual).
* The same for K5 against ``linear_adaln_residual_fused`` in float32 at 9e-5 (the branch error
  over the shortcut).
* The one-part mirrors (``a_hi w_hi``: a kernel without the split) fail those bounds.
* The ring's grouped schedule (``gemm_tf32x3_sm90.cuh``: ``make_sched`` and ``Unit``): every
  output row of every group is written by exactly one row tile, no tile straddles two groups.
* The float32 wrappers allocate one split scratch a call of the stated size and hand it to the
  C entry before the stream; the bf16 entries get none; the float32 argument lists are the bf16
  ones with the scratch pointers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.ops.mlp import linear_adaln_residual_fused
from aurora_tpu.ops.resampler import make_q_major_blockdiag, perceiver_core_fused
from aurora_tpu_torch.ops import mlp, resampler
from aurora_tpu_torch.tools import branch_err
from tests.test_torch_f32 import _k4_args, _t, entries  # noqa: F401
from tests.test_torch_f32_gemm import tf32x3_matmul
from tests.test_torch_resampler_redesign import fold_logit_weights

TOL_K4, TOL_K5 = 1e-4, 9e-5  # chip_smoke.TOL_F32 of perceiver_core, linear_adaln_residual


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, the caller's count restored after (the suite runs six workers
    at once; see ``tests/test_torch_training.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------------------ K4


def perceiver_core_tf32x3_mirror(ctx, wk, wv, qh, wout, ln1_w, ln1_b, queries, *, scale,
                                 ln_eps=1e-5, lnk=None, cap=resampler.PERCEIVER_SCRATCH_BYTES,
                                 parts=3):
    """K4's float32 launches in PyTorch, chunk by chunk of columns, with the products in
    ``parts`` TF32 parts: the fold (f64 sums into f32 weights), the context product against
    ``[Wv | Wkq | Wc]`` (v, then the logits over their columns padded to 128; with ``lnk`` each
    row's sums of squares of ``ctx @ Wc`` per 128-column tile, then over the tiles, for
    ``rstd``), the softmax over the levels, the level-order mix, the out-projection and the row
    kernel with the query of period Q as the residual."""
    K, M, D = ctx.shape
    Q, h, dh = qh.shape
    inner, D_out, QH = h * dh, wout.shape[1], Q * h
    NLP = resampler.perceiver_logit_columns(QH)
    wkq, wc, const = fold_logit_weights(wk, qh, scale, lnk)
    w_ctx = torch.zeros(D, inner + NLP + (inner if lnk is not None else 0))
    w_ctx[:, :inner] = wv
    w_ctx[:, inner:inner + QH] = wkq
    if lnk is not None:
        w_ctx[:, inner + NLP:] = wc
    tile = min(128, inner)
    out = torch.empty(M, Q, D_out)
    chunks = resampler.perceiver_column_chunks(M, K, D, inner, Q, h, D_out, lnk is not None, cap,
                                               f32=True)
    for m0, mc in chunks:
        y = tf32x3_matmul(ctx[:, m0:m0 + mc].reshape(K * mc, D), w_ctx, parts)
        v, logits = y[:, :inner], y[:, inner:inner + QH]
        if lnk is not None:
            sq = y[:, inner + NLP:].square().reshape(K * mc, inner // tile, tile).sum(-1).sum(-1)
            logits = torch.rsqrt(sq / inner + 1e-5)[:, None] * logits + const
        v = v.reshape(K, mc, 1, h, dh)
        w = torch.softmax(logits.reshape(K, mc, Q, h), dim=0)
        o = w[0][..., None] * v[0]
        for kk in range(1, K):
            o = o + w[kk][..., None] * v[kk]
        y = tf32x3_matmul(o.reshape(mc * Q, inner), wout, parts)
        mean = y.mean(-1, keepdim=True)
        rstd = torch.rsqrt((y - mean).square().mean(-1, keepdim=True) + ln_eps)
        res = queries[torch.arange(mc * Q) % Q]
        out[m0:m0 + mc] = (res + ((y - mean) * rstd * ln1_w + ln1_b)).reshape(mc, Q, D_out)
    return out


# (K, dh, Q, ln_k) of the aggregation and the de-aggregation
K4_CASES = [(K, dh, Q, lnk) for K, dh, Q in ((13, 32, 3), (3, 64, 5)) for lnk in (False, True)]
K4_IDS = [f"{'agg' if K == 13 else 'de-agg'}-{'ln_k' if lnk else 'plain_k'}"
          for K, _, _, lnk in K4_CASES]


@pytest.fixture(scope="module")
def pallas_k4():
    """The JAX package's float32 K4 in interpret mode at both (K, dh), with and without
    ``ln_k``, 300 columns of two heads; the inputs as float32 tensors beside each."""
    refs = {}
    for case in K4_CASES:
        K, dh, Q, with_lnk = case
        rng = np.random.default_rng(7)
        M, h = 300, 2
        D = inner = h * dh
        a = dict(ctx=rng.standard_normal((K, M, D)), wk=0.3 * rng.standard_normal((D, inner)),
                 wv=0.3 * rng.standard_normal((D, inner)), qh=rng.standard_normal((Q, h, dh)),
                 wout=0.3 * rng.standard_normal((inner, D)),
                 ln1_w=1 + 0.1 * rng.standard_normal(D), ln1_b=0.1 * rng.standard_normal(D),
                 queries=rng.standard_normal((Q, D)))
        lnk = (1 + 0.2 * rng.standard_normal(inner), 0.2 * rng.standard_normal(inner))
        j = {k: jnp.asarray(v, jnp.float32) for k, v in a.items()}
        jl = [jnp.asarray(v, jnp.float32) for v in lnk] if with_lnk else [None, None]
        want = perceiver_core_fused(
            j["ctx"], j["wk"], None, j["wv"], None, make_q_major_blockdiag(j["qh"], h), j["wout"],
            None, j["ln1_w"], j["ln1_b"], j["queries"], *jl, num_heads=h, scale=dh**-0.5,
            value_bf16=False, interpret=True)
        t = {k: torch.from_numpy(v).float() for k, v in a.items()}
        tl = tuple(torch.from_numpy(v).float() for v in lnk) if with_lnk else None
        refs[case] = t, tl, torch.from_numpy(np.array(want))
    return refs


def _k4_err(pallas_k4, case, parts):
    t, tl, want = pallas_k4[case]
    K, dh, Q, with_lnk = case
    M, (D, inner), h = t["ctx"].shape[1], t["wk"].shape, t["qh"].shape[1]
    per = resampler.perceiver_column_bytes(K, D, inner, Q, h, D, with_lnk, f32=True)
    cap = 128 * per + resampler.perceiver_split_bytes(D, inner, Q * h, D, with_lnk)
    assert len(resampler.perceiver_column_chunks(M, K, D, inner, Q, h, D, with_lnk, cap,
                                                 f32=True)) == 3  # 128 columns a chunk
    got = perceiver_core_tf32x3_mirror(**t, scale=dh**-0.5, lnk=tl, cap=cap, parts=parts)
    return branch_err(got, want, t["queries"][None])[1]


@pytest.mark.parametrize("case", K4_CASES, ids=K4_IDS)
def test_k4_three_part_mirror_matches_pallas(pallas_k4, case):
    assert _k4_err(pallas_k4, case, parts=3) < TOL_K4


@pytest.mark.parametrize("case", K4_CASES, ids=K4_IDS)
def test_k4_one_part_mirror_fails_the_bound(pallas_k4, case):
    """``a_hi w_hi`` alone, what a kernel without the split computes: TF32's 11 bits show."""
    assert _k4_err(pallas_k4, case, parts=1) > TOL_K4


# ------------------------------------------------------------------------------ K5


def linear_adaln_residual_tf32x3_mirror(x, w, b, shortcut, shift, scale, scale_bias, parts=3):
    """K5's float32 launches in PyTorch: ``x W + b`` in ``parts`` TF32 parts, then the row
    kernel with the shortcut as the residual and FiLM row ``row // L``."""
    B, L, D = x.shape
    y = tf32x3_matmul(x.reshape(B * L, D), w, parts) + b
    f = torch.arange(B * L) // L
    mean = y.mean(-1, keepdim=True)
    rstd = torch.rsqrt((y - mean).square().mean(-1, keepdim=True) + 1e-5)
    out = shortcut.reshape(B * L, D) + ((y - mean) * rstd * (scale_bias + scale[f]) + shift[f])
    return out.reshape(x.shape)


@pytest.fixture(scope="module")
def pallas_k5():
    """The JAX package's float32 K5 in interpret mode: two batch elements of 200 rows, D = 128
    (a tile of 128 rows holds rows of both FiLM rows), scale_bias 0.5."""
    rng = np.random.default_rng(8)
    B, L, D = 2, 200, 128
    a = [rng.standard_normal((B, L, D)), 0.1 * rng.standard_normal((D, D)),
         0.05 * rng.standard_normal(D), rng.standard_normal((B, L, D)),
         0.1 * rng.standard_normal((B, D)), rng.standard_normal((B, D))]
    want = linear_adaln_residual_fused(*[jnp.asarray(v, jnp.float32) for v in a], scale_bias=0.5,
                                       interpret=True)
    return [torch.from_numpy(v).float() for v in a], torch.from_numpy(np.array(want))


@pytest.mark.parametrize("parts", [3, 1], ids=["three_parts", "one_part"])
def test_k5_mirror_against_pallas(pallas_k5, parts):
    """Three parts within 9e-5 of the JAX kernel; one part (``a_hi w_hi``) fails it."""
    t, want = pallas_k5
    err = branch_err(linear_adaln_residual_tf32x3_mirror(*t, 0.5, parts=parts), want, t[3])[1]
    assert err < TOL_K5 if parts == 3 else err > TOL_K5


# ------------------------------------------------------------------------------ the ring's rows

BM, BN = 128, 128


def _units(groups, per, N):
    """``gemm_tf32x3_sm90.cuh``'s ``make_sched`` and ``Unit``: (group, first row, first column)
    of each unit, in unit order."""
    tpg, n_tiles = -(-per // BM), N // BN
    for u in range(groups * tpg * n_tiles):
        ti = u // n_tiles
        g = ti // tpg
        yield g, (ti - g * tpg) * BM, (u - ti * n_tiles) * BN


@pytest.mark.parametrize("groups, per", [(13, 12960), (3, 7296), (13, 300), (1, 259200),
                                         (3, 128), (1, 77)])
def test_grouped_tiles_cover_each_row_once(groups, per):
    """Each group's rows are read from its own level (a tile's rows never reach into the next
    group's output rows) and every (output row, column tile) is stored exactly once."""
    N = 256
    stored = np.zeros((groups * per, N // BN), dtype=np.int32)
    for g, m0, n0 in _units(groups, per, N):
        assert 0 <= m0 < per
        rows = np.arange(m0, m0 + BM)
        keep = rows[rows < per]  # rows past the group's end are loaded, never stored
        stored[g * per + keep, n0 // BN] += 1
    assert (stored == 1).all()


# ------------------------------------------------------------------------------ the scratch


def _recorded_empty(monkeypatch):
    empty, sizes = torch.empty, []

    def recording_empty(*shape, **kw):
        t = empty(*shape, **kw)
        sizes.append((t.numel(), t.dtype, t.data_ptr()))
        return t

    monkeypatch.setattr(torch, "empty", recording_empty)
    return sizes


@pytest.mark.parametrize("with_lnk", [False, True], ids=["plain_k", "ln_k"])
@pytest.mark.parametrize("value_bf16", [False, True], ids=["f32", "bf16_values"])
def test_k4_one_split_scratch_a_call(entries, monkeypatch, value_bf16, with_lnk):
    """A float32 call allocates one split scratch of perceiver_split_bytes and passes it before
    the stream: ``2 (inner + 128 + inner (ln_k)) D + 2 D_out inner`` f32 at the aggregation's
    widths; a bf16-values call allocates none."""
    a = _k4_args()
    lnk = (_t(512), _t(512)) if with_lnk else (None, None)
    sizes = _recorded_empty(monkeypatch)
    resampler._perceiver_core_launch(*a.values(), 32**-0.5, 1e-5, value_bf16, *lnk)
    monkeypatch.undo()
    ((lib, fn, args),) = entries.calls
    n = resampler.perceiver_split_bytes(512, 512, 48, 512, with_lnk) // 4
    assert n == 2 * (512 + 128 + (512 if with_lnk else 0)) * 512 + 2 * 512 * 512
    split = [s for s in sizes if s[:2] == (n, torch.float32)]
    if value_bf16:
        assert (lib, fn) == ("resampler", "perceiver_core") and not split
        assert len(args) == len(resampler._PERCEIVER_CORE_ARGS)
    else:
        assert (lib, fn) == ("resampler_f32", "perceiver_core_f32")
        assert [s[2] for s in split] == [args[-2]] and args[-1] == 0


@pytest.mark.parametrize("D", [256, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k5_one_split_scratch_a_call(entries, monkeypatch, dtype, D):
    """A float32 call allocates one scratch of 2 D^2 f32 (W^T's hi and lo) and passes it before
    the stream; a bf16 call allocates none and passes the bf16 entry's arguments."""
    x, sc = _t(1, 300, D, dtype=dtype), _t(1, 300, D, dtype=dtype, seed=1)
    args = (x, _t(D, D, dtype=dtype, std=0.02), _t(D), sc, _t(1, D), _t(1, D), 0.0)
    sizes = _recorded_empty(monkeypatch)
    mlp._linear_adaln_residual_launch(*args)
    monkeypatch.undo()
    ((lib, fn, a),) = entries.calls
    split = [s for s in sizes if s[:2] == (2 * D * D, torch.float32)]
    if dtype == torch.float32:
        assert (lib, fn) == ("mlp_f32", "linear_adaln_residual_f32")
        assert len(a) == 15 and [s[2] for s in split] == [a[13]] and a[14] == 0
    else:
        assert (lib, fn) == ("mlp", "linear_adaln_residual")
        assert len(a) == 14 and not split


def test_a_given_split_scratch_is_checked(entries):
    D = 256
    x, sc = _t(1, 300, D), _t(1, 300, D, seed=1)
    ops = {"w": _t(D, D, std=0.02), "b": _t(D), "shift": _t(1, D), "scale": _t(1, D)}
    fn = mlp._linear_entry(x)
    ws = torch.empty(2 * D * D)
    mlp._linear_adaln_residual_call(fn, x, ops, sc, 0.0, torch.empty_like(x), wsplit=ws)
    assert entries.calls[-1][2][13] == ws.data_ptr()
    for bad in (torch.empty(2 * D * D - 1), torch.empty(2 * D * D, dtype=torch.float64)):
        with pytest.raises(ValueError, match="wsplit"):
            mlp._linear_adaln_residual_call(fn, x, ops, sc, 0.0, torch.empty_like(x), wsplit=bad)
    a = _k4_args()
    k4 = resampler._lib.kernel("resampler_f32", "perceiver_core_f32",
                               resampler._PERCEIVER_CORE_F32_ARGS)
    with pytest.raises(ValueError, match="wsplit"):
        resampler._perceiver_core_f32_call(k4, *a.values(), 32**-0.5, 1e-5, None,
                                           wsplit=torch.empty(7))


def test_f32_arguments_are_the_bf16_ones_and_the_scratch():
    P = resampler._P
    bf, f32 = mlp._LINEAR_ARGS, mlp._LINEAR_F32_ARGS
    assert f32[:-2] == bf[:-1] and f32[-2:] == [P, P]  # the scratch, then the stream
    bf, f32 = resampler._PERCEIVER_CORE_ARGS, resampler._PERCEIVER_CORE_F32_ARGS
    # pointers (inputs with the three biases, the chunk's scratch with the bias row, out), the
    # bf16 entry's sizes and scalars, then the weights' split scratch and the stream
    assert f32[:19] == [P] * 19 and f32[19:29] == bf[-11:-1] and f32[29:] == [P, P]
