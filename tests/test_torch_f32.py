"""The float32 forms of K2, K3 and K4 (the facades' default config) on the CPU.

* The wrappers with a stand-in launch (``_lib.kernel`` returns a recorder of the C entry's
  arguments; the device check and the stream stand in too): float32 tokens reach the float32
  entries (``window_attention_f32``, ``mlp_rows_f32``, ``perceiver_core_f32``) with the
  float32 weights as stored (no cast, no copy), 4-byte row offsets, the rows per chunk of
  ``mlp_row_chunks`` halved and no statistics scratch, each launch tallied by its output's
  dtype and width; bf16 tokens still reach the bf16 entries as before. The float32 forms of
  K5, K6, K7 and K8 are held in ``tests/test_torch_f32_windows.py``.
* PyTorch mirrors of the float32 kernels' arithmetic against the JAX package's Pallas kernels
  in float32, run in interpret mode (as ``tests/test_torch_kernels.py`` runs them): K4's fold
  (the queries folded into the key weights, with ``ln_k`` the centred weights and the sums of
  squares per 128-column tile), chunk by chunk of columns; K3 chunk by chunk of rows; K2 with
  each window's rows read in place through the 5D grid's row of each token (the CUDA core's
  ``Grid5d::row``, which must be ``window_partition``'s order) and the core's order of work
  (``tests/test_torch_f32_windows.py::window_core_f32_mirror``). Bounds as max |error| / max
  |reference|: 1e-5 (float32 summation order), K3 5e-5 (the JAX kernel's erf polynomial,
  within 2.7e-7 of erf, scaled up by the LayerNorm; ``tests/test_torch_kernels.py``).
* The slice: ``AuroraSmallPretrained`` in its default config (float32, its config cut to
  widths of 64 on both sides), the same float32 weights, two roll-out steps, the port
  against the JAX package: mean relative error per variable <= 1e-5 (float32 summation
  orders of two programs; a bf16 or TF32 product anywhere gives 1e-3 and more).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import aurora_tpu
import aurora_tpu_torch as port
from aurora_tpu.model.swin3d import _attn_windows_5d_fused_pallas
from aurora_tpu.ops.masks import window_group_ids
from aurora_tpu.ops.mlp import mlp_adaln_residual_fused
from aurora_tpu.ops.resampler import make_q_major_blockdiag, perceiver_core_fused
from aurora_tpu_torch.model.config import AuroraConfig
from aurora_tpu_torch.ops import _lib, mlp, resampler, window_attention
from aurora_tpu_torch.ops.window_attention import window_partition
from tests.conftest import make_batch
from tests.test_torch_resampler_redesign import fold_logit_weights
from tests.test_torch_support import batch_errors, max_rel, seeded_matched_models, torch_batch


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, the caller's count restored after (the suite runs six workers
    at once; see ``tests/test_torch_training.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------------------ stand-in launches


class _Entries:
    """``_lib.kernel``'s stand-in: each C entry a recorder of its arguments, returning 0."""

    def __init__(self):
        self.calls = []

    def kernel(self, lib, fn, argtypes):
        def entry(*args):
            assert len(args) == len(argtypes), (lib, fn, len(args), len(argtypes))
            self.calls.append((lib, fn, args))
            return 0

        return entry


def _require_anywhere(t, name, dtype, shape=None):
    """``_lib.require`` without its device check (the CPU stands in for the card)."""
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@pytest.fixture
def entries(monkeypatch):
    e = _Entries()
    monkeypatch.setattr(_lib, "kernel", e.kernel)
    monkeypatch.setattr(_lib, "require", _require_anywhere)
    monkeypatch.setattr(_lib, "stream", lambda t: 0)
    monkeypatch.setattr(_lib, "LAUNCHES", dict.fromkeys(_lib.LAUNCHES, 0))
    monkeypatch.setattr(_lib, "LAUNCHES_BY", {})
    return e


def _t(*shape, dtype=torch.float32, std=1.0, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(std * rng.standard_normal(shape)).float()).to(dtype)


# (rows, D, hidden): chunks of the 256 MB hidden scratch, 65536 rows in f32 and 131072 in bf16
# at hidden 1024. The tokens are never touched by the stand-in (torch.empty: no pages used).
K3_ROWS, K3_D, K3_HD = 200_000, 256, 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k3_tokens_reach_the_entry_of_their_dtype(entries, dtype):
    x = torch.empty(1, K3_ROWS, K3_D, dtype=dtype)
    w1, w2 = _t(K3_D, K3_HD, dtype=dtype), _t(K3_HD, K3_D, dtype=dtype, seed=1)
    b1, b2 = _t(K3_HD), _t(K3_D)
    shift, scale = _t(1, K3_D), _t(1, K3_D)
    out = mlp._mlp_adaln_residual_launch(x, w1, b1, w2, b2, shift, scale, 0.0, 1e-5)
    assert out.dtype == dtype and out.shape == x.shape
    elem = x.element_size()
    per = (256 << 20) // (elem * K3_HD) // 128 * 128
    assert per == (65536 if dtype == torch.float32 else 131072)
    want_chunks = [(r0, min(per, K3_ROWS - r0)) for r0 in range(0, K3_ROWS, per)]
    assert mlp.mlp_row_chunks(K3_ROWS, K3_HD, elem=elem) == want_chunks
    lib, fn = ("mlp_f32", "mlp_rows_f32") if dtype == torch.float32 else ("mlp", "mlp_rows")
    assert [c[:2] for c in entries.calls] == [(lib, fn)] * len(want_chunks)
    for (_, _, a), (r0, rows) in zip(entries.calls, want_chunks):
        assert a[0] == x.data_ptr() + elem * r0 * K3_D  # the chunk's first row
        assert a[6] == out.data_ptr() + elem * r0 * K3_D
        assert (a[1], a[3]) == (w1.data_ptr(), w2.data_ptr())  # the weights as stored
        assert (a[11], a[12], a[13]) == (rows, r0, K3_ROWS)  # rows, row_base, rows a FiLM row
        assert (a[7] is None) == (dtype == torch.float32)  # the f32 row kernel: no statistics
    # float32: the weights' split scratch before the stream, one for all the chunks (the
    # launch at row_base 0 writes it); bf16: no such argument
    split = {a[18] for _, _, a in entries.calls} if dtype == torch.float32 else set()
    assert [len(a) for _, _, a in entries.calls] == [19 + len(split)] * len(want_chunks)
    assert len(split) == (1 if dtype == torch.float32 else 0) and None not in split
    assert _lib.LAUNCHES["mlp_adaln_residual"] == 1
    assert _lib.LAUNCHES_BY == {("mlp_adaln_residual", str(dtype)[6:], K3_D): 1}


def test_k3_f32_weights_stored_in_bf16_are_widened_not_the_tokens_narrowed(entries):
    """A bf16-stored weight next to float32 tokens goes to the float32 entry as an f32 copy."""
    x = _t(1, 300, 256)
    w1 = _t(256, 1024, dtype=torch.bfloat16)
    mlp._mlp_adaln_residual_launch(x, w1, _t(1024), _t(1024, 256), _t(256), _t(1, 256),
                                   _t(1, 256), 0.0, 1e-5)
    ((lib, fn, a),) = entries.calls
    assert (lib, fn) == ("mlp_f32", "mlp_rows_f32") and a[0] == x.data_ptr()
    assert a[1] != w1.data_ptr()


WS, HEADS, D2 = (2, 6, 12), 4, 256  # one window of 144 tokens a batch element, head dim 64


@pytest.mark.parametrize("tail", [True, False], ids=["tail", "no_tail"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k2_tokens_reach_the_entry_of_their_dtype(entries, dtype, tail):
    xp = _t(2, 2, 6, 12, D2, dtype=dtype)
    wqkv, bqkv = _t(D2, 3 * D2, dtype=dtype, std=0.02), _t(3 * D2, dtype=dtype)
    wproj = _t(D2, D2, dtype=dtype, std=0.02)
    tl = (wproj, _t(D2), _t(2, D2), _t(2, D2)) if tail else (None,) * 4
    groups = window_group_ids(2, 6, 12, WS, (1, 3, 6))
    out = window_attention._window_attention_tail_launch(xp, wqkv, bqkv, groups, WS, HEADS, *tl,
                                                         1e-5)
    assert out.dtype == dtype and out.shape == xp.shape
    ((lib, fn, a),) = entries.calls
    want = "window_attention_f32" if dtype == torch.float32 else "window_attention"
    assert (lib, fn) == (want, want)
    assert a[0] == xp.data_ptr()
    assert (a[1], a[2]) == (wqkv.data_ptr(), bqkv.data_ptr())  # as stored
    if tail:
        assert a[4] == wproj.data_ptr()
        # the f32 row kernel takes its own statistics; bf16's come from proj's epilogue
        assert (a[10] is None) == (dtype == torch.float32)
    else:
        assert a[4] is None and a[10] is None and a[11] is None
    assert a[12:22] == (2, 1, 2, 6, 12, D2, *WS, HEADS)
    assert _lib.LAUNCHES["window_attention"] == 1
    assert _lib.LAUNCHES_BY == {("window_attention", str(dtype)[6:], D2): 1}


def _k4_args(dtype_w=torch.float32, M=200, K=13, h=16, dh=32, Q=3):
    D = inner = h * dh
    return dict(ctx=_t(K, M, D), wk=_t(D, inner, std=0.05), wv=_t(D, inner, dtype=dtype_w, std=0.05),
                qh=_t(Q, h, dh), wout=_t(inner, D, dtype=dtype_w, std=0.05), ln1_w=_t(D),
                ln1_b=_t(D), queries=_t(Q, D))


@pytest.mark.parametrize("value_bf16", [False, True], ids=["f32", "bf16_values"])
@pytest.mark.parametrize("with_lnk", [False, True], ids=["plain_k", "ln_k"])
def test_k4_reaches_the_entry_of_its_form(entries, value_bf16, with_lnk):
    a = _k4_args()
    lnk = (_t(512), _t(512)) if with_lnk else (None, None)
    out = resampler._perceiver_core_launch(*a.values(), 32**-0.5, 1e-5, value_bf16, *lnk)
    assert out.dtype == (torch.bfloat16 if value_bf16 else torch.float32)
    assert out.shape == (200, 3, 512)
    ((lib, fn, args),) = entries.calls
    if value_bf16:
        assert (lib, fn) == ("resampler", "perceiver_core")
        assert args[2] != a["wv"].data_ptr()  # cast to bf16
        return
    assert (lib, fn) == ("resampler_f32", "perceiver_core_f32")
    assert args[0] == a["ctx"].data_ptr()
    assert (args[1], args[2], args[4]) == (a["wk"].data_ptr(), a["wv"].data_ptr(),
                                           a["wout"].data_ptr())  # the weights as stored
    # lnk_w, cst and sq only with ln_k; no bias (bk, bv, bout) given, so none and no bias row;
    # the split scratch before the stream
    assert (args[8] is None) == (not with_lnk) and (args[13] is None) == (not with_lnk)
    assert (args[16] is None) == (not with_lnk)
    assert args[10:13] == (None, None, None) and args[14] is None
    assert args[18] == out.data_ptr()
    assert args[19:27] == (13, 200, 200, 512, 16, 32, 3, 512)
    assert args[29] is not None and args[30] == 0
    assert _lib.LAUNCHES["perceiver_core"] == 1
    assert _lib.LAUNCHES_BY == {("perceiver_core", "float32", 512): 1}


def test_k4_f32_chunks_count_its_own_scratch():
    """The float32 form's scratch a column: f32 v and the logits over their Q h columns padded
    to 128, with ln_k the sums of squares, f32 o; beside it once a call the weights' split (hi
    and lo of [Wv | Wkq | Wc]^T and of Wout^T); the chunks cover every column once under the
    cap, the split included."""
    K, D, inner, Q, h, D_out = 13, 512, 512, 3, 16, 512
    per = resampler.perceiver_column_bytes(K, D, inner, Q, h, D_out, False, f32=True)
    assert per == K * inner * 4 + K * 128 * 4 + Q * inner * 4
    lnk = resampler.perceiver_column_bytes(K, D, inner, Q, h, D_out, True, f32=True)
    assert lnk - per == K * (inner // 128) * 4
    split = resampler.perceiver_split_bytes(D, inner, Q * h, D_out, True)
    assert split == 4 * (2 * (inner + 128 + inner) * D + 2 * D_out * inner)
    chunks = resampler.perceiver_column_chunks(64800, K, D, inner, Q, h, D_out, True, f32=True)
    assert chunks[0][0] == 0 and sum(c for _, c in chunks) == 64800
    assert all(a + n == b for (a, n), (b, _) in zip(chunks, chunks[1:]))
    assert chunks[0][1] * lnk + split <= resampler.PERCEIVER_SCRATCH_BYTES


# ------------------------------------------------------------------------------ mirrors


def grid5d_rows(B: int, Cp: int, Hp: int, Wp: int, ws) -> torch.Tensor:
    """``csrc/window_attention_f32.cu``'s ``Grid5d::row``: the row of the padded grid
    ``(B, Cp, Hp, Wp)`` that token ``t`` of window ``w`` reads, ``(B nW, N)``."""
    nC1, nH1, nW1 = Cp // ws[0], Hp // ws[1], Wp // ws[2]
    nW, N = nC1 * nH1 * nW1, ws[0] * ws[1] * ws[2]
    window = torch.arange(B * nW)[:, None]
    t = torch.arange(N)[None]
    b, r = window // nW, window % nW
    c1, h1, w1 = r // (nH1 * nW1), (r // nW1) % nH1, r % nW1
    wc, wh, ww = t // (ws[1] * ws[2]), (t // ws[2]) % ws[1], t % ws[2]
    return ((b * Cp + c1 * ws[0] + wc) * Hp + h1 * ws[1] + wh) * Wp + w1 * ws[2] + ww


def test_the_cores_rows_are_window_partitions_order():
    B, Cp, Hp, Wp = 2, 4, 12, 24
    for ws in ((2, 6, 12), (2, 3, 4), (1, 12, 12)):
        idx = torch.arange(B * Cp * Hp * Wp).reshape(B, Cp, Hp, Wp, 1)
        want = window_partition(idx, ws).reshape(-1, ws[0] * ws[1] * ws[2])
        assert torch.equal(grid5d_rows(B, Cp, Hp, Wp, ws), want)


def _ln_film_residual(y, x, shift, scale, rows_per_film):
    """The f32 row kernel: a two-pass LayerNorm over each row, FiLM row ``row //
    rows_per_film``, the residual added last."""
    mean = y.mean(-1, keepdim=True)
    rstd = torch.rsqrt((y - mean).square().mean(-1, keepdim=True) + 1e-5)
    f = torch.arange(y.shape[0]) // rows_per_film
    return x + ((y - mean) * rstd * scale[f] + shift[f])


def window_attention_f32_mirror(xp, wqkv, bqkv, groups, ws, heads, tail):
    """K2's float32 launches in PyTorch: qkv over the rows in their stored order, the core
    (``tests/test_torch_f32_windows.py::window_core_f32_mirror``, the kernel's order of work)
    per (window, head) on rows read through :func:`grid5d_rows`, each result to its token's
    own row; with the tail proj and the row kernel."""
    from tests.test_torch_f32_windows import window_core_f32_mirror

    B, Cp, Hp, Wp, D = xp.shape
    x = xp.reshape(-1, D)
    rows = grid5d_rows(B, Cp, Hp, Wp, ws)
    nW = rows.shape[0] // B
    attn = window_core_f32_mirror(x @ wqkv + bqkv, torch.empty_like(x), rows, groups, nW, heads)
    if tail is None:
        return attn.reshape(xp.shape)
    wproj, bproj, shift, scale = tail
    out = _ln_film_residual(attn @ wproj + bproj, x, shift, scale, nW * rows.shape[1])
    return out.reshape(xp.shape)


@pytest.mark.parametrize("tail", [True, False], ids=["tail", "no_tail"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_k2_f32_mirror_matches_pallas(masked, tail):
    rng = np.random.default_rng(3)
    ws, ss, heads = (2, 3, 4), (1, 1, 2), 2
    C, H, W, Cp, Hp, Wp, B, D = 4, 7, 10, 4, 9, 12, 2, 16  # padded: pad tokens in windows
    a = [rng.standard_normal((B, Cp, Hp, Wp, D)), 0.2 * rng.standard_normal((D, 3 * D)),
         0.05 * rng.standard_normal(3 * D), 0.2 * rng.standard_normal((D, D)),
         0.05 * rng.standard_normal(D), rng.standard_normal((B, D)),
         0.3 * rng.standard_normal((B, D))]
    groups = window_group_ids(C, H, W, ws, ss) if masked else None
    j = [jnp.asarray(v, jnp.float32) for v in a]
    t = [torch.from_numpy(v).float() for v in a]
    want = _attn_windows_5d_fused_pallas(j[0], j[1], j[2], heads, groups, ws, interpret=True,
                                         tail=tuple(j[3:]) if tail else None)
    got = window_attention_f32_mirror(t[0], t[1], t[2], groups, ws, heads,
                                      tuple(t[3:]) if tail else None)
    assert max_rel(got, want) < 1e-5


def mlp_f32_mirror(x, w1, b1, w2, b2, shift, scale, scale_bias, cap):
    """K3's float32 launches in PyTorch, chunk of rows by chunk of rows as
    ``mlp_row_chunks(..., elem=4)`` cuts them: fc1 with the bias and the exact erf GELU, fc2
    with the bias, the row kernel with FiLM row ``(row_base + row) // L``."""
    B, L, D = x.shape
    xr = x.reshape(B * L, D)
    out = torch.empty_like(xr)
    for r0, rows in mlp.mlp_row_chunks(B * L, w1.shape[1], cap, elem=4):
        xc = xr[r0:r0 + rows]
        y = F.gelu(xc @ w1 + b1) @ w2 + b2
        mean = y.mean(-1, keepdim=True)
        rstd = torch.rsqrt((y - mean).square().mean(-1, keepdim=True) + 1e-5)
        f = (r0 + torch.arange(rows)) // L
        out[r0:r0 + rows] = xc + ((y - mean) * rstd * (scale_bias + scale[f]) + shift[f])
    return out.reshape(x.shape)


def test_k3_f32_mirror_matches_pallas():
    """Two batch elements of 200 rows in chunks of 128 (a chunk straddles the FiLM rows)."""
    rng = np.random.default_rng(4)
    B, L, D, Hd = 2, 200, 32, 128
    a = [rng.standard_normal((B, L, D)), 0.2 * rng.standard_normal((D, Hd)),
         0.05 * rng.standard_normal(Hd), 0.2 * rng.standard_normal((Hd, D)),
         0.05 * rng.standard_normal(D), rng.standard_normal((B, D)),
         0.3 * rng.standard_normal((B, D))]
    want = mlp_adaln_residual_fused(*[jnp.asarray(v, jnp.float32) for v in a], scale_bias=0.5,
                                    interpret=True)
    t = [torch.from_numpy(v).float() for v in a]
    cap = 128 * Hd * 4  # 128 rows a chunk: four chunks
    assert len(mlp.mlp_row_chunks(B * L, Hd, cap, elem=4)) == 4
    got = mlp_f32_mirror(*t, 0.5, cap)
    assert max_rel(got, want) < 5e-5


def perceiver_core_f32_mirror(ctx, wk, wv, qh, wout, ln1_w, ln1_b, queries, *, scale,
                              ln_eps=1e-5, lnk=None, cap=resampler.PERCEIVER_SCRATCH_BYTES):
    """K4's float32 launches in PyTorch, chunk by chunk of columns: the fold (f64 sums into
    f32 weights, the logit columns padded to a multiple of 64), the logits from it (with
    ``lnk``: ``rstd`` from each row's sums of squares of ``ctx @ Wc`` per 128-column tile,
    then over the tiles, times the raw logit, plus the folded bias), v, the softmax over the
    levels, the level-order mix, the out-projection, the row kernel with the query of period
    Q as the residual."""
    K, M, D = ctx.shape
    Q, h, dh = qh.shape
    inner, D_out, QH = h * dh, wout.shape[1], Q * h
    wkq, wc, const = fold_logit_weights(wk, qh, scale, lnk)
    wb = torch.zeros(D, -(-QH // 64) * 64)
    wb[:, :QH] = wkq
    tile = min(128, inner)
    out = torch.empty(M, Q, D_out)
    chunks = resampler.perceiver_column_chunks(M, K, D, inner, Q, h, D_out, lnk is not None, cap,
                                               f32=True)
    for m0, mc in chunks:
        x = ctx[:, m0:m0 + mc].reshape(K * mc, D)
        logits = (x @ wb)[:, :QH]
        if lnk is not None:
            sq = (x @ wc).square().reshape(K * mc, inner // tile, tile).sum(-1).sum(-1)
            logits = torch.rsqrt(sq / inner + 1e-5)[:, None] * logits + const
        v = (x @ wv).reshape(K, mc, 1, h, dh)
        w = torch.softmax(logits.reshape(K, mc, Q, h), dim=0)
        o = w[0][..., None] * v[0]
        for kk in range(1, K):
            o = o + w[kk][..., None] * v[kk]
        y = o.reshape(mc * Q, inner) @ wout
        mean = y.mean(-1, keepdim=True)
        rstd = torch.rsqrt((y - mean).square().mean(-1, keepdim=True) + ln_eps)
        res = queries[torch.arange(mc * Q) % Q]
        out[m0:m0 + mc] = (res + ((y - mean) * rstd * ln1_w + ln1_b)).reshape(mc, Q, D_out)
    return out


@pytest.mark.parametrize("with_lnk", [False, True], ids=["plain_k", "ln_k"])
@pytest.mark.parametrize("K,dh,Q", [(13, 32, 3), (3, 64, 5)], ids=["agg", "de-agg"])
def test_k4_f32_mirror_matches_pallas(K, dh, Q, with_lnk):
    """Both (K, dh) of the model, with and without ``ln_k``, 300 columns in three chunks."""
    rng = np.random.default_rng(5)
    M, h = 300, 2
    D = inner = h * dh
    a = dict(ctx=rng.standard_normal((K, M, D)), wk=0.3 * rng.standard_normal((D, inner)),
             wv=0.3 * rng.standard_normal((D, inner)), qh=rng.standard_normal((Q, h, dh)),
             wout=0.3 * rng.standard_normal((inner, D)), ln1_w=1 + 0.1 * rng.standard_normal(D),
             ln1_b=0.1 * rng.standard_normal(D), queries=rng.standard_normal((Q, D)))
    lnk = (1 + 0.2 * rng.standard_normal(inner), 0.2 * rng.standard_normal(inner))
    j = {k: jnp.asarray(v, jnp.float32) for k, v in a.items()}
    jl = [jnp.asarray(v, jnp.float32) for v in lnk] if with_lnk else [None, None]
    want = perceiver_core_fused(
        j["ctx"], j["wk"], None, j["wv"], None, make_q_major_blockdiag(j["qh"], h), j["wout"],
        None, j["ln1_w"], j["ln1_b"], j["queries"], *jl, num_heads=h, scale=dh**-0.5,
        value_bf16=False, interpret=True)
    t = {k: torch.from_numpy(v).float() for k, v in a.items()}
    tl = tuple(torch.from_numpy(v).float() for v in lnk) if with_lnk else None
    per = resampler.perceiver_column_bytes(K, D, inner, Q, h, D, with_lnk, f32=True)
    cap = 128 * per + resampler.perceiver_split_bytes(D, inner, Q * h, D, with_lnk)  # 128 a chunk
    assert len(resampler.perceiver_column_chunks(M, K, D, inner, Q, h, D, with_lnk, cap,
                                                 f32=True)) == 3
    got = perceiver_core_f32_mirror(**t, scale=dh**-0.5, lnk=tl, cap=cap)
    assert max_rel(got, want) < 1e-5


# ------------------------------------------------------------------------------ the slice

TINY = dict(embed_dim=64, num_heads=4, encoder_depths=(2, 2), decoder_depths=(2, 2),
            encoder_num_heads=(2, 4), decoder_num_heads=(4, 2))


def test_small_facade_default_config_matches_jax_in_float32(monkeypatch):
    """``AuroraSmallPretrained()`` in both packages, its default config cut to widths of 64
    (float32 all through: no ``autocast``, no bf16 values), the same float32 weights, two
    roll-out steps on the CPU."""
    from aurora_tpu.model.config import AuroraConfig as JaxConfig

    monkeypatch.setattr(aurora_tpu.AuroraSmallPretrained, "default_config",
                        classmethod(lambda cls: JaxConfig(**TINY)))
    monkeypatch.setattr(port.AuroraSmallPretrained, "default_config",
                        classmethod(lambda cls: AuroraConfig(**TINY)))
    jmodel = aurora_tpu.AuroraSmallPretrained()
    tmodel = port.AuroraSmallPretrained(device="cpu", seed=None)
    for cfg in (jmodel.cfg, tmodel.cfg):
        assert not (cfg.autocast or cfg.agg_bf16 or cfg.deagg_bf16)
    _, params64, ported = seeded_matched_models(TINY)
    params = jax.tree_util.tree_map(lambda v: v.astype(jnp.float32), params64)
    tmodel.load_state_dict({k: v.float() for k, v in ported.state_dict().items()})
    batch = make_batch(H=17, W=32, levels=(100.0, 500.0, 850.0), dtype=np.float32)
    want = list(aurora_tpu.rollout(jmodel, params, batch, steps=2))
    got = list(port.rollout(tmodel, torch_batch(batch), steps=2))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert all(v.dtype == torch.float32 for v in {**g.surf_vars, **g.atmos_vars}.values())
        errs = batch_errors(g, w)
        assert max(errs.values()) <= 1e-5, errs
