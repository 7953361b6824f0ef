"""The redesigned K2 / K6 window attention (``csrc/window_attention.cu``) on the CPU: what can
be held here without the card.

* The four launches' arithmetic, emulated in float32 with bf16 roundings where the kernels
  round: the qkv epilogue's two roundings (the product, then the bf16 bias); the core's
  base-2 softmax with one reciprocal a row (``attention_core.cuh``); proj with the f32 bias;
  the LayerNorm from per-256-column-tile statistics merged as ``ln_rows_kernel`` merges
  them. K2's core reads its windows through the host mirror of the 5D tensor map's boxes,
  K6's through packed rows. Held to the port's plain versions and to ``aurora_tpu``'s
  ``_attn_windows_5d_fused_pallas`` in interpret mode, at D = 512, 8 heads, a padded grid of
  two windows, shifted (masked, pad tokens present) and not. Tolerance: the card's block
  bound, 6e-3 of the branch (``tools.branch_err``, as ``chip_smoke.py`` measures: max
  |a - b| less one bf16 ulp of the output, over max |b - residual|); the emulation and the references round the same values
  at the same points, so only an f32 summation order or exp2 against exp can flip a
  rounding.
* The host mirror of the 5D box addressing gathers ``window_partition(xp)`` exactly, and
  its store addresses cover every token row once.
* The shape rule of the two wrappers, as a pure function.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.model.swin3d import _attn_windows_5d_fused_pallas
from aurora_tpu_torch.ops import window_attention as wa
from aurora_tpu_torch.ops.masks import window_group_ids
from aurora_tpu_torch.tools import branch_err

WS, SS = (2, 6, 12), (1, 3, 6)
BOUND = 6e-3
bf = torch.bfloat16


def _bf(a: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to bf16 and back, as the kernels' bf16r."""
    return a.to(bf).float()


# ------------------------------------------------------------------------------ addressing


def box_rows(B: int, Cp: int, Hp: int, Wp: int, ws) -> np.ndarray:
    """``(B nW, 144)``: the token rows a 5D box of the qkv scratch ``(B, Cp, Hp, Wp, 3D)``
    brings for each window, in the order they land in shared memory. The map's dims are
    innermost first {3D, Wp, Hp, Cp, B} and a box is {64, ws2, ws1, ws0, 1} at
    (., w1 ws2, h1 ws1, c1 ws0, b) for window (c1 H1 + h1) W1 + w1 of batch element b; the
    TMA writes the box innermost first, so smem row t = (wc ws1 + wh) ws2 + ww."""
    H1, W1 = Hp // ws[1], Wp // ws[2]
    nW = (Cp // ws[0]) * H1 * W1
    out = np.empty((B * nW, ws[0] * ws[1] * ws[2]), np.int64)
    for window in range(B * nW):
        b, wi = divmod(window, nW)
        c, h, w = wi // (H1 * W1) * ws[0], (wi // W1) % H1 * ws[1], wi % W1 * ws[2]
        t = 0
        for wc in range(ws[0]):          # dim 3, outermost of the box but one
            for wh in range(ws[1]):      # dim 2
                for ww in range(ws[2]):  # dim 1
                    out[window, t] = ((b * Cp + c + wc) * Hp + h + wh) * Wp + w + ww
                    t += 1
    return out


def store_rows(B: int, Cp: int, Hp: int, Wp: int, ws) -> np.ndarray:
    """``(B nW, 144)``: the rows ``GridWindows::base`` / ``row`` (``sdpa_sm90.cuh``) give
    token t of each window, where the core stores its result."""
    H1, W1 = Hp // ws[1], Wp // ws[2]
    nW = (Cp // ws[0]) * H1 * W1
    out = np.empty((B * nW, ws[0] * ws[1] * ws[2]), np.int64)
    for window in range(B * nW):
        b, wi = divmod(window, nW)
        c, h, w = wi // (H1 * W1) * ws[0], (wi // W1) % H1 * ws[1], wi % W1 * ws[2]
        base = ((b * Cp + c) * Hp + h) * Wp + w
        for t in range(out.shape[1]):
            wc, wh, ww = t // (ws[1] * ws[2]), (t // ws[2]) % ws[1], t % ws[2]
            out[window, t] = base + (wc * Hp + wh) * Wp + ww
    return out


@pytest.mark.parametrize("shape", [(1, 2, 6, 24), (2, 4, 12, 36), (1, 4, 48, 96)])
def test_5d_boxes_gather_window_partition(shape):
    B, Cp, Hp, Wp = shape
    D = 64
    xp = torch.arange(B * Cp * Hp * Wp * D, dtype=torch.float64).reshape(B, Cp, Hp, Wp, D)
    rows = box_rows(B, Cp, Hp, Wp, WS)
    want = wa.window_partition(xp, WS).reshape(-1, 144, D)
    assert torch.equal(xp.reshape(-1, D)[torch.from_numpy(rows)], want)
    stores = store_rows(B, Cp, Hp, Wp, WS)
    assert np.array_equal(stores, rows)
    assert np.array_equal(np.sort(stores.ravel()), np.arange(B * Cp * Hp * Wp))


# ------------------------------------------------------------------------------ emulation


def emulate(x2: torch.Tensor, rows: np.ndarray, wqkv, bqkv, groups, heads: int, tail,
            per_batch: int, eps: float = 1e-5) -> torch.Tensor:
    """The four launches on token rows ``x2 (rows, D)`` bf16; ``rows (windows, 144)`` the
    rows of each window's tokens (the core's box addressing)."""
    D = x2.shape[1]
    # 1. qkv: the product rounded, the bf16 bias added, rounded again.
    qkv = _bf(_bf(x2.float() @ wqkv.to(bf).float()) + bqkv.to(bf).float())
    # 2. core, unit by unit: f32 logits, base-2 softmax, one reciprocal a row.
    C, NEG = math.log2(math.e) / 8.0, -100.0 * math.log2(math.e)
    attn = torch.empty_like(qkv[:, :D])
    nW = groups.shape[0] if groups is not None else 1
    for window in range(rows.shape[0]):
        idx = torch.from_numpy(rows[window])
        mask = 0.0
        if groups is not None:
            g = torch.from_numpy(np.asarray(groups[window % nW], np.int64))
            mask = torch.where(g[:, None] != g[None, :], NEG, 0.0)
        for h in range(heads):
            q, k, v = (qkv[idx, p * D + 64 * h: p * D + 64 * h + 64] for p in range(3))
            t = (q @ k.T) * C + mask
            p = torch.exp2(t - t.max(-1, keepdim=True).values)
            inv = 1.0 / p.sum(-1, keepdim=True)
            attn[idx, 64 * h: 64 * h + 64] = _bf(_bf(p * inv) @ v)
    if tail is None:
        return attn.to(bf)
    wproj, bproj, shift, scale = tail
    # 3. proj with the f32 bias, rounded; per row and 256-column tile a mean and a centred
    #    sum of squares.
    y = _bf(attn @ wproj.to(bf).float() + bproj.float())
    yt = y.reshape(len(y), D // 256, 256)
    mean_t = yt.sum(-1) * (1.0 / 256)
    m2_t = (yt - mean_t[..., None]).square().sum(-1)
    # 4. the row kernel: the tiles merged exactly, FiLM row r / per_batch, the residual.
    mean = mean_t.mean(-1)
    m2 = (m2_t + 256.0 * (mean_t - mean[:, None]).square()).sum(-1)
    rstd = torch.rsqrt(m2 / D + eps)
    f = torch.arange(len(y)) // per_batch
    mod = (y - mean[:, None]) * rstd[:, None] * scale.float()[f] + shift.float()[f]
    return (x2.float() + mod).to(bf)


def _inputs(masked: bool, seed: int = 0):
    """D = 512, 8 heads: a (1, 2, 5, 20) grid padded to (1, 2, 6, 24), two windows."""
    rng = np.random.default_rng(seed)
    C, H, W, D = 2, 5, 20, 512
    Cp, Hp, Wp = 2, 6, 24
    xp = rng.standard_normal((1, Cp, Hp, Wp, D)).astype(np.float32)
    w = [0.02 * rng.standard_normal((D, 3 * D)), 0.02 * rng.standard_normal(3 * D),
         0.02 * rng.standard_normal((D, D)), 0.02 * rng.standard_normal(D),
         0.1 * rng.standard_normal((1, D)), rng.standard_normal((1, D))]
    groups = window_group_ids(C, H, W, WS, SS) if masked else None
    xt = torch.from_numpy(xp).to(bf)
    wt = [torch.from_numpy(np.asarray(a, np.float32)) for a in w]
    return groups, xt, wt, w


@pytest.mark.parametrize("tail", [True, False], ids=["tail", "no_tail"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_four_launches_match_the_plain_versions(masked, tail):
    groups, xt, wt, _ = _inputs(masked)
    if masked:
        assert (groups == groups.max()).any() and len(np.unique(groups)) > 2
    B, Cp, Hp, Wp, D = xt.shape
    t = (wt[2], wt[3], wt[4], wt[5]) if tail else None
    x2 = xt.reshape(-1, D)
    residual = xt if tail else torch.zeros(())
    # K2: windows in place through the 5D boxes.
    got = emulate(x2, box_rows(B, Cp, Hp, Wp, WS), wt[0], wt[1], groups, 8, t, Cp * Hp * Wp)
    want = wa.window_attention_tail_plain(xt, wt[0], wt[1], groups, WS, 8, t)
    assert branch_err(got.reshape(xt.shape), want, residual)[1] <= BOUND
    # K6: packed rows of the partitioned windows.
    xw = wa.window_partition(xt, WS).contiguous()
    nW = xw.shape[1]
    packed = np.arange(B * nW * 144).reshape(B * nW, 144)
    got6 = emulate(xw.reshape(-1, D), packed, wt[0], wt[1], groups, 8, t, nW * 144)
    want6 = wa.window_attention_windowed_plain(xw, wt[0], wt[1], groups, 8, t)
    assert branch_err(got6.reshape(xw.shape), want6, xw if tail else torch.zeros(()))[1] <= BOUND
    # The two addressings give one function.
    assert torch.equal(wa.window_reverse(got6.reshape(xw.shape), WS, Cp, Hp, Wp),
                       got.reshape(xt.shape))


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_four_launches_match_the_pallas_kernel(masked):
    """Against ``aurora_tpu``'s K2 in interpret mode, with the tail (the main route's form)."""
    groups, xt, wt, w = _inputs(masked, seed=1)
    B, Cp, Hp, Wp, D = xt.shape
    xj = jnp.asarray(xt.float().numpy(), jnp.bfloat16)
    wj = [jnp.asarray(a, jnp.float32) for a in w]
    want = _attn_windows_5d_fused_pallas(
        xj, wj[0], wj[1], 8, groups, WS, interpret=True, tail=tuple(wj[2:]))
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).to(bf)
    got = emulate(xt.reshape(-1, D), box_rows(B, Cp, Hp, Wp, WS), wt[0], wt[1], groups, 8,
                  tuple(wt[2:]), Cp * Hp * Wp)
    assert branch_err(got.reshape(xt.shape), want, xt)[1] <= BOUND


# ------------------------------------------------------------------------------ shape rule


# (B, Cp, Hp, Wp, D, heads): the 0.25 deg model's three stages (stage 3 padded from 45 x 90)
# and the 121 x 240 reference grid's (30 x 60, 15 x 30 -> 18 x 36, 8 x 15 -> 12 x 24).
CARD_GRIDS = [(1, 4, 180, 360, 512, 8), (1, 4, 90, 180, 1024, 16), (1, 4, 48, 96, 2048, 32),
              (1, 4, 30, 60, 512, 8), (1, 4, 18, 36, 1024, 16), (1, 4, 12, 24, 2048, 32)]


@pytest.mark.parametrize("grid", CARD_GRIDS, ids=lambda g: "x".join(map(str, g[1:5])))
def test_window_attention_shape_rule_takes_the_card_shapes(grid):
    B, Cp, Hp, Wp, D, heads = grid
    nW = Cp * Hp * Wp // 144
    rows = B * nW * 144
    assert wa.check_window_attention_shape((B, Cp, Hp, Wp, D), heads, WS) == (B, nW, rows)
    assert wa.check_window_attention_shape((B, nW, 144, D), heads) == (B, nW, rows)


@pytest.mark.parametrize("shape,heads,ws,word", [
    ((1, 4, 12, 24, 256), 4, WS, "D=256"),          # the small config's width
    ((1, 4, 12, 24, 768), 12, WS, "D=768"),
    ((1, 4, 12, 24, 4096), 64, WS, "D=4096"),
    ((1, 4, 12, 24, 512), 16, WS, "head dim"),     # dh 32
    ((1, 4, 12, 24, 1024), 8, WS, "head dim"),     # dh 128
    ((1, 4, 12, 24, 512), 8, (2, 4, 8), "N=64"),   # windows of 64 tokens
    ((1, 4, 13, 24, 512), 8, WS, "not a multiple"),
    ((1, 4, 128, 512), 8, None, "N=128"),
    ((1, 4, 144, 512), 8, WS, "needs"),            # windows given to a 4D shape
    ((2**10, 2**10, 144, 512), 8, None, "rows"),   # more rows than the schedule takes
])
def test_window_attention_shape_rule_refuses_other_shapes(shape, heads, ws, word):
    with pytest.raises(ValueError) as e:
        wa.check_window_attention_shape(shape, heads, ws)
    assert word in str(e.value) and str(tuple(shape)) in str(e.value)
