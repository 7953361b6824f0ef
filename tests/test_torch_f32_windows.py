"""The float32 forms of K5, K6, K7 and K8, routes W, P and X in float32, K5 at the small
model's D = 256, and the package namespace, on the CPU.

* The wrappers with a stand-in launch (the recorder of ``tests/test_torch_f32.py``: each C
  entry records its arguments; the device check and the stream stand in too): float32 tokens
  reach the float32 entries (``linear_adaln_residual_f32`` and ``mlp_rows_f32`` with ``ln``
  0 of ``mlp_f32``, ``window_attention_f32`` with ``Cp`` 0 and ``sdpa_windows_f32`` of
  ``window_attention_f32``) with the float32 weights as stored (no cast, no copy) and no
  statistics scratch; bf16 tokens reach the bf16 entries as before; each launch is tallied by
  its output's dtype and width; a bf16-stored weight beside float32 tokens is widened, the
  tokens never narrowed; float64 tokens raise ``ValueError`` before any launch.
* PyTorch mirrors of the float32 kernels' arithmetic against the JAX package's Pallas kernels
  in float32, run in interpret mode (as ``tests/test_torch_kernels.py`` runs them): K5 over
  128-row tiles of two batch elements (a tile straddles the FiLM rows); K6 with each window's
  rows read and written through the packed row map ``w * N + t`` (the CUDA core's
  ``Packed::row``), masked and unmasked, with and without the tail; K7, the core alone on the
  caller's packed qkv, masked and unmasked; K8 chunk by chunk of rows as ``mlp_row_chunks(...,
  elem=4)`` cuts them. Bounds as max |error| / max |reference|: 1e-5 (float32 summation
  order); K8 5e-5, stated from the JAX kernel's erf polynomial (within 2.7e-7 of erf), which
  put its float32 MLP 2.8e-5 from the float64 result in ``tests/test_torch_kernels.py``.
* Routes W (``pallas_windowed``, ``fused``), P (``pallas``, ``pallas``) and X (``xla``,
  ``fused``) in float32: the same float32 weights in both packages (``params_from_numpy``),
  widths 64, two blocks a stage, one step; the JAX package on the same route with its Pallas
  kernels in interpret mode, the port on its plain versions, one model put on each route by
  ``Aurora.set_knobs`` (as ``chip_smoke.py`` does on the card; each route's wrappers
  counted): mean relative error per variable <= 1e-5, as the small facade's float32 test
  holds its model.
* The namespace: every name of ``aurora_tpu.__all__`` but ``stack_block_params`` (a TPU
  program-size workaround) is in ``aurora_tpu_torch.__all__`` and resolves, ``Tracker`` and
  ``metrics`` at first use; ``import aurora_tpu_torch`` alone loads no scipy.
"""

import math
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import aurora_tpu
import aurora_tpu_torch as port
from aurora_tpu.model.swin3d import _attn_windows_qkv_fused_pallas, _sdpa_windows_fused_pallas
from aurora_tpu.ops.masks import window_group_ids
from aurora_tpu.ops.mlp import linear_adaln_residual_fused, mlp_fused
from aurora_tpu_torch.ops import _lib, mlp, window_attention
from aurora_tpu_torch.ops.window_attention import window_partition
from tests.conftest import make_batch
from tests.test_torch_f32 import TINY, _ln_film_residual, _t, entries  # noqa: F401
from tests.test_torch_support import (
    batch_errors,
    max_rel,
    numpy_tree,
    seeded_matched_models,
    torch_batch,
)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, the caller's count restored after (the suite runs six workers
    at once; see ``tests/test_torch_training.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------------------ stand-in launches

D6, HEADS6 = 256, 4  # K6 / K7: one window of 144 tokens a batch element, head dim 64


def _k5(dtype, D, w_dtype=None):
    w = _t(D, D, dtype=w_dtype or dtype, std=0.02)
    args = (_t(2, 144, D, dtype=dtype), w, _t(D), _t(2, 144, D, dtype=dtype, seed=1), _t(2, D),
            _t(2, D))
    return args, lambda: mlp._linear_adaln_residual_launch(*args, 0.0)


def _k6(dtype, tail=True, w_dtype=None):
    groups = window_group_ids(2, 6, 12, (2, 6, 12), (1, 3, 6))
    wqkv = _t(D6, 3 * D6, dtype=w_dtype or dtype, std=0.02)
    tl = ((_t(D6, D6, dtype=dtype, std=0.02), _t(D6), _t(2, D6), _t(2, D6)) if tail
          else (None,) * 4)
    args = (_t(2, 1, 144, D6, dtype=dtype), wqkv, _t(3 * D6, dtype=dtype), groups, HEADS6, *tl)
    return args, lambda: window_attention._window_attention_windowed_launch(*args, 1e-5)


def _k7(dtype):
    args = (_t(2, 1, 144, 3 * D6, dtype=dtype), window_group_ids(2, 6, 12, (2, 6, 12),
                                                                  (1, 3, 6)), HEADS6)
    return args, lambda: window_attention._sdpa_windows_launch(*args)


def _k8(dtype, w_dtype=None):
    args = (_t(1, 300, 256, dtype=dtype), _t(256, 1024, dtype=w_dtype or dtype, std=0.02),
            _t(1024), _t(1024, 256, dtype=dtype, std=0.02), _t(256))
    return args, lambda: mlp._mlp_fused_launch(*args)


ENTRIES = {  # kernel: ((lib, fn) on float32 tokens, (lib, fn) on bf16 ones)
    "K5": (("mlp_f32", "linear_adaln_residual_f32"), ("mlp", "linear_adaln_residual")),
    "K6": (("window_attention_f32", "window_attention_f32"),
           ("window_attention", "window_attention")),
    "K7": (("window_attention_f32", "sdpa_windows_f32"), ("sdpa", "sdpa_windows")),
    "K8": (("mlp_f32", "mlp_rows_f32"), ("mlp", "mlp_rows")),
}


@pytest.mark.parametrize("D", [256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k5_tokens_reach_the_entry_of_their_dtype(entries, dtype, D):
    """Both dtypes at the small model's D = 256 and the 1.3 B model's first stage."""
    (x, w, b, sc, shift, scale), call = _k5(dtype, D)
    out = call()
    assert out.dtype == dtype and out.shape == x.shape
    ((lib, fn, a),) = entries.calls
    f32 = dtype == torch.float32
    assert (lib, fn) == ENTRIES["K5"][0 if f32 else 1]
    assert (a[0], a[3], a[8]) == (x.data_ptr(), sc.data_ptr(), out.data_ptr())
    assert a[1] == w.data_ptr() and a[2] == b.data_ptr()  # the weights as stored
    assert (a[7] is None) == f32  # the f32 row kernel takes its own statistics
    assert a[9:12] == (288, 144, D)  # rows, rows a FiLM row, D
    assert _lib.LAUNCHES["linear_adaln_residual"] == 1
    assert _lib.LAUNCHES_BY == {("linear_adaln_residual", str(dtype)[6:], D): 1}


@pytest.mark.parametrize("tail", [True, False], ids=["tail", "no_tail"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k6_tokens_reach_the_entry_of_their_dtype(entries, dtype, tail):
    (xw, wqkv, bqkv, _, _, wproj, *_), call = _k6(dtype, tail)
    out = call()
    assert out.dtype == dtype and out.shape == xw.shape
    ((lib, fn, a),) = entries.calls
    f32 = dtype == torch.float32
    assert (lib, fn) == ENTRIES["K6"][0 if f32 else 1]
    assert (a[0], a[1], a[2]) == (xw.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr())  # as stored
    if tail:
        assert a[4] == wproj.data_ptr() and a[11] == out.data_ptr()
        assert (a[10] is None) == f32  # the f32 row kernel takes its own statistics
    else:
        assert a[4] is None and a[10] is None and a[11] is None and a[9] == out.data_ptr()
    assert a[12:22] == (2, 1, 0, 0, 0, D6, 0, 0, 0, HEADS6)  # Cp = 0: the packed row map
    assert _lib.LAUNCHES["window_attention_windowed"] == 1
    assert _lib.LAUNCHES_BY == {("window_attention_windowed", str(dtype)[6:], D6): 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k7_rows_reach_the_entry_of_their_dtype(entries, dtype):
    (qkv, _, _), call = _k7(dtype)
    out = call()
    assert out.dtype == dtype and out.shape == (2, 1, 144, D6)
    ((lib, fn, a),) = entries.calls
    assert (lib, fn) == ENTRIES["K7"][0 if dtype == torch.float32 else 1]
    assert (a[0], a[2]) == (qkv.data_ptr(), out.data_ptr()) and a[1] is not None
    assert a[3:7] == (2, 1, D6, HEADS6)
    assert _lib.LAUNCHES["sdpa_windows"] == 1
    assert _lib.LAUNCHES_BY == {("sdpa_windows", str(dtype)[6:], D6): 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k8_tokens_reach_the_entry_of_their_dtype(entries, dtype):
    """K8 is K3's entry with ``ln`` 0: no FiLM, no statistics, one chunk of 300 rows."""
    (x, w1, b1, w2, b2), call = _k8(dtype)
    out = call()
    assert out.dtype == dtype and out.shape == x.shape
    ((lib, fn, a),) = entries.calls
    assert (lib, fn) == ENTRIES["K8"][0 if dtype == torch.float32 else 1]
    assert (a[0], a[6]) == (x.data_ptr(), out.data_ptr())
    assert (a[1], a[2], a[3], a[4]) == (w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                                        b2.data_ptr())  # as stored
    assert a[7:10] == (None, None, None) and a[17] == 0  # no statistics, no FiLM, ln 0
    assert (a[11], a[12], a[14], a[15]) == (300, 0, 256, 1024)
    assert _lib.LAUNCHES["mlp_fused"] == 1
    assert _lib.LAUNCHES_BY == {("mlp_fused", str(dtype)[6:], 256): 1}


@pytest.mark.parametrize("kernel", ["K5", "K6", "K8"])
def test_f32_weights_stored_in_bf16_are_widened_not_the_tokens_narrowed(entries, kernel):
    """A bf16-stored weight beside float32 tokens reaches the float32 entry as an f32 copy."""
    if kernel == "K5":
        (x, w, *_), call = _k5(torch.float32, 256, w_dtype=torch.bfloat16)
    elif kernel == "K6":
        (x, w, *_), call = _k6(torch.float32, w_dtype=torch.bfloat16)
    else:
        (x, w, *_), call = _k8(torch.float32, w_dtype=torch.bfloat16)
    assert call().dtype == torch.float32
    ((lib, fn, a),) = entries.calls
    assert (lib, fn) == ENTRIES[kernel][0] and a[0] == x.data_ptr() and a[1] != w.data_ptr()


@pytest.mark.parametrize("kernel", ["K5", "K6", "K7", "K8"])
def test_float64_tokens_raise_before_any_launch(entries, kernel):
    call = {"K5": lambda: _k5(torch.float64, 256)[1], "K6": lambda: _k6(torch.float64)[1],
            "K7": lambda: _k7(torch.float64)[1], "K8": lambda: _k8(torch.float64)[1]}[kernel]()
    with pytest.raises(ValueError, match="float64"):
        call()
    assert entries.calls == [] and not any(_lib.LAUNCHES.values())


# ------------------------------------------------------------------------------ mirrors


def linear_adaln_residual_f32_mirror(x, w, b, shortcut, shift, scale, scale_bias, tile=128):
    """K5's float32 launches in PyTorch, a tile of 128 rows at a time as the product's blocks
    take them: ``x W + b``, then the row kernel with the shortcut as the residual and FiLM row
    ``row // L`` (a tile may hold rows of two batch elements)."""
    B, L, D = x.shape
    xr, sr = x.reshape(B * L, D), shortcut.reshape(B * L, D)
    out = torch.empty_like(xr)
    for r0 in range(0, B * L, tile):
        rows = slice(r0, min(r0 + tile, B * L))
        y = xr[rows] @ w + b
        f = torch.arange(rows.start, rows.stop) // L
        mean = y.mean(-1, keepdim=True)
        rstd = torch.rsqrt((y - mean).square().mean(-1, keepdim=True) + 1e-5)
        out[rows] = sr[rows] + ((y - mean) * rstd * (scale_bias + scale[f]) + shift[f])
    return out.reshape(x.shape)


def test_k5_f32_mirror_matches_pallas():
    """Two batch elements of 200 rows: the tile of rows 128..255 has both FiLM rows."""
    rng = np.random.default_rng(6)
    B, L, D = 2, 200, 32
    a = [rng.standard_normal((B, L, D)), 0.2 * rng.standard_normal((D, D)),
         0.05 * rng.standard_normal(D), rng.standard_normal((B, L, D)),
         rng.standard_normal((B, D)), 0.3 * rng.standard_normal((B, D))]
    want = linear_adaln_residual_fused(*[jnp.asarray(v, jnp.float32) for v in a], scale_bias=0.5,
                                       interpret=True)
    got = linear_adaln_residual_f32_mirror(*[torch.from_numpy(v).float() for v in a], 0.5)
    assert max_rel(got, want) < 1e-5


def packed_rows(windows: int, N: int) -> torch.Tensor:
    """``csrc/window_attention_f32.cu``'s ``Packed::row``: token ``t`` of window ``w`` at row
    ``w * N + t``, ``(windows, N)``."""
    return torch.arange(windows)[:, None] * N + torch.arange(N)[None]


def window_core_f32_mirror(qkv, out, rows, groups, nW, heads):
    """``window_core_f32`` in PyTorch, in the kernel's order of work: per (window, head) the
    rows ``rows`` of ``qkv`` (rows, 3D) read through the map; logits in base 2 with the scale
    folded in, ``q.k * dh^-0.5 log2 e`` (the kernel's dh is 64: ``log2 e / 8``), plus ``-100
    log2 e`` where the group ids differ; ``p = exp2(t - max t)``, one reciprocal a row, the
    weights ``p * (1 / sum p)``; ``w @ v`` summed a third of the keys at a time, the thirds in
    key order, as the kernel stages them; each result to its token's own row of ``out``."""
    D = out.shape[-1]
    dh = D // heads
    N = rows.shape[1]
    third = N // 3
    scale, masked = dh**-0.5 * math.log2(math.e), -100.0 * math.log2(math.e)
    mask = 0.0
    if groups is not None:
        gid = torch.from_numpy(np.asarray(groups))[torch.arange(rows.shape[0]) % nW]
        mask = torch.where(gid[:, :, None] == gid[:, None, :], 0.0, masked)
    for h in range(heads):
        q, k, v = (qkv[rows][..., p * D + h * dh:p * D + (h + 1) * dh] for p in range(3))
        t = (q @ k.transpose(1, 2)) * scale + mask
        p = torch.exp2(t - t.max(-1, keepdim=True).values)
        w = p * (1.0 / p.sum(-1, keepdim=True))
        o = w[..., :third] @ v[:, :third]
        for j in range(third, N, third):
            o = o + w[..., j:j + third] @ v[:, j:j + third]
        out[rows.reshape(-1), h * dh:(h + 1) * dh] = o.reshape(-1, dh)
    return out


def window_attention_windowed_f32_mirror(xw, wqkv, bqkv, groups, heads, tail):
    """K6's float32 launches in PyTorch: qkv over the rows in their stored order, the core
    through :func:`packed_rows`, with the tail proj and the row kernel (FiLM row ``row //
    (nW N)``)."""
    B, nW, N, D = xw.shape
    x = xw.reshape(-1, D)
    attn = window_core_f32_mirror(x @ wqkv + bqkv, torch.empty_like(x), packed_rows(B * nW, N),
                                  groups, nW, heads)
    if tail is None:
        return attn.reshape(xw.shape)
    wproj, bproj, shift, scale = tail
    return _ln_film_residual(attn @ wproj + bproj, x, shift, scale, nW * N).reshape(xw.shape)


def _windows(rng, B, C, H, W, D, ws):
    """Seeded ``(B, nW, N, D)`` windows of a ``(B, C, H, W, D)`` grid."""
    return window_partition(torch.from_numpy(rng.standard_normal((B, C, H, W, D))), ws).numpy()


@pytest.mark.parametrize("tail", [True, False], ids=["tail", "no_tail"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_k6_f32_mirror_matches_pallas(masked, tail):
    rng = np.random.default_rng(7)
    ws, ss, heads = (2, 3, 4), (1, 1, 2), 2
    B, C, H, W, D = 2, 4, 9, 12, 16
    a = [_windows(rng, B, C, H, W, D, ws), 0.2 * rng.standard_normal((D, 3 * D)),
         0.05 * rng.standard_normal(3 * D), 0.2 * rng.standard_normal((D, D)),
         0.05 * rng.standard_normal(D), rng.standard_normal((B, D)),
         0.3 * rng.standard_normal((B, D))]
    groups = window_group_ids(C, H, W, ws, ss) if masked else None
    j = [jnp.asarray(v, jnp.float32) for v in a]
    t = [torch.from_numpy(v).float() for v in a]
    want = _attn_windows_qkv_fused_pallas(j[0], j[1], j[2], heads, groups, interpret=True,
                                          tail=tuple(j[3:]) if tail else None)
    got = window_attention_windowed_f32_mirror(t[0], t[1], t[2], groups, heads,
                                               tuple(t[3:]) if tail else None)
    assert max_rel(got, want) < 1e-5


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_k7_f32_mirror_matches_pallas(masked):
    """The core alone on packed qkv ``(B, nW, N, 3D)``, its rows through :func:`packed_rows`."""
    rng = np.random.default_rng(8)
    ws, ss, heads = (2, 3, 4), (1, 1, 2), 2
    B, C, H, W, D = 2, 4, 9, 12, 16
    qkv = _windows(rng, B, C, H, W, 3 * D, ws)
    groups = window_group_ids(C, H, W, ws, ss) if masked else None
    want = _sdpa_windows_fused_pallas(jnp.asarray(qkv, jnp.float32), heads, groups,
                                      interpret=True)
    _, nW, N, _ = qkv.shape
    got = window_core_f32_mirror(torch.from_numpy(qkv).float().reshape(-1, 3 * D),
                                 torch.empty(B * nW * N, D), packed_rows(B * nW, N), groups, nW,
                                 heads)
    assert max_rel(got.reshape(B, nW, N, D), want) < 1e-5


def mlp_fused_f32_mirror(x, w1, b1, w2, b2, cap):
    """K8's float32 launches in PyTorch, chunk of rows by chunk of rows as
    ``mlp_row_chunks(..., elem=4)`` cuts them: fc1 with the bias and the exact erf GELU, fc2
    with the bias."""
    D = x.shape[-1]
    xr = x.reshape(-1, D)
    out = torch.empty(xr.shape[0], w2.shape[1])
    for r0, rows in mlp.mlp_row_chunks(xr.shape[0], w1.shape[1], cap, elem=4):
        out[r0:r0 + rows] = F.gelu(xr[r0:r0 + rows] @ w1 + b1) @ w2 + b2
    return out.reshape(*x.shape[:-1], -1)


def test_k8_f32_mirror_matches_pallas():
    """400 rows in chunks of 128; the bound is the JAX erf polynomial's (module docstring)."""
    rng = np.random.default_rng(9)
    B, L, D, Hd = 2, 200, 32, 128
    a = [rng.standard_normal((B, L, D)), 0.2 * rng.standard_normal((D, Hd)),
         0.05 * rng.standard_normal(Hd), 0.2 * rng.standard_normal((Hd, D)),
         0.05 * rng.standard_normal(D)]
    want = mlp_fused(*[jnp.asarray(v, jnp.float32) for v in a], interpret=True)
    cap = 128 * Hd * 4
    assert len(mlp.mlp_row_chunks(B * L, Hd, cap, elem=4)) == 4
    got = mlp_fused_f32_mirror(*[torch.from_numpy(v).float() for v in a], cap)
    assert max_rel(got, want) < 5e-5


# ------------------------------------------------------------------------------ the routes

ROUTES = {  # route: (knobs, the backbone wrappers it calls, each once a block)
    "W": (dict(attention_impl="pallas_windowed", mlp_impl="fused"),
          ("window_attention_windowed", "mlp_adaln_residual")),
    "P": (dict(attention_impl="pallas", mlp_impl="pallas"), ("window_attention_tail", "mlp_fused")),
    "X": (dict(attention_impl="xla", mlp_impl="fused"),
          ("linear_adaln_residual", "mlp_adaln_residual")),
}


@pytest.fixture(scope="module")
def f32_models():
    """One tree of float32 weights at widths of 64, two blocks a stage, and the port model
    holding it (its route set by each test)."""
    from aurora_tpu_torch.convert import params_from_numpy
    from aurora_tpu_torch.model.config import AuroraConfig

    _, params64, _ = seeded_matched_models(TINY)
    params = jax.tree_util.tree_map(lambda v: v.astype(jnp.float32), params64)
    return params, params_from_numpy(numpy_tree(params), AuroraConfig(**TINY), device="cpu")


@pytest.mark.parametrize("route", list(ROUTES))
def test_route_in_float32_matches_jax(f32_models, route, monkeypatch):
    from aurora_tpu.model.aurora import Aurora as JaxAurora
    from aurora_tpu.model.config import AuroraConfig as JaxConfig
    from aurora_tpu_torch.model import swin3d

    f32_weights, tmodel = f32_models
    knobs, wrappers = ROUTES[route]
    monkeypatch.setenv("AURORA_PALLAS_INTERPRET", "1")  # the JAX route's kernels on the CPU
    names = ("window_attention_tail", "window_attention_windowed", "linear_adaln_residual",
             "mlp_adaln_residual", "mlp_fused")
    calls = dict.fromkeys(names, 0)
    for n in names:
        def spy(*a, _n=n, _f=getattr(swin3d, n), **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(swin3d, n, spy)
    cfg = tmodel.set_knobs(**knobs).cfg
    assert (cfg.attention_impl, cfg.mlp_impl) == (knobs["attention_impl"], knobs["mlp_impl"])
    assert all(b.cfg.routes() == cfg.backbone.routes() for b in tmodel.modules()
               if isinstance(b, swin3d.SwinBlock))
    assert not (cfg.autocast or cfg.agg_bf16 or cfg.deagg_bf16)
    assert {p.dtype for p in tmodel.parameters()} == {torch.float32}
    batch = make_batch(H=17, W=32, levels=(100.0, 500.0, 850.0), dtype=np.float32)
    want = JaxAurora(JaxConfig(**TINY, **knobs)).forward(f32_weights, batch)
    got = tmodel(torch_batch(batch))
    assert all(v.dtype == torch.float32 for v in {**got.surf_vars, **got.atmos_vars}.values())
    errs = batch_errors(got, want)
    assert max(errs.values()) <= 1e-5, errs
    blocks = sum(cfg.encoder_depths) + sum(cfg.decoder_depths)
    assert calls == {n: blocks if n in wrappers else 0 for n in names}


# ------------------------------------------------------------------------------ the namespace


def test_the_namespace_has_the_jax_packages_names():
    missing = set(aurora_tpu.__all__) - {"stack_block_params"} - set(port.__all__)
    assert not missing, missing
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    assert port.Tracker.__module__ == "aurora_tpu_torch.tracker"
    assert port.metrics.__name__ == "aurora_tpu_torch.metrics"
    from aurora_tpu_torch import Tracker, metrics

    assert (Tracker, metrics) == (port.Tracker, port.metrics)
    with pytest.raises(AttributeError, match="no attribute 'stack_block_params'"):
        port.stack_block_params


def test_importing_the_package_loads_no_scipy():
    code = ("import sys, aurora_tpu_torch; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'scipy'))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout.strip()
    assert out == "[]", out
