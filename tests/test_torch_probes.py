"""The plain versions of the probe kernels (K9-K13) and the probe tools on the CPU.

The JAX tools define their Pallas kernels as closures inside ``main()``, which cannot be
imported. So each plain version is held to the ``aurora_tpu`` function that the tool itself
treats as the same math, run in interpret mode as the JAX tests run it, or to a few lines
of ``jnp`` that transcribe the tool's kernel body (the lines are cited).

Tolerances, as max |error| / max |reference|: f32 1e-5 (accumulation order; 5e-5 for the
MLP, whose JAX kernel evaluates erf as a polynomial, as in tests/test_torch_kernels.py);
bf16 1e-2 (both sides round at the same points, but another f32 summation order can flip a
bf16 rounding, and one bf16 ulp is up to 7.8e-3 of a value).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.model import swin3d as j_swin3d
from aurora_tpu.ops.mlp import _gelu_exact, mlp_adaln_residual_fused
from aurora_tpu_torch.model.config import AuroraConfig
from aurora_tpu_torch.ops import probes
from aurora_tpu_torch.ops.window_attention import window_attention_tail
from aurora_tpu_torch.tools import backbone_ablate, gemm_probe, smem_probe
from tests.test_torch_support import max_rel

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}
F32 = jnp.float32


def _pair(a, name):
    jdt, tdt, _ = DTYPES[name]
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a, np.float32)).to(tdt)


# ------------------------------------------------------------------------------ K12, K13


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("MB", [32, 96])
def test_gemm_blocked_matches_dot_general(MB, dtype):
    rng = np.random.default_rng(0)
    (aj, at), (wj, wt) = _pair(rng.standard_normal((96, 64)), dtype), _pair(
        0.1 * rng.standard_normal((64, 128)), dtype)
    want = jax.lax.dot_general(aj, wj, (((1,), (0,)), ((), ())),
                               preferred_element_type=F32).astype(aj.dtype)
    got = probes.gemm_blocked(at, wt, MB)
    assert got.dtype == at.dtype and tuple(got.shape) == (96, 128)
    assert max_rel(got, want) < DTYPES[dtype][2]


def test_gemm_blocked_needs_a_row_block_that_divides():
    a, w = torch.zeros(96, 64), torch.zeros(64, 128)
    with pytest.raises(ValueError):
        probes.gemm_blocked(a, w, 40)
    with pytest.raises(ValueError):
        probes.gemm_blocked(a, torch.zeros(32, 128), 32)


def test_smem_probe_plain():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 128))).float()
    want = 2 * x + x[0, 0]
    assert torch.equal(probes.smem_probe_plain(x), want)
    assert torch.equal(probes.smem_probe(x, 64 * 1024), want)
    with pytest.raises(ValueError):
        probes.smem_probe(torch.zeros(8, 64), 1024)


# ------------------------------------------------------------------------------ K9


def _mlp_t_inputs(dtype, seed=2, L=48, D=32, Hd=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((L, D))
    w1, w2 = 0.2 * rng.standard_normal((D, Hd)), 0.2 * rng.standard_normal((Hd, D))
    cols = [0.05 * rng.standard_normal((Hd, 1)), 0.05 * rng.standard_normal((D, 1)),
            0.1 * rng.standard_normal((D, 1)), 1 + 0.3 * rng.standard_normal((D, 1))]  # b1 b2 sh sc
    (xj, xt), (w1j, w1t), (w2j, w2t) = _pair(x, dtype), _pair(w1, dtype), _pair(w2, dtype)
    cj = [jnp.asarray(c, F32) for c in cols]
    ct = [torch.from_numpy(c).float() for c in cols]
    return (xj, w1j, cj[0], w2j, cj[1], cj[2], cj[3]), (xt, w1t, ct[0], w2t, ct[1], ct[2], ct[3])


def _mlp_t_jnp(x, w1, b1, w2, b2, sh, sc):
    """The body of the tool's kernel, ``tools/backbone_ablate.py:430-454``."""
    dn = (((0,), (0,)), ((), ()))
    xT = x.T
    hT = jax.lax.dot_general(w1, xT, dn, preferred_element_type=F32) + b1
    hT = _gelu_exact(hT.astype(x.dtype).astype(F32), accurate=False).astype(x.dtype)
    accT = jax.lax.dot_general(w2, hT, dn, preferred_element_type=F32)
    yf = (accT + b2).astype(x.dtype).astype(F32)
    mean = jnp.mean(yf, axis=0, keepdims=True)
    var = jnp.mean(jnp.square(yf - mean), axis=0, keepdims=True)
    mod = (yf - mean) * jax.lax.rsqrt(var + 1e-5) * sc + sh
    return (xT.astype(F32) + mod).astype(x.dtype).T


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("R", [16, 48])
def test_mlp_t_matches_fused_kernel_at_scale_bias_0(R, dtype):
    """Against ``mlp_adaln_residual_fused(..., scale_bias=0.0)`` in interpret mode: the
    function the tool's kernel computes (the tool's GELU fit is below a bf16 ulp of the
    exact erf form, ``aurora_tpu/ops/mlp.py:126-142``)."""
    (xj, w1, b1, w2, b2, sh, sc), t = _mlp_t_inputs(dtype)
    want = mlp_adaln_residual_fused(
        xj[None], w1.astype(F32), b1[:, 0], w2.astype(F32), b2[:, 0], sh.T, sc.T, scale_bias=0.0,
        interpret=True)[0]
    got = probes.mlp_t(*t, R)
    assert got.dtype == t[0].dtype and tuple(got.shape) == tuple(want.shape)
    assert max_rel(got, want) < (5e-5 if dtype == "f32" else DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlp_t_matches_the_tools_feature_major_body(dtype):
    """Against the tool's own body: transposed products, LayerNorm over the leading axis.
    f32: 2e-5, the tool's tanh-form erf fit (3.3e-6 from erf) scaled up by the LayerNorm."""
    j, t = _mlp_t_inputs(dtype, seed=3)
    assert max_rel(probes.mlp_t_plain(*t), _mlp_t_jnp(*j)) < (2e-5 if dtype == "f32" else 1e-2)


def test_mlp_t_needs_a_row_block_that_divides():
    _, t = _mlp_t_inputs("f32")
    with pytest.raises(ValueError, match="divide"):
        probes.mlp_t(*t, 36)


# ------------------------------------------------------------------------------ K10


def _probe_inputs(dtype, heads=2, seed=4, nW=3, N=24):
    rng = np.random.default_rng(seed)
    D = 8 * heads
    x = rng.standard_normal((1, nW, N, D))
    w, b = 0.3 * rng.standard_normal((D, 3 * D)), 0.05 * rng.standard_normal((1, 3 * D))
    (xj, xt), (wj, wt), (bj, bt) = _pair(x, dtype), _pair(w, dtype), _pair(b, dtype)
    return (xj, wj, bj), (xt, wt, bt)


def _probe_jnp(x, w, b, heads, mode):
    """The body of ``make_probe(mode)``, ``tools/backbone_ablate.py:509-595``, for a batch
    of windows ``x: (KW, N, Ds)``."""
    KW, N, Ds = x.shape
    dh = Ds // heads
    scale = 1.0 / math.sqrt(dh)
    bdot = dict(preferred_element_type=F32)
    qk_dn, wv_dn = (((2,), (2,)), ((0,), (0,))), (((2,), (1,)), ((0,), (0,)))
    xt = x.reshape(KW * N, Ds)
    qkv = jax.lax.dot_general(xt, w, (((1,), (0,)), ((), ())), **bdot).astype(xt.dtype) + b  # :511
    if mode == "no_core":
        return qkv[:, :Ds].reshape(KW, N, Ds)  # :516-518
    x = qkv.reshape(KW, N, 3 * Ds)
    if mode == "fulld":  # :520-533
        q, k, v = x[..., :Ds], x[..., Ds: 2 * Ds], x[..., 2 * Ds:]
        logits = jax.lax.dot_general(q, k, qk_dn, **bdot) * scale
        wgt = jax.nn.softmax(logits, axis=-1).astype(x.dtype)
        return jax.lax.dot_general(wgt, v, wv_dn, **bdot).astype(x.dtype)
    if mode in ("batched_heads", "bf16_batched"):  # :534-569
        q, k, v = (
            jnp.concatenate([x[..., o + hh * dh: o + (hh + 1) * dh] for hh in range(heads)], axis=0)
            for o in (0, Ds, 2 * Ds))
        logits = jax.lax.dot_general(q, k, qk_dn, **bdot)
        logits = logits.astype(x.dtype) * scale if mode == "bf16_batched" else logits * scale
        wgt = jax.nn.softmax(logits, axis=-1).astype(x.dtype)
        o = jax.lax.dot_general(wgt, v, wv_dn, **bdot).astype(x.dtype)
        return jnp.concatenate([o[hh * KW: (hh + 1) * KW] for hh in range(heads)], axis=-1)
    outs = []
    for hh in range(heads):  # :571-594
        q = x[..., hh * dh: (hh + 1) * dh]
        k = x[..., Ds + hh * dh: Ds + (hh + 1) * dh]
        v = x[..., 2 * Ds + hh * dh: 2 * Ds + (hh + 1) * dh]
        logits = jax.lax.dot_general(q, k, qk_dn, **bdot)
        logits = logits.astype(x.dtype) * scale if mode == "bf16_core" else logits * scale
        if mode == "no_softmax":
            wgt = logits.astype(x.dtype)
        else:
            wgt = jax.nn.softmax(logits, axis=-1).astype(x.dtype)
        outs.append(jax.lax.dot_general(wgt, v, wv_dn, **bdot).astype(x.dtype))
    return jnp.concatenate(outs, axis=-1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["baseline", "batched_heads"])
def test_attn_probe_baseline_matches_qkv_fused_kernel(mode, dtype):
    (xj, wj, bj), (xt, wt, bt) = _probe_inputs(dtype)
    want = j_swin3d._attn_windows_qkv_fused_pallas(xj, wj, bj[0], 2, None, interpret=True)
    got = probes.attn_probe(xt, wt, bt, 2, mode)
    assert got.dtype == xt.dtype and tuple(got.shape) == tuple(want.shape)
    assert max_rel(got, want) < DTYPES[dtype][2]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", probes.ATTN_PROBE_MODES)
def test_attn_probe_modes_match_the_tools_body(mode, dtype):
    """Every mode against the transcribed body. The bf16 softmax of ``bf16_core`` and
    ``bf16_batched`` rounds at every step (difference, exponential, sum, quotient)."""
    (xj, wj, bj), (xt, wt, bt) = _probe_inputs(dtype)
    want = _probe_jnp(xj[0], wj, bj, 2, mode)
    got = probes.attn_probe(xt, wt, bt, 2, mode)[0]
    assert max_rel(got, want) < DTYPES[dtype][2]


@pytest.mark.parametrize("a,b", [("batched_heads", "baseline"), ("bf16_batched", "bf16_core")])
def test_attn_probe_batched_modes_are_the_same_numbers(a, b):
    _, (xt, wt, bt) = _probe_inputs("bf16")
    assert torch.equal(probes.attn_probe(xt, wt, bt, 2, a), probes.attn_probe(xt, wt, bt, 2, b))


def test_attn_probe_modes_differ_and_unknown_mode_raises():
    _, (xt, wt, bt) = _probe_inputs("bf16", seed=5)
    outs = {m: probes.attn_probe(xt, wt, bt, 2, m) for m in
            ("baseline", "no_softmax", "no_core", "fulld", "bf16_core")}
    for m in ("no_softmax", "no_core", "fulld"):
        assert max_rel(outs[m], outs["baseline"]) > 1e-2, m
    assert not torch.equal(outs["bf16_core"], outs["baseline"])
    with pytest.raises(ValueError, match="mode"):
        probes.attn_probe(xt, wt, bt, 2, "softmax_only")


# ------------------------------------------------------------------------------ K11


def _direct_inputs(dtype, seed=6):
    rng = np.random.default_rng(seed)
    ws, heads = (2, 6, 12), 2
    D = 8 * heads
    x = rng.standard_normal((1, 2, 12, 24, D))
    w, b = 0.3 * rng.standard_normal((D, 3 * D)), 0.05 * rng.standard_normal(3 * D)
    return ws, heads, _pair(x, dtype), _pair(w, dtype), _pair(b, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", probes.ATTN5D_MODES)
def test_attn5d_direct_matches_the_tools_chain(mode, dtype):
    """Against the tool's chain, ``tools/backbone_ablate.py:809-814``: partition -> the
    qkv-fused kernel (interpret mode) -> reverse."""
    ws, heads, (xj, xt), (wj, wt), (bj, bt) = _direct_inputs(dtype)
    _, Cp, Hp, Wp, D = xj.shape
    wdw = j_swin3d.window_partition(xj, ws)
    C1, H1, W1, N = wdw.shape[1:5]
    o = j_swin3d._attn_windows_qkv_fused_pallas(
        wdw.reshape(1, C1 * H1 * W1, N, D), wj, bj, heads, None, interpret=True)
    want = j_swin3d.window_reverse(o.reshape(1, C1, H1, W1, N, D), ws, Cp, Hp, Wp)
    got = probes.attn5d_direct(xt, wt, bt, ws, heads, mode)
    assert got.dtype == xt.dtype and tuple(got.shape) == tuple(want.shape)
    assert max_rel(got, want) < DTYPES[dtype][2]


@pytest.mark.parametrize("mode", probes.ATTN5D_MODES)
def test_attn5d_direct_equals_window_attention_without_tail(mode):
    """K2 without tail, unmasked, on the same input: the same numbers, bit for bit."""
    ws, heads, (_, xt), (_, wt), (_, bt) = _direct_inputs("bf16")
    want = window_attention_tail(xt, wt, bt, None, ws, heads, tail=None)
    assert torch.equal(probes.attn5d_direct(xt, wt, bt, ws, heads, mode), want)


def test_attn5d_direct_rejects_a_ragged_grid_and_an_unknown_mode():
    ws, heads, (_, xt), (_, wt), (_, bt) = _direct_inputs("f32")
    with pytest.raises(ValueError, match="multiple"):
        probes.attn5d_direct(xt[:, :, :, :20], wt, bt, ws, heads, "vec")
    with pytest.raises(ValueError, match="mode"):
        probes.attn5d_direct(xt, wt, bt, ws, heads, "scan")


# ------------------------------------------------------------------------------ the tools

SMALL = AuroraConfig(
    embed_dim=64, num_heads=4, encoder_depths=(2, 2, 2), decoder_depths=(2, 2, 2),
    encoder_num_heads=(2, 4, 8), decoder_num_heads=(8, 4, 2), use_lora=False,
)
# A 60 x 120 grid is (4, 15, 30) = 1800 tokens at stage 0: the row block R = 1800 divides it.
SMALL_ARGS = ["--device", "cpu", "--steps", "1", "--H", "60", "--W", "120", "--stages", "0"]
RESULTS = {"gemms": 4, "layout": 3, "kernels": 3, "attn": 2, "rollfuse": 2, "attn5d_check": 3,
           "mlp_t": 1, "attn_probe": 7, "attn5d": 3}


@pytest.mark.parametrize("variant", backbone_ablate.VARIANTS)
def test_backbone_ablate_variant_runs_on_the_cpu(variant, capsys):
    """Every variant runs through the plain versions on a small backbone and returns its
    results, finite, each printed as one line."""
    out = backbone_ablate.main(SMALL_ARGS + ["--variants", variant], cfg=SMALL)
    assert len(out) == RESULTS.get(variant, 1)
    for r in out:
        assert r["device"] == "cpu"
        for k, v in r.items():
            if isinstance(v, float):
                assert math.isfinite(v), (r["label"], k)
        if "err" in r:
            assert r["err"] == 0.0  # on the CPU the wrapper is its plain version
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 + len(out)  # the device line, then one per result


def test_backbone_ablate_leaves_the_modules_as_it_found_them():
    from aurora_tpu_torch.model import swin3d
    from aurora_tpu_torch.model.nn import AdaptiveLayerNorm

    before = (AdaptiveLayerNorm.forward, swin3d.roll3d, swin3d.window_attention_tail)
    backbone_ablate.main(SMALL_ARGS + ["--variants", "no_adaln,no_roll,no_attn"], cfg=SMALL)
    assert (AdaptiveLayerNorm.forward, swin3d.roll3d, swin3d.window_attention_tail) == before
    with pytest.raises(ZeroDivisionError), backbone_ablate.patched(swin3d, "roll3d", None):
        1 / 0
    assert swin3d.roll3d is before[1]


def test_backbone_ablate_ablations_change_the_output():
    """Each ablation really removes something: the backbone's output moves."""
    import dataclasses

    from aurora_tpu_torch.model import swin3d
    from aurora_tpu_torch.model.nn import AdaptiveLayerNorm

    bb = dataclasses.replace(SMALL.backbone, mlp_impl="pallas")
    model = swin3d.Backbone(bb, device="cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    model.reset_parameters(g)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "modulation" in name and name.endswith("weight"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    x, lead, res = torch.randn(1, 1800, 64, generator=g), torch.ones(64), (4, 15, 30)
    with torch.no_grad():
        base = model(x, lead, 0, res)
        for obj, name, value in (
            (AdaptiveLayerNorm, "forward", lambda self, x, c, scale_bias=0.0: x),
            (swin3d, "roll3d", lambda x, shifts: x),
            (swin3d, "window_attention_tail", backbone_ablate._attention_core_skipped),
        ):
            with backbone_ablate.patched(obj, name, value):
                assert max_rel(model(x, lead, 0, res), base) > 1e-3, name
        assert torch.equal(model(x, lead, 0, res), base)


def test_backbone_ablate_rejects_an_unported_variant():
    with pytest.raises(ValueError, match="attn_tiles"):
        backbone_ablate.main(SMALL_ARGS + ["--variants", "attn_tiles"], cfg=SMALL)


@pytest.mark.parametrize("tool", [backbone_ablate, gemm_probe, smem_probe],
                         ids=["backbone_ablate", "gemm_probe", "smem_probe"])
def test_tools_raise_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main([])


def test_smem_probe_tool_on_the_cpu_checks_the_plain_version():
    assert smem_probe.main(["--device", "cpu"]) == [
        dict(label="smem_probe plain", device="cpu", ok=True)]
    assert max(smem_probe.PORT_SMEM_REQUESTS.values()) <= 232448  # a block's 227 KB
