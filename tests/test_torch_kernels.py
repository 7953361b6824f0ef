"""The plain PyTorch versions of the port's kernels against the JAX package's Pallas
kernels, run in interpret mode on the CPU (as tests/test_kernels.py runs them).

The port's kernel wrappers take these plain versions for CPU tensors; on the card the
hand-written kernels are held against the same plain versions by ``chip_smoke.py``.

Tolerances, as max |error| / max |reference|:
* roll: exact;
* f32: 1e-5 (f32 accumulation order); 5e-5 for the MLP, whose JAX kernel evaluates erf
  as a polynomial within 2.7e-7 of it, an error the LayerNorm scales up;
* bf16: 1e-2. Both sides round at the same points, but a different f32 summation order
  can flip a bf16 rounding, and one bf16 ulp is up to 7.8e-3 of a value; the JAX kernel's
  bf16 GELU is a tanh fit within 3.3e-6 of erf (``aurora_tpu/ops/mlp.py:126-142``). The
  on-chip levels of the Pallas kernels against XLA were 6e-3 (block) and 1e-2 (perceiver
  core with bf16 values), KERNEL_ONCHIP.json.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.model.swin3d import (
    _attn_windows_5d_fused_pallas,
    _attn_windows_qkv_fused_pallas,
    _sdpa_windows_fused_pallas,
    window_partition,
)
from aurora_tpu.ops.masks import window_group_ids
from aurora_tpu.ops.mlp import linear_adaln_residual_fused, mlp_adaln_residual_fused, mlp_fused
from aurora_tpu.ops.resampler import make_q_major_blockdiag, perceiver_core_fused
from aurora_tpu.ops.roll import roll3d_pallas
from aurora_tpu_torch.ops import mlp as t_mlp
from aurora_tpu_torch.ops.mlp import mlp_adaln_residual
from aurora_tpu_torch.ops.resampler import perceiver_core
from aurora_tpu_torch.ops.roll import roll3d
from aurora_tpu_torch.ops.window_attention import (
    sdpa_windows,
    window_attention_tail,
    window_attention_windowed,
)
from tests.test_torch_support import max_rel

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _pair(a: np.ndarray, name: str):
    """The same values as a JAX array and a torch CPU tensor of dtype ``name``."""
    jdt, tdt, _ = DTYPES[name]
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a, np.float32)).to(tdt)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "shifts", [(0, 0, 0), (1, 3, 6), (-1, -3, -6), (0, 2, -5), (3, 0, 0), (-5, 7, 13)]
)
def test_roll_matches_pallas_exactly(shifts, dtype):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal((2, 4, 6, 12, 16)), dtype)
    want = np.asarray(roll3d_pallas(xj, shifts, interpret=True)).astype(np.float32)
    got = roll3d(xt, shifts).float().numpy()
    assert np.array_equal(got, want)


def _attn_inputs(masked: bool, dtype: str, num_heads: int = 2, seed: int = 0):
    rng = np.random.default_rng(seed)
    ws, ss = (2, 3, 4), (1, 1, 2)
    C, H, W = 4, 7, 10  # padded to (4, 9, 12): pad tokens in unmasked and masked windows
    Cp, Hp, Wp = 4, 9, 12
    B, D = 2, 8 * num_heads
    x = rng.standard_normal((B, Cp, Hp, Wp, D))
    w = [
        0.2 * rng.standard_normal((D, 3 * D)), 0.05 * rng.standard_normal(3 * D),
        0.2 * rng.standard_normal((D, D)), 0.05 * rng.standard_normal(D),
        rng.standard_normal((B, D)), 0.3 * rng.standard_normal((B, D)),
    ]
    groups = window_group_ids(C, H, W, ws, ss) if masked else None
    xj, xt = _pair(x, dtype)
    wj = [jnp.asarray(a, jnp.float32) for a in w]
    wt = [torch.from_numpy(a).float() for a in w]
    return ws, groups, xj, xt, wj, wt


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("num_heads", [1, 2])
def test_window_attention_matches_pallas(masked, dtype, num_heads):
    ws, groups, xj, xt, wj, wt = _attn_inputs(masked, dtype, num_heads)
    want = _attn_windows_5d_fused_pallas(
        xj, wj[0], wj[1], num_heads, groups, ws, interpret=True, tail=tuple(wj[2:])
    )
    got = window_attention_tail(xt, wt[0], wt[1], groups, ws, num_heads, tail=tuple(wt[2:]))
    assert got.dtype == xt.dtype and tuple(got.shape) == tuple(want.shape)
    assert max_rel(got, want) < DTYPES[dtype][2]


def test_window_attention_mask_matters():
    """The masked and unmasked results differ, so the mask is exercised."""
    ws, groups, _, xt, _, wt = _attn_inputs(True, "f32")
    masked = window_attention_tail(xt, wt[0], wt[1], groups, ws, 2, tail=tuple(wt[2:]))
    unmasked = window_attention_tail(xt, wt[0], wt[1], None, ws, 2, tail=tuple(wt[2:]))
    assert max_rel(masked, unmasked) > 1e-3


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("num_heads", [1, 2])
def test_window_attention_no_tail_matches_pallas(masked, dtype, num_heads):
    """K2 without the tail (``mlp_impl`` "pallas"/"xla"): the attention output, before proj."""
    ws, groups, xj, xt, wj, wt = _attn_inputs(masked, dtype, num_heads)
    want = _attn_windows_5d_fused_pallas(xj, wj[0], wj[1], num_heads, groups, ws, interpret=True)
    got = window_attention_tail(xt, wt[0], wt[1], groups, ws, num_heads)
    assert got.dtype == xt.dtype and tuple(got.shape) == tuple(want.shape)
    assert max_rel(got, want) < DTYPES[dtype][2]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("tail", [False, True])
def test_window_attention_windowed_matches_pallas(tail, masked, dtype):
    """K6 on partitioned ``(B, nW, N, D)`` windows, with and without the tail."""
    ws, groups, xj, _, wj, wt = _attn_inputs(masked, dtype)
    xwj = window_partition(xj, ws)
    B, C1, H1, W1, N, D = xwj.shape
    xwj = xwj.reshape(B, C1 * H1 * W1, N, D)
    xwt = torch.from_numpy(np.array(xwj.astype(jnp.float32))).to(DTYPES[dtype][1])
    want = _attn_windows_qkv_fused_pallas(
        xwj, wj[0], wj[1], 2, groups, interpret=True, tail=tuple(wj[2:]) if tail else None
    )
    got = window_attention_windowed(
        xwt, wt[0], wt[1], groups, 2, tail=tuple(wt[2:]) if tail else None
    )
    assert got.dtype == xwt.dtype and tuple(got.shape) == tuple(want.shape)
    assert max_rel(got, want) < DTYPES[dtype][2]


def _packed_qkv(dtype: str, seed: int = 3):
    """Packed ``(B, nW, N, 3D)`` qkv over the shifted windows of a padded (1, 3, 6) grid."""
    ws, ss = (1, 2, 4), (0, 1, 2)
    groups = window_group_ids(1, 3, 6, ws, ss)  # pads H 3 -> 4
    nW, N = groups.shape
    qkv = np.random.default_rng(seed).standard_normal((2, nW, N, 3 * 16))
    return groups, qkv


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_windows_matches_pallas(masked, dtype):
    """K7, the attention core alone over packed qkv."""
    groups, qkv = _packed_qkv(dtype)
    groups = groups if masked else None
    qj, qt = _pair(qkv, dtype)
    want = _sdpa_windows_fused_pallas(qj, 2, groups, interpret=True)
    got = sdpa_windows(qt, groups, 2)
    assert got.dtype == qt.dtype and tuple(got.shape) == tuple(want.shape)
    assert max_rel(got, want) < DTYPES[dtype][2]


def test_sdpa_windows_padding_tokens_isolated():
    """The form of tests/test_kernels.py::test_fused_window_sdpa_padding_tokens_isolated:
    garbage in the pad tokens' q/k/v leaves the real tokens' outputs unchanged, in the port
    as in the JAX kernel."""
    groups, qkv = _packed_qkv("f32", seed=1)
    pad = groups == groups.max()
    garbage = np.where(pad[None, :, :, None], 7.0, qkv)
    real = ~pad
    outs = []
    for a in (qkv, garbage):
        got = sdpa_windows(torch.from_numpy(a).float(), groups, 2).numpy()
        want = np.asarray(_sdpa_windows_fused_pallas(jnp.asarray(a, jnp.float32), 2, groups,
                                                     interpret=True))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        outs.append(got)
    np.testing.assert_allclose(outs[0][:, real], outs[1][:, real], atol=1e-4, rtol=1e-4)
    assert not np.allclose(outs[0][:, pad], outs[1][:, pad])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlp_fused_matches_pallas(dtype):
    """K8: ``fc2(GELU(fc1 x))`` with no LayerNorm or residual."""
    rng = np.random.default_rng(4)
    B, L, D, Hd = 2, 40, 32, 128
    x = rng.standard_normal((B, L, D))
    w = [
        0.2 * rng.standard_normal((D, Hd)), 0.05 * rng.standard_normal(Hd),
        0.2 * rng.standard_normal((Hd, D)), 0.05 * rng.standard_normal(D),
    ]
    xj, xt = _pair(x, dtype)
    want = mlp_fused(xj, *[jnp.asarray(a, jnp.float32) for a in w], interpret=True)
    got = t_mlp.mlp_fused(xt, *[torch.from_numpy(a).float() for a in w])
    assert got.dtype == xt.dtype and tuple(got.shape) == tuple(want.shape)
    # f32: the JAX kernel's erf polynomial puts it 2.8e-5 from the float64 result here, the
    # plain version 2.7e-7; the 5e-5 of the K3 test.
    assert max_rel(got, want) < (5e-5 if dtype == "f32" else DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("scale_bias", [0.0, 1.0])
def test_linear_adaln_residual_matches_pallas(scale_bias, dtype):
    """K5: ``shortcut + LN(x @ W + b) * (scale_bias + scale) + shift``."""
    rng = np.random.default_rng(5)
    B, L, D = 2, 40, 32
    x, shortcut = rng.standard_normal((B, L, D)), rng.standard_normal((B, L, D))
    w = [0.2 * rng.standard_normal((D, D)), 0.05 * rng.standard_normal(D)]
    film = [rng.standard_normal((B, D)), 0.3 * rng.standard_normal((B, D))]
    (xj, xt), (sj, st) = _pair(x, dtype), _pair(shortcut, dtype)
    want = linear_adaln_residual_fused(
        xj, *[jnp.asarray(a, jnp.float32) for a in w], sj,
        *[jnp.asarray(a, jnp.float32) for a in film], scale_bias=scale_bias, interpret=True,
    )
    got = t_mlp.linear_adaln_residual(
        xt, *[torch.from_numpy(a).float() for a in w], st,
        *[torch.from_numpy(a).float() for a in film], scale_bias=scale_bias,
    )
    assert got.dtype == xt.dtype and tuple(got.shape) == tuple(want.shape)
    assert max_rel(got, want) < DTYPES[dtype][2]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("form", ["backbone", "perceiver"])
def test_mlp_adaln_residual_matches_pallas(form, dtype):
    rng = np.random.default_rng(1)
    B, L, D, Hd = (2, 40, 32, 128) if form == "backbone" else (1, 56, 32, 64)
    x = rng.standard_normal((B, L, D))
    w = [
        0.2 * rng.standard_normal((D, Hd)), 0.05 * rng.standard_normal(Hd),
        0.2 * rng.standard_normal((Hd, D)), 0.05 * rng.standard_normal(D),
    ]
    if form == "backbone":  # per-batch FiLM modulations
        shift, scale = rng.standard_normal((B, D)), 0.3 * rng.standard_normal((B, D))
    else:  # ln2 affine in the FiLM slot, scale_bias 0 (perceiver.py:341-351)
        shift, scale = 0.1 * rng.standard_normal((1, D)), 1 + 0.1 * rng.standard_normal((1, D))
    xj, xt = _pair(x, dtype)
    args = w + [shift, scale]
    want = mlp_adaln_residual_fused(
        xj, *[jnp.asarray(a, jnp.float32) for a in args], scale_bias=0.0, interpret=True
    )
    got = mlp_adaln_residual(xt, *[torch.from_numpy(a).float() for a in args], scale_bias=0.0)
    assert got.dtype == xt.dtype
    # In f32 the JAX kernel's erf polynomial (within 2.7e-7 of erf) passes through fc2 and
    # is scaled up by the LayerNorm: 5e-5 here, against 1e-5 for the other kernels.
    assert max_rel(got, want) < (5e-5 if dtype == "f32" else DTYPES[dtype][2])


@pytest.mark.parametrize("value_bf16", [False, True])
@pytest.mark.parametrize("K,Q", [(5, 3), (3, 5)])
def test_perceiver_core_matches_pallas(K, Q, value_bf16):
    rng = np.random.default_rng(2)
    M, D, h = 64, 32, 4
    dh = D // h
    a = dict(
        ctx=rng.standard_normal((K, M, D)),
        wk=0.3 * rng.standard_normal((D, D)), wv=0.3 * rng.standard_normal((D, D)),
        qh=rng.standard_normal((Q, h, dh)), wout=0.3 * rng.standard_normal((D, D)),
        ln1_w=1 + 0.1 * rng.standard_normal(D), ln1_b=0.1 * rng.standard_normal(D),
        queries=rng.standard_normal((Q, D)),
    )
    j = {k: jnp.asarray(v, jnp.float32) for k, v in a.items()}
    want = perceiver_core_fused(
        j["ctx"], j["wk"], None, j["wv"], None, make_q_major_blockdiag(j["qh"], h), j["wout"],
        None, j["ln1_w"], j["ln1_b"], j["queries"], num_heads=h, scale=dh**-0.5,
        value_bf16=value_bf16, interpret=True,
    )
    t = {k: torch.from_numpy(v).float() for k, v in a.items()}
    got = perceiver_core(**t, scale=dh**-0.5, value_bf16=value_bf16)
    assert got.dtype == (torch.bfloat16 if value_bf16 else torch.float32)
    assert max_rel(got, want) < (1e-2 if value_bf16 else 1e-5)
