"""Float32 K2 and K6 with their qkv and proj products on the tensor cores, each in three TF32
parts (``csrc/window_attention_f32.cu`` on ``csrc/gemm_tf32x3_sm90.cuh``), on the CPU.

* A mirror of float32 K2's launches with qkv and proj as the kernel takes them (``a_hi w_hi +
  a_hi w_lo + a_lo w_hi``, the parts from ``tf32_split``: ``tests/test_torch_f32_gemm.py::
  tf32x3_matmul``) and the core in full f32 in the kernel's order of work, against the JAX
  package's ``_attn_windows_5d_fused_pallas`` in float32, interpret mode, masked and unmasked,
  with and without the tail, at ``chip_smoke.py``'s float32 bound 9e-5 by its measures (with
  the tail the branch error less one float32 ulp, without it max |error| over max |reference|);
  the one-part mirror (``a_hi w_hi``: a kernel without the split) must fail that bound.
* K6's mirror on ``window_partition(x)``, reversed, gives K2's bits on ``x``.
* The float32 wrapper allocates one split scratch of ``8 D^2`` f32 a call and hands it to the C
  entry before the stream; the bf16 entry gets none; the float32 argument list is the bf16 one
  with one more pointer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.model.swin3d import _attn_windows_5d_fused_pallas
from aurora_tpu.ops.masks import window_group_ids
from aurora_tpu_torch.ops import window_attention
from aurora_tpu_torch.ops.window_attention import window_partition, window_reverse
from aurora_tpu_torch.tools import branch_err, rel_err
from tests.test_torch_f32 import _ln_film_residual, _t, entries, grid5d_rows  # noqa: F401
from tests.test_torch_f32_gemm import tf32x3_matmul
from tests.test_torch_f32_windows import packed_rows, window_core_f32_mirror

TOL = 9e-5  # chip_smoke.TOL_F32["window_attention"]
WS, SS, HEADS, D = (2, 6, 12), (1, 3, 6), 2, 128
C, H, W = 4, 12, 24  # two windows along each axis: eight a batch element


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, the caller's count restored after (the suite runs six workers
    at once; see ``tests/test_torch_training.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def window_tf32x3_mirror(x, rows, wqkv, bqkv, groups, nW, heads, tail, parts=3):
    """K2's (``rows`` from ``grid5d_rows``) or K6's (``packed_rows``) float32 launches on the
    token rows ``x`` (rows, D): qkv over the rows in their stored order in ``parts`` TF32 parts
    with the bias, the core in f32 through the row map, with the tail proj in ``parts`` parts
    with the bias and the row kernel (FiLM row ``row // (nW 144)``)."""
    qkv = tf32x3_matmul(x, wqkv, parts) + bqkv
    attn = window_core_f32_mirror(qkv, torch.empty_like(x), rows, groups, nW, heads)
    if tail is None:
        return attn
    wproj, bproj, shift, scale = tail
    y = tf32x3_matmul(attn, wproj, parts) + bproj
    return _ln_film_residual(y, x, shift, scale, nW * rows.shape[1])


def k2_tf32x3_mirror(xp, wqkv, bqkv, groups, ws, heads, tail, parts=3):
    B, Cp, Hp, Wp, Dx = xp.shape
    rows = grid5d_rows(B, Cp, Hp, Wp, ws)
    out = window_tf32x3_mirror(xp.reshape(-1, Dx), rows, wqkv, bqkv, groups, rows.shape[0] // B,
                               heads, tail, parts)
    return out.reshape(xp.shape)


def k6_tf32x3_mirror(xw, wqkv, bqkv, groups, heads, tail, parts=3):
    B, nW, N, Dx = xw.shape
    out = window_tf32x3_mirror(xw.reshape(-1, Dx), packed_rows(B * nW, N), wqkv, bqkv, groups,
                               nW, heads, tail, parts)
    return out.reshape(xw.shape)


def _inputs(seed=5, B=1):
    """Tokens of unit size, weights of std 0.1 (qkv and proj outputs of about unit size at
    D = 128), FiLM at unit gain."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, C, H, W, D)), 0.1 * rng.standard_normal((D, 3 * D)),
            0.05 * rng.standard_normal(3 * D), 0.1 * rng.standard_normal((D, D)),
            0.05 * rng.standard_normal(D), 0.1 * rng.standard_normal((B, D)),
            rng.standard_normal((B, D))]


@pytest.fixture(scope="module")
def pallas_k2():
    """The JAX package's K2 in float32, interpret mode, on one set of inputs, masked and
    unmasked, with and without the tail."""
    a = _inputs()
    j = [jnp.asarray(v, jnp.float32) for v in a]
    refs = {}
    for masked in (True, False):
        groups = window_group_ids(C, H, W, WS, SS) if masked else None
        for tail in (True, False):
            refs[masked, tail] = torch.from_numpy(np.array(_attn_windows_5d_fused_pallas(
                j[0], j[1], j[2], HEADS, groups, WS, interpret=True,
                tail=tuple(j[3:]) if tail else None)))
    return [torch.from_numpy(v).float() for v in a], refs


def _mirror_err(pallas_k2, masked, tail, parts):
    t, refs = pallas_k2
    groups = window_group_ids(C, H, W, WS, SS) if masked else None
    got = k2_tf32x3_mirror(t[0], t[1], t[2], groups, WS, HEADS, tuple(t[3:]) if tail else None,
                           parts)
    want = refs[masked, tail]
    return branch_err(got, want, t[0])[1] if tail else rel_err(got, want)


CASES = [pytest.param(m, tl, id=f"{'masked' if m else 'unmasked'}-{'tail' if tl else 'no_tail'}")
         for m in (True, False) for tl in (True, False)]


@pytest.mark.parametrize("masked, tail", CASES)
def test_three_part_mirror_matches_pallas(pallas_k2, masked, tail):
    assert _mirror_err(pallas_k2, masked, tail, parts=3) < TOL


@pytest.mark.parametrize("masked, tail", CASES)
def test_one_part_mirror_fails_the_bound(pallas_k2, masked, tail):
    """``a_hi w_hi`` alone, what a kernel without the split computes: TF32's 11 bits show."""
    assert _mirror_err(pallas_k2, masked, tail, parts=1) > TOL


@pytest.mark.parametrize("tail", [True, False], ids=["tail", "no_tail"])
def test_k6_mirror_on_the_partition_gives_k2s_bits(pallas_k2, tail):
    t, _ = pallas_k2
    groups = window_group_ids(C, H, W, WS, SS)
    tl = tuple(t[3:]) if tail else None
    k2 = k2_tf32x3_mirror(t[0], t[1], t[2], groups, WS, HEADS, tl)
    k6 = k6_tf32x3_mirror(window_partition(t[0], WS).contiguous(), t[1], t[2], groups, HEADS, tl)
    assert torch.equal(window_reverse(k6, WS, C, H, W), k2)


# ------------------------------------------------------------------------------ the scratch


D2, HEADS2 = 256, 4


def _launch(kernel, dtype, tail):
    """K2 on a (2, 2, 6, 12) grid or K6 on its partition, D = 256, through the wrapper's
    launch path."""
    xp = _t(2, 2, 6, 12, D2, dtype=dtype)
    w = (_t(D2, 3 * D2, dtype=dtype, std=0.02), _t(3 * D2, dtype=dtype))
    tl = ((_t(D2, D2, dtype=dtype, std=0.02), _t(D2), _t(2, D2), _t(2, D2)) if tail
          else (None,) * 4)
    groups = window_group_ids(2, 6, 12, WS, (1, 3, 6))
    if kernel == "K2":
        return window_attention._window_attention_tail_launch(xp, *w, groups, WS, HEADS2, *tl,
                                                              1e-5)
    xw = window_partition(xp, WS).contiguous()
    return window_attention._window_attention_windowed_launch(xw, *w, groups, HEADS2, *tl, 1e-5)


@pytest.mark.parametrize("tail", [True, False], ids=["tail", "no_tail"])
@pytest.mark.parametrize("kernel", ["K2", "K6"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_one_split_scratch_a_call(entries, monkeypatch, dtype, kernel, tail):
    """A float32 call allocates one scratch of 8 D^2 f32 and passes it before the stream; a
    bf16 call allocates none and passes the bf16 entry's arguments."""
    empty, sizes = torch.empty, []

    def recording_empty(*shape, **kw):
        t = empty(*shape, **kw)
        sizes.append((t.numel(), t.dtype, t.data_ptr()))
        return t

    monkeypatch.setattr(torch, "empty", recording_empty)
    _launch(kernel, dtype, tail)
    monkeypatch.setattr(torch, "empty", empty)
    ((lib, fn, a),) = entries.calls
    split = [s for s in sizes if s[:2] == (8 * D2 * D2, torch.float32)]
    if dtype == torch.float32:
        assert (lib, fn) == ("window_attention_f32", "window_attention_f32")
        assert len(a) == 25 and a[-1] == 0  # the stream last, the scratch before it
        assert [s[2] for s in split] == [a[23]]
    else:
        assert (lib, fn) == ("window_attention", "window_attention")
        assert len(a) == 24 and not split


def test_a_given_scratch_is_checked(entries):
    x = _t(1, 2, 144, D2)
    w = (_t(D2, 3 * D2, std=0.02), _t(3 * D2))
    fn = window_attention._window_attention_entry(x)
    args = (x, *w, None, HEADS2, None, 1e-5, 2, 288, (0, 0, 0), (0, 0, 0), "k6")
    ws = torch.empty(8 * D2 * D2)
    window_attention._window_attention_call(fn, *args, wsplit=ws)
    assert entries.calls[-1][2][23] == ws.data_ptr()
    for bad in (torch.empty(8 * D2 * D2 - 1), torch.empty(8 * D2 * D2, dtype=torch.float64)):
        with pytest.raises(ValueError, match="wsplit"):
            window_attention._window_attention_call(fn, *args, wsplit=bad)


def test_f32_arguments_are_the_bf16_ones_and_the_scratch():
    bf, f32 = window_attention._WINDOW_ATTENTION_ARGS, window_attention._WINDOW_ATTENTION_F32_ARGS
    assert len(f32) == len(bf) + 1
    assert f32[:-2] == bf[:-1] and f32[-2:] == [bf[-1]] * 2  # pointers: the scratch, the stream
