"""Float32 K3 and K8 on the tensor cores, each product in three TF32 parts
(``csrc/gemm_tf32x3_sm90.cuh``, ``csrc/mlp_f32.cu::mlp_rows_f32``), on the CPU.

* ``ops/mlp.py::tf32_split``, the bits the card's split gives (``cvt.rna.tf32.f32``): ``hi``'s
  and ``lo``'s low 13 bits are zero, ``hi + lo`` is within 2^-22 of ``v`` relative, ties round
  away from zero (against a float64 rounding written apart from the bit arithmetic), signs,
  zeros and subnormals keep their meaning, an inf or a NaN keeps ``hi`` and gets ``lo = 0``.
* The kernel's shared-memory reads of the tokens (A): under the TMA's 128-byte swizzle each
  thread reads the elements of the m64k8 TF32 register fragment, and every read a warp makes
  takes one bank pass; the split in integer operations gives ``tf32_split``'s bits.
* A mirror of the three-part products (``a_hi w_hi + a_hi w_lo + a_lo w_hi`` in f32, the parts
  from ``tf32_split``) through K3's and K8's launches chunk by chunk, against the JAX
  package's ``mlp_adaln_residual_fused`` and ``mlp_fused`` in float32, interpret mode, at the
  existing 5e-5 of max |reference|; the one-part mirror (``a_hi w_hi``: a kernel without the
  split) must fail that bound.
* The split scratch: one per call, the same for every chunk, ``4 * D * Hd`` f32.
* ``tools.bound_ms``'s three-part term: 3 x the flops at the TF32 peak, 364.0 ms a float32
  step of K3 and 316.3 of K8 (the 1.3 B model's shapes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from aurora_tpu.ops.mlp import mlp_adaln_residual_fused, mlp_fused
from aurora_tpu_torch.ops import _lib, mlp
from aurora_tpu_torch.tools import PEAK_F32, PEAK_TF32, bound_ms
from tests.test_torch_f32 import _Entries, _require_anywhere, _t
from tests.test_torch_support import max_rel


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, the caller's count restored after (the suite runs six workers
    at once; see ``tests/test_torch_training.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy().astype(np.int64) & 0xFFFFFFFF


def _f32(values) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32)


def _from_bits(bits) -> torch.Tensor:
    return torch.from_numpy(np.asarray(bits, dtype=np.uint32).view(np.int32)).view(torch.float32)


# ------------------------------------------------------------------------------ the split


def _rna_tf32_f64(v: np.ndarray) -> np.ndarray:
    """Normal float32 values rounded to 11 significant bits, to nearest with ties away from
    zero, in float64 arithmetic (no bit manipulation)."""
    m, e = np.frexp(np.abs(v))  # |v| = m 2^e, m in [0.5, 1)
    return np.sign(v) * np.ldexp(np.floor(np.ldexp(m, 11) + 0.5), e - 11)


def test_tf32_split_rounds_to_11_bits_and_keeps_22():
    rng = np.random.default_rng(0)
    v = (rng.standard_normal(200_000) * np.exp(rng.uniform(-30, 30, 200_000))).astype(np.float32)
    hi, lo = mlp.tf32_split(torch.from_numpy(v))
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    np.testing.assert_array_equal(hi.numpy().astype(np.float64), _rna_tf32_f64(v.astype(np.float64)))
    vd = v.astype(np.float64)
    # hi + lo is exact in float64; what is left is lo's own rounding
    err = np.abs(hi.numpy().astype(np.float64) + lo.numpy().astype(np.float64) - vd)
    assert (err <= 2.0**-22 * np.abs(vd)).all()
    assert (lo != 0).float().mean() > 0.99  # the split carries bits almost everywhere


def test_tf32_split_ties_round_away_from_zero():
    one = 1.0
    v = _f32([one + 2**-11, -(one + 2**-11), one + 3 * 2**-11, -(one + 3 * 2**-11),
              one + 2**-11 - 2**-23, 3 * 2**-12])
    hi, lo = mlp.tf32_split(v)
    want = [one + 2**-10, -(one + 2**-10), one + 2**-9, -(one + 2**-9), one, 3 * 2**-12]
    assert hi.tolist() == want
    assert lo.tolist()[:4] == [-(2**-11), 2**-11, -(2**-11), 2**-11]
    assert (hi.double() + lo.double()).tolist()[:4] == v.double().tolist()[:4]  # exact


def test_tf32_split_signs_zeros_and_subnormals():
    hi, lo = mlp.tf32_split(_f32([0.0, -0.0]))
    assert _bits(hi).tolist() == [0, 0x80000000] and _bits(lo).tolist() == [0, 0]
    rng = np.random.default_rng(1)
    sub = rng.integers(1, 0x007FFFFF, 10_000, dtype=np.uint32)  # every subnormal magnitude
    v = _from_bits(np.concatenate([sub, sub | 0x80000000]))
    hi, lo = mlp.tf32_split(v)
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    n = len(sub)
    assert torch.equal(hi[n:], -hi[:n]) and torch.equal(lo[n:], -lo[:n])  # odd in v
    # at subnormal scale a TF32 part keeps bits down to 2^-136: the split is exact to its
    # half step
    err = (hi.double() + lo.double() - v.double()).abs()
    assert (err <= 2.0**-137).all()
    # the normal range: odd in v as well
    w = torch.from_numpy(rng.standard_normal(10_000).astype(np.float32))
    (h1, l1), (h2, l2) = mlp.tf32_split(w), mlp.tf32_split(-w)
    assert torch.equal(h2, -h1) and torch.equal(l2, -l1)


def _split_int(bits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``gemm_tf32x3_sm90.cuh::split`` on uint32 bits: a finite value's signed bits plus
    0x1000 with the low 13 bits cleared, ``lo`` the same of ``v - hi``; non-finite: ``hi = v``,
    ``lo = 0``."""
    finite = (bits & 0x7FFFFFFF) < 0x7F800000
    hi = np.where(finite, (bits + 0x1000) & 0xFFFFE000, bits).astype(np.uint32)
    with np.errstate(invalid="ignore"):  # inf - inf, NaN: dropped by the mask below
        d = (bits.view(np.float32) - hi.view(np.float32)).view(np.uint32)
    lo = np.where(finite, (d + 0x1000) & 0xFFFFE000, 0).astype(np.uint32)
    return hi, lo


def test_kernels_integer_split_gives_the_same_bits():
    """The kernel splits with integer operations on the signed bits, ``tf32_split`` rounds
    the magnitude. Random bit patterns of every class (normal, subnormal, zero, inf, NaN,
    both signs) give the same hi and lo."""
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32)
    bits[:8] = [0, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0x00000FFF, 0x3F801000,
                0xBF801000]
    hi, lo = _split_int(bits)
    want_hi, want_lo = mlp.tf32_split(torch.from_numpy(bits.view(np.int32)).view(torch.float32))
    finite = (bits & 0x7FFFFFFF) < 0x7F800000
    np.testing.assert_array_equal(hi[finite], _bits(want_hi)[finite])
    np.testing.assert_array_equal(lo, _bits(want_lo))
    nonfinite_hi = _bits(want_hi)[~finite]
    np.testing.assert_array_equal(hi[~finite], nonfinite_hi)  # kept as they are


def test_tf32_split_non_finite_gives_lo_zero():
    v = _f32([float("inf"), float("-inf"), float("nan"), 1.5])
    hi, lo = mlp.tf32_split(v)
    assert hi[0].item() == float("inf") and hi[1].item() == float("-inf")
    assert torch.isnan(hi[2]) and hi[3].item() == 1.5
    assert _bits(lo).tolist() == [0, 0, 0, 0]
    with pytest.raises(ValueError, match="float32"):
        mlp.tf32_split(v.double())


# ------------------------------------------------------------------------------ A's reads


BK = 32  # floats of k a stage: 128-byte rows


def _tma_byte(r: int, k: int) -> int:
    """Where the TMA puts float k of row r of a tile of 128-byte rows under the 128-byte
    swizzle: address bits 4-6 (the 16-byte piece) XOR-ed with bits 7-9."""
    addr = r * 4 * BK + 4 * k
    return addr ^ (((addr >> 7) & 7) << 4)


def _kernel_read(wg, warp, lane, kk, i):
    """``gemm_tf32x3_sm90.cuh::load_split_a``'s byte offset of value i of k8 step kk, and the
    (row, k) of the tile it stands for in the m64k8 fragment (rows 64 wg + 16 warp + q (+ 8),
    k 8 kk + t (+ 4))."""
    q, t = lane >> 2, lane & 3
    r = 64 * wg + 16 * warp + q + 8 * (i & 1)
    c = 2 * kk + (i >> 1)
    return r * 4 * BK + ((c ^ (r & 7)) << 4) + 4 * t, (r, 8 * kk + t + 4 * (i >> 1))


def test_a_fragment_reads_follow_the_swizzle_in_one_pass():
    seen = set()
    for wg in range(2):
        for warp in range(4):
            for kk in range(BK // 8):
                for i in range(4):
                    banks = set()
                    for lane in range(32):
                        at, (r, k) = _kernel_read(wg, warp, lane, kk, i)
                        assert at == _tma_byte(r, k)
                        banks.add((at // 4) % 32)
                        seen.add((r, k))
                    assert len(banks) == 32  # one pass: 32 lanes on 32 banks
    assert seen == {(r, k) for r in range(128) for k in range(BK)}  # the whole tile, once


# ------------------------------------------------------------------------------ mirrors


def tf32x3_matmul(a: torch.Tensor, w: torch.Tensor, parts: int = 3) -> torch.Tensor:
    """``a @ w`` as the kernel takes it: ``a_hi w_hi + a_hi w_lo + a_lo w_hi`` (``parts`` 3)
    or ``a_hi w_hi`` alone (1), each product of TF32 parts exact in f32, summed in f32."""
    a_hi, a_lo = mlp.tf32_split(a.contiguous())
    w_hi, w_lo = mlp.tf32_split(w.contiguous())
    out = a_hi @ w_hi
    if parts == 3:
        out = out + a_hi @ w_lo + a_lo @ w_hi
    return out


def mlp_tf32x3_mirror(x, w1, b1, w2, b2, film=None, cap=mlp.MLP_SCRATCH_BYTES, parts=3):
    """K3's (``film`` = (shift, scale, scale_bias)) or K8's (None) float32 launches in
    PyTorch, chunk of rows by chunk of rows as ``mlp_row_chunks(..., elem=4)`` cuts them: fc1
    in three TF32 parts with the bias and the exact erf GELU, fc2 in three parts with the
    bias, for K3 the row kernel with FiLM row ``(row_base + row) // L`` (the extension of
    ``tests/test_torch_f32.py::mlp_f32_mirror``)."""
    B, L, D = x.shape
    xr = x.reshape(B * L, D)
    out = torch.empty_like(xr)
    for r0, rows in mlp.mlp_row_chunks(B * L, w1.shape[1], cap, elem=4):
        xc = xr[r0:r0 + rows]
        y = tf32x3_matmul(F.gelu(tf32x3_matmul(xc, w1, parts) + b1), w2, parts) + b2
        if film is None:
            out[r0:r0 + rows] = y
            continue
        shift, scale, scale_bias = film
        mean = y.mean(-1, keepdim=True)
        rstd = torch.rsqrt((y - mean).square().mean(-1, keepdim=True) + 1e-5)
        f = (r0 + torch.arange(rows)) // L
        out[r0:r0 + rows] = xc + ((y - mean) * rstd * (scale_bias + scale[f]) + shift[f])
    return out.reshape(x.shape)


def _mlp_inputs(seed=4, B=2, L=200, D=64, Hd=256):
    """Pre-activations of unit size (weights of std 0.1 at D = 64): the JAX kernel's erf
    polynomial stays within 1e-6 of the exact GELU there."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, D)), 0.1 * rng.standard_normal((D, Hd)),
            0.05 * rng.standard_normal(Hd), 0.1 * rng.standard_normal((Hd, D)),
            0.05 * rng.standard_normal(D), rng.standard_normal((B, D)),
            0.3 * rng.standard_normal((B, D))]


@pytest.fixture(scope="module")
def pallas_refs():
    """The JAX package's K3 (scale_bias 0.5) and K8 in float32, interpret mode, on one set of
    inputs: two batch elements of 200 rows (chunks of 128 straddle the FiLM rows)."""
    a = _mlp_inputs()
    j = [jnp.asarray(v, jnp.float32) for v in a]
    k3 = mlp_adaln_residual_fused(*j, scale_bias=0.5, interpret=True)
    k8 = mlp_fused(*j[:5], interpret=True)
    return [torch.from_numpy(v).float() for v in a], k3, k8


def _mirror_errs(pallas_refs, parts):
    t, k3, k8 = pallas_refs
    Hd = t[1].shape[1]
    cap = 128 * Hd * 4  # 128 rows a chunk: four chunks
    assert len(mlp.mlp_row_chunks(400, Hd, cap, elem=4)) == 4
    got3 = mlp_tf32x3_mirror(*t[:5], film=(t[5], t[6], 0.5), cap=cap, parts=parts)
    got8 = mlp_tf32x3_mirror(*t[:5], cap=cap, parts=parts)
    return max_rel(got3, k3), max_rel(got8, k8)


def test_three_part_mirror_matches_pallas(pallas_refs):
    e3, e8 = _mirror_errs(pallas_refs, parts=3)
    assert e3 < 5e-5 and e8 < 5e-5


def test_one_part_mirror_fails_the_bound(pallas_refs):
    """``a_hi w_hi`` alone, what a kernel without the split computes: TF32's 11 bits show."""
    e3, e8 = _mirror_errs(pallas_refs, parts=1)
    assert e3 > 5e-5 and e8 > 5e-5


# ------------------------------------------------------------------------------ the scratch


@pytest.fixture
def entries(monkeypatch):
    e = _Entries()
    monkeypatch.setattr(_lib, "kernel", e.kernel)
    monkeypatch.setattr(_lib, "require", _require_anywhere)
    monkeypatch.setattr(_lib, "stream", lambda t: 0)
    monkeypatch.setattr(_lib, "LAUNCHES", dict.fromkeys(_lib.LAUNCHES, 0))
    monkeypatch.setattr(_lib, "LAUNCHES_BY", {})
    return e


def test_one_split_scratch_a_call(entries, monkeypatch):
    """Every chunk of a call gets the same scratch of 4 D Hd f32 (the first chunk's launch,
    row_base 0, writes the split); bf16 calls get none; a scratch of another size raises."""
    D, Hd, M = 256, 1024, 200_000
    sizes = []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        t = empty(*shape, **kw)
        sizes.append((t.numel(), t.dtype, t.data_ptr()))
        return t

    monkeypatch.setattr(torch, "empty", recording_empty)
    x = empty(1, M, D)
    w = (_t(D, Hd), _t(Hd), _t(Hd, D, seed=1), _t(D))
    mlp._mlp_fused_launch(x, *w)
    monkeypatch.setattr(torch, "empty", empty)
    chunks = mlp.mlp_row_chunks(M, Hd, elem=4)
    assert len(entries.calls) == len(chunks) > 1
    scratch = {a[18] for _, _, a in entries.calls}
    assert len(scratch) == 1
    (ptr,) = scratch
    assert (4 * D * Hd, torch.float32, ptr) in sizes
    assert [a[12] for _, _, a in entries.calls] == [r0 for r0, _ in chunks]  # row_base 0 first
    ops = mlp._mlp_operands(x, *w)
    fn = mlp._mlp_rows_entry(x)
    with pytest.raises(ValueError, match="wsplit"):
        mlp._mlp_rows(fn, x.view(M, D), ops, empty(M, D), None, wsplit=empty(4 * D * Hd - 1))


# ------------------------------------------------------------------------------ bounds

# rows, D, hidden and K3 launches a float32 step of the 1.3 B model: the backbone's three
# stages (12, 20 and 16 blocks), the level aggregation's and de-aggregation's MLP halves
K3_STEP = ((259200, 512, 2048, 12), (64800, 1024, 4096, 20), (16200, 2048, 8192, 16),
           (194400, 512, 2048, 1), (842400, 1024, 2048, 1))


def test_bound_ms_three_part_term():
    fl = 4 * 259200 * 512 * 2048
    ms, by = bound_ms(flops_tf32x3=fl)
    assert by == "operations" and ms == pytest.approx(1e3 * 3 * fl / PEAK_TF32)
    assert PEAK_TF32 == 495e12
    # the same products at the FFMA pipes' rate: 2.46x the three-part bound
    assert bound_ms(flops_f32=fl)[0] / ms == pytest.approx(PEAK_TF32 / 3 / PEAK_F32)
    # terms add; bytes win only above them
    assert bound_ms(flops_tf32x3=fl, flops_f32=fl)[0] == pytest.approx(
        ms + bound_ms(flops_f32=fl)[0])
    assert bound_ms(flops_tf32x3=1.0, nbytes=1e9)[1] == "bytes"
    k3 = sum(n * bound_ms(flops_tf32x3=4 * M * D * Hd)[0] for M, D, Hd, n in K3_STEP)
    k8 = sum(n * bound_ms(flops_tf32x3=4 * M * D * Hd)[0] for M, D, Hd, n in K3_STEP[:3])
    assert (round(k3, 1), round(k8, 1)) == (364.0, 316.3)
