"""The float32 window core (``csrc/window_attention_f32.cu``: ``window_core_f32``, inside
float32 K2 and K6 and alone as float32 K7) on the CPU.

* Its shared-memory address maps, mirrored on the host: the q tile's and the k tile's
  swizzled 16-byte chunks are each a bijection onto the tile (v is kept as stored), the
  weights' staging rows fit a warp's 18 rows of q or k without overlap, and every read or
  write a warp makes in each
  phase takes the fewest bank passes its bytes allow (a pass serves one 16-byte chunk per
  group of 4 banks, 8 groups): the logits' k reads (16 keys, 256 bytes: 2 passes) and q reads
  (two rows, one per half: 1 pass), the weights' 4-byte stores (32 distinct banks) and
  16-byte reads (1 pass), and ``w @ v``'s v reads (a key's 256 bytes: 2 passes).
* ``tools.kernel_ablate.splice_core``, which builds an older core into this file's entries:
  only the anonymous namespace is taken from the other file.
* Its arithmetic (``tests/test_torch_f32_windows.py::window_core_f32_mirror``, the kernel's
  order of work) at the kernel's own head width, dh 64 with 4 heads (D = 256), masked and
  unmasked, on a padded grid: K2 with and without the tail through the 5D row map, K6 on the
  partitioned windows and K7 on packed qkv, each against the JAX package's Pallas kernel in
  float32 in interpret mode, at 1e-5 of max |reference| (float32 summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.model.swin3d import (
    _attn_windows_5d_fused_pallas,
    _attn_windows_qkv_fused_pallas,
    _sdpa_windows_fused_pallas,
)
from aurora_tpu.ops.masks import window_group_ids
from aurora_tpu_torch.ops import _lib
from aurora_tpu_torch.ops.window_attention import window_partition
from aurora_tpu_torch.tools.kernel_ablate import splice_core
from tests.test_torch_f32 import window_attention_f32_mirror
from tests.test_torch_f32_windows import (
    packed_rows,
    window_attention_windowed_f32_mirror,
    window_core_f32_mirror,
)
from tests.test_torch_support import max_rel

CN, WARPS, ROWS = 144, 8, 18  # tokens, warps a block, queries a warp
HALF = ROWS // 2
STAGE_HALF = HALF * 64 + 16  # floats from a half's first staged row to the other half's


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, the caller's count restored after (the suite runs six workers
    at once; see ``tests/test_torch_training.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------------------ address maps


def k_chunk(t: int, c4: int) -> int:
    """``k_chunk``: where chunk ``c4`` (4 floats) of token ``t`` sits in the k tile."""
    return t * 16 + (c4 ^ (t & 7))


def q_chunk(t: int, c4: int) -> int:
    """``q_chunk``: where chunk ``c4`` of token ``t`` sits in the q tile (XOR 4 in the rows
    that a warp's second half reads)."""
    return t * 16 + (c4 ^ (4 if t % ROWS >= HALF else 0))


def v_chunk(t: int, c4: int) -> int:
    """The v tile: as stored."""
    return t * 16 + c4


def passes(chunks) -> int:
    """Bank passes of one warp-wide 16-byte access to the distinct chunks ``chunks``: the most
    distinct chunks that fall in one group of 4 banks (chunk % 8)."""
    chunks = set(chunks)
    return max(sum(1 for c in chunks if c % 8 == g) for g in range(8))


LANES = [(lane >> 4, lane & 15) for lane in range(32)]  # (half, kg or dq)


@pytest.mark.parametrize("chunk", [q_chunk, k_chunk, v_chunk], ids=["q", "k", "v"])
def test_tile_maps_are_bijections(chunk):
    at = sorted(chunk(t, c4) for t in range(CN) for c4 in range(16))
    assert at == list(range(CN * 16))
    # a token keeps its own 256-byte row: the swizzle moves chunks within it
    assert all(chunk(t, c4) // 16 == t for t in range(CN) for c4 in range(16))


def test_logits_reads_take_the_fewest_passes():
    for warp in range(WARPS):
        for d4 in range(16):
            for c in range(9):  # k: lane (half, kg) reads key kg + 16 c; 16 keys, 256 bytes
                assert passes(k_chunk(kg + 16 * c, d4) for _, kg in LANES) == 2
            for i in range(HALF):  # q: lane (half, kg) reads query 18 warp + 9 half + i
                rows = [ROWS * warp + HALF * h + i for h, _ in LANES]
                assert passes(q_chunk(t, d4) for t in rows) == 1
                # the kernel reads row i of its half at i 16 chunks from the half's first row
                assert {q_chunk(t, d4) - q_chunk(t - i, d4) for t in rows} == {16 * i}


def test_weight_staging_fits_and_takes_the_fewest_passes():
    # lane (half, kg) stores its weight of row i and key kg + 16 c (c < 3) of a third at float
    # half STAGE_HALF + 64 i + kg + 16 c of the warp's 18 rows (1152 floats) of q or k
    offs = [h * STAGE_HALF + 64 * i + kg + 16 * c for h, kg in LANES for i in range(HALF)
            for c in range(3)]
    assert len(set(offs)) == len(offs) == ROWS * CN // 3 and max(offs) < ROWS * 64
    for i in range(HALF):
        for c in range(3):
            banks = [(h * STAGE_HALF + 64 * i + kg + 16 * c) % 32 for h, kg in LANES]
            assert len(set(banks)) == 32
        for j in range(0, CN // 3, 4):  # lane (half, dq) reads 4 weights of row i
            assert passes((h * STAGE_HALF + 64 * i + j) // 4 for h, _ in LANES) == 1


def test_v_reads_take_the_fewest_passes():
    for key in range(CN):  # lane (half, dq) reads features 4 dq .. 4 dq + 3 of one key
        assert passes(v_chunk(key, dq) for _, dq in LANES) == 2


def test_splice_core_takes_the_namespace_only(tmp_path):
    src = _lib.CSRC / "window_attention_f32.cu"
    text = src.read_text()
    head, rest = text.split("\nnamespace {\n", 1)
    _, tail = rest.split("\n}  // namespace\n", 1)
    old = tmp_path / "old.cu"
    old.write_text("// an older file\n#include <x>\nnamespace {\nint old_core;\n}  // namespace\n"
                   "extern \"C\" int old_entry();\n")
    out = splice_core(src, old, tmp_path / "spliced" / "window_attention_f32.cu")
    assert out.read_text() == head + "\nnamespace {\nint old_core;" + "\n}  // namespace\n" + tail
    assert splice_core(src, src, tmp_path / "same.cu").read_text() == text


# ------------------------------------------------------------------------------ arithmetic at dh 64

C, H, W, WS, SS, HEADS, D = 2, 10, 20, (2, 6, 12), (1, 3, 6), 4, 256  # padded to 2 x 12 x 24


def _k2_args(rng):
    Cp, Hp, Wp = C, H + (-H) % WS[1], W + (-W) % WS[2]
    a = [rng.standard_normal((1, Cp, Hp, Wp, D)), 0.05 * rng.standard_normal((D, 3 * D)),
         0.05 * rng.standard_normal(3 * D), 0.05 * rng.standard_normal((D, D)),
         0.05 * rng.standard_normal(D), rng.standard_normal((1, D)),
         0.3 * rng.standard_normal((1, D))]
    return [jnp.asarray(v, jnp.float32) for v in a], [torch.from_numpy(v).float() for v in a]


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("kernel", ["K2 tail", "K2", "K6 tail", "K7"])
def test_core_mirror_at_the_kernels_head_width_matches_pallas(kernel, masked):
    rng = np.random.default_rng(17)
    groups = window_group_ids(C, H, W, WS, SS) if masked else None
    j, t = _k2_args(rng)
    tail = kernel.endswith("tail")
    if kernel.startswith("K2"):
        want = _attn_windows_5d_fused_pallas(j[0], j[1], j[2], HEADS, groups, WS, interpret=True,
                                             tail=tuple(j[3:]) if tail else None)
        got = window_attention_f32_mirror(t[0], t[1], t[2], groups, WS, HEADS,
                                          tuple(t[3:]) if tail else None)
    elif kernel == "K6 tail":
        xw = window_partition(t[0], WS).contiguous()
        want = _attn_windows_qkv_fused_pallas(jnp.asarray(xw.numpy()), j[1], j[2], HEADS, groups,
                                              interpret=True, tail=tuple(j[3:]))
        got = window_attention_windowed_f32_mirror(xw, t[1], t[2], groups, HEADS, tuple(t[3:]))
    else:
        nW = t[0].numel() // D // CN
        qkv = rng.standard_normal((1, nW, CN, 3 * D))
        want = _sdpa_windows_fused_pallas(jnp.asarray(qkv, jnp.float32), HEADS, groups,
                                          interpret=True)
        got = window_core_f32_mirror(torch.from_numpy(qkv).float().reshape(-1, 3 * D),
                                     torch.empty(nW * CN, D), packed_rows(nW, CN), groups, nW,
                                     HEADS).reshape(1, nW, CN, D)
    assert max_rel(got, want) < 1e-5
