"""The redesigned K12 ``gemm_blocked``, K7 ``sdpa_windows`` and K3 / K8 (``mlp_adaln_residual``,
``mlp_fused``) on the CPU: what can be held here without the card.

* The library calls that ``chip_smoke.py`` times beside the two kernels compute the kernels'
  functions: ``F.scaled_dot_product_attention`` with the 0 / -100 mask equals
  ``sdpa_windows_plain``, ``torch.matmul`` equals ``gemm_blocked_plain`` (f32: 1e-5 of the
  largest value, accumulation order; bf16: one rounding of the same f32 sums, exact).
* The host side of K12's schedule covers every output element exactly once, for the probe
  tool's shapes and for small ragged ones, and the row block changes no bit of the result.
* The shape rules of the two wrappers, as pure functions.
* The port names no fused attention operator, and the CUDA branches of the ten wrappers
  (K12, K7, K3, K8, K2, K6, K4, K5, K9, K10), with the private helpers they call, reach no
  library product and make no transposed copy of a weight.
* K3's LayerNorm as its kernels compute it (per 256-column tile a mean and a centred sum of
  squares, merged exactly) equals the two-pass form of ``film_layernorm_residual``; the
  row-chunk rule that bounds K3's and K8's scratch covers every row once.
"""

import ast
import inspect
import pathlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import aurora_tpu_torch
from aurora_tpu_torch.ops import mlp, probes, resampler, window_attention
from aurora_tpu_torch.ops.masks import bias_from_groups, window_group_ids
from aurora_tpu_torch.tools.gemm_probe import FC2, PROJ

TOOL_CASES = [(M, K, N, MB) for M, K, N, blocks in (PROJ, FC2) for MB in blocks if M % MB == 0]
SMALL_CASES = [(192, 64, 256, 192), (192, 64, 256, 96), (192, 64, 256, 32), (1000, 128, 512, 40),
               (1000, 128, 512, 200), (3240, 64, 256, 1080), (90, 64, 256, 30), (7, 64, 256, 7)]


# ------------------------------------------------------------------------------ yardsticks


@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_library_call_is_the_function_of_k7(masked):
    ws, ss = (1, 2, 4), (0, 1, 2)
    groups = window_group_ids(1, 3, 6, ws, ss)  # pads H 3 -> 4: pad tokens take part
    nW, N = groups.shape
    heads, dh = 2, 8
    qkv = torch.from_numpy(np.random.default_rng(0).standard_normal((1, nW, N, 3 * heads * dh))).float()
    want = window_attention.sdpa_windows_plain(qkv, groups if masked else None, heads)
    q, k, v = qkv.view(nW, N, 3, heads, dh).permute(2, 0, 3, 1, 4).unbind(0)
    mask = bias_from_groups(torch.from_numpy(groups.copy()), torch.float32)[:, None] if masked else None
    got = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)  # (nW, heads, N, dh)
    got = got.permute(0, 2, 1, 3).reshape(1, nW, N, heads * dh)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_is_the_function_of_k12(dtype):
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((96, 64))).float().to(dtype)
    w = torch.from_numpy(0.1 * rng.standard_normal((64, 256))).float().to(dtype)
    got, want = torch.matmul(a, w), probes.gemm_blocked_plain(a, w)
    assert got.dtype == want.dtype
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    else:
        # Both round one f32 sum per element; sums in another order may round one ulp apart.
        assert (got.float() - want.float()).abs().max().item() <= 2**-7 * want.float().abs().max().item()


# ------------------------------------------------------------------------------ K12 schedule


def _cover(M, K, N, MB):
    """Times each (row, column tile) is written under the schedule, and the units."""
    ppb, n_tiles, units = probes.gemm_blocked_schedule(M, K, N, MB)
    rows, bn, _ = probes.GEMM_TILE
    count = np.zeros((M, n_tiles), np.int32)
    for u in range(units):
        rects = probes.gemm_blocked_unit(u, M, MB, ppb, n_tiles)
        assert 1 <= len(rects) <= 2
        for r0, nr, c0, nc in rects:
            assert nc == bn and c0 % bn == 0 and 0 < nr <= rows
            assert r0 // MB == (r0 + nr - 1) // MB, "a piece stays inside its row block"
            assert (r0 % MB) % rows == 0
            count[r0:r0 + nr, c0 // bn] += 1
    return count, units


@pytest.mark.parametrize("M,K,N,MB", TOOL_CASES + SMALL_CASES)
def test_gemm_schedule_covers_every_element_once(M, K, N, MB):
    count, units = _cover(M, K, N, MB)
    assert count.min() == 1 and count.max() == 1
    pieces = (M // MB) * -(-MB // 64)
    assert units == -(-pieces // 2) * (N // 256)


def test_gemm_schedule_keeps_column_tiles_of_a_tile_together():
    """Column tiles run fastest: units 2t and 2t + 1 are the two column tiles of tile t, so
    blocks that run side by side read the same rows of ``a``."""
    M, K, N, MB = 2160 * 4, 512, 512, 2160
    ppb, n_tiles, units = probes.gemm_blocked_schedule(M, K, N, MB)
    assert n_tiles == 2
    for u in range(0, units, n_tiles):
        first, other = (probes.gemm_blocked_unit(u + n, M, MB, ppb, n_tiles) for n in range(2))
        assert [r[:2] for r in other] == [r[:2] for r in first]
        assert {r[2] for r in first} == {0} and {r[2] for r in other} == {256}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_blocked_same_bits_for_every_row_block(dtype):
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((240, 64))).float().to(dtype)
    w = torch.from_numpy(0.1 * rng.standard_normal((64, 256))).float().to(dtype)
    outs = [probes.gemm_blocked(a, w, MB) for MB in (240, 120, 80, 48, 30, 1)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert torch.equal(outs[0], probes.gemm_blocked_plain(a, w))
    for MB in (0, -8, 7, 241, 100):
        with pytest.raises(ValueError, match="MB"):
            probes.gemm_blocked(a, w, MB)


# ------------------------------------------------------------------------------ shape rules


@pytest.mark.parametrize("M,K,N,MB,word", [
    (96, 32, 256, 32, "K % 64"), (96, 96, 256, 32, "K % 64"), (96, 64, 128, 32, "N % 256"),
    (96, 64, 384, 32, "N % 256"), (96, 64, 256, 40, "MB=40"), (96, 64, 256, 0, "MB=0"),
    (0, 64, 256, 32, "M=0"),
])
def test_gemm_schedule_refuses_other_shapes(M, K, N, MB, word):
    with pytest.raises(ValueError) as e:
        probes.gemm_blocked_schedule(M, K, N, MB)
    msg = str(e.value)
    assert word.split(" ")[0].rstrip("=0123456789") in msg and str(K) in msg and str(N) in msg


@pytest.mark.parametrize("M,K,N,MB", TOOL_CASES)
def test_gemm_schedule_takes_the_tools_shapes(M, K, N, MB):
    ppb, n_tiles, units = probes.gemm_blocked_schedule(M, K, N, MB)
    assert (ppb, n_tiles) == (-(-MB // 64), N // 256) and units > 0
    assert MB % 64, "every row block of the tool ends in a ragged piece"


@pytest.mark.parametrize("shape,heads", [
    ((1, 4, 144, 3 * 512), 8), ((2, 1800, 144, 3 * 512), 8), ((1, 128, 144, 3 * 2048), 32),
])
def test_sdpa_shape_rule_takes_the_backbones_shapes(shape, heads):
    assert window_attention.check_sdpa_windows_shape(shape, heads) == (shape[0], shape[1], shape[3] // 3)


@pytest.mark.parametrize("shape,heads", [
    ((1, 4, 128, 3 * 512), 8),      # windows of 128 tokens
    ((1, 4, 144, 3 * 512), 16),     # head dim 32
    ((1, 4, 144, 3 * 64), 1),       # D = 64: not a multiple of 128
    ((1, 4, 144, 3 * 512 + 1), 8),  # not 3D features
    ((4, 144, 3 * 512), 8),         # no batch dimension
    ((4096, 4096, 144, 3 * 512), 8),  # more rows than 32 bits count
])
def test_sdpa_shape_rule_refuses_other_shapes(shape, heads):
    with pytest.raises(ValueError) as e:
        window_attention.check_sdpa_windows_shape(shape, heads)
    assert str(shape[-1]) in str(e.value) or str(shape[-1] // 3) in str(e.value)


# ------------------------------------------------------------------------------ sources

PORT = pathlib.Path(aurora_tpu_torch.__file__).resolve().parent


def test_port_names_no_fused_attention_operator():
    hits = [str(p.relative_to(PORT)) for p in sorted(PORT.rglob("*.py"))
            if "scaled_dot_product_attention" in p.read_text()]
    assert hits == []


def _cuda_branch(fn):
    """The statements of ``fn`` after its ``if <tensor>.device.type == "cpu": return ...``."""
    body = ast.parse(inspect.getsource(fn)).body[0].body
    for i, node in enumerate(body):
        if isinstance(node, ast.If) and 'device.type == "cpu"' in ast.unparse(node.test).replace("'", '"'):
            assert isinstance(node.body[-1], ast.Return) and not node.orelse
            return body[i + 1:]
    raise AssertionError(f"{fn.__name__}: no CPU branch found")


def _helpers(fn, branch):
    """The module's private functions that ``branch`` calls, and those they call in turn
    (K2 / K6 launch through two)."""
    module = inspect.getmodule(fn)
    found, todo = {}, list(branch)
    while todo:
        for n in ast.walk(todo.pop()):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name):
                f = getattr(module, n.func.id, None)
                if n.func.id.startswith("_") and inspect.isfunction(f) and n.func.id not in found:
                    found[n.func.id] = f
                    todo.append(ast.parse(inspect.getsource(f)))
    return list(found.values())


@pytest.mark.parametrize(
    "fn",
    [probes.gemm_blocked, window_attention.sdpa_windows, mlp.mlp_adaln_residual, mlp.mlp_fused,
     window_attention.window_attention_tail, window_attention.window_attention_windowed,
     resampler.perceiver_core, mlp.linear_adaln_residual, probes.mlp_t, probes.attn_probe,
     probes.attn5d_direct],
    ids=["gemm_blocked", "sdpa_windows", "mlp_adaln_residual", "mlp_fused",
         "window_attention_tail", "window_attention_windowed", "perceiver_core",
         "linear_adaln_residual", "mlp_t", "attn_probe", "attn5d_direct"])
def test_cuda_branch_reaches_no_library_product(fn):
    branch = _cuda_branch(fn)
    assert branch, "the CUDA branch launches the kernel"
    names = set()
    for stmt in branch:
        for node in ast.walk(stmt):
            assert not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult))
            if isinstance(node, ast.Attribute):
                names.add(node.attr)
            elif isinstance(node, ast.Name):
                names.add(node.id)
    # In the private helpers the branch calls: what they call or reach as an attribute.
    for helper in _helpers(fn, branch):
        for node in ast.walk(ast.parse(inspect.getsource(helper))):
            assert not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult))
            if isinstance(node, ast.Attribute):
                names.add(node.attr)
            elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                names.add(node.func.id)
    banned = {"matmul", "mm", "bmm", "einsum", "addmm", "linear", "softmax", "t", "T", "mT",
              "transpose", "permute", "gemm_blocked_plain", "sdpa_windows_plain",
              "mlp_adaln_residual_plain", "mlp_fused_plain", "_mlp_weights",
              "window_attention_tail_plain", "window_attention_windowed_plain", "F",
              "functional", "perceiver_core_plain", "perceiver_core_mirror",
              "fold_logit_weights", "linear_adaln_residual_plain", "mlp_t_plain",
              "attn_probe_plain", "attn5d_direct_plain"}
    assert not names & banned, names & banned
    assert "kernel" in names and "LAUNCHES" in names


# ------------------------------------------------------------------------------ K3 / K8

# rows, D, hidden of the calls the 1.3 B model makes: three backbone stages, the perceiver's
# aggregation and de-aggregation MLP halves.
MLP_CARD_SHAPES = [(259200, 512, 2048), (64800, 1024, 4096), (16200, 2048, 8192),
                   (194400, 512, 2048), (842400, 1024, 2048)]


def _tiled_film_layernorm_residual(y, residual, shift, scale, scale_bias, eps, tile=256):
    """K3's LayerNorm as ``csrc/mlp.cu`` computes it, in f32: fc2's epilogue gives each
    256-column tile of a row its mean and centred sum of squares; the row kernel merges the
    D / 256 pairs (equal counts: mean of means; centred squares plus 256 times the squared
    offsets of the means), normalises, applies FiLM and adds the residual."""
    B, L, D = y.shape
    yt = y.float().reshape(B, L, D // tile, tile)
    mean_t = yt.sum(-1) * (1.0 / tile)
    m2_t = (yt - mean_t[..., None]).square().sum(-1)
    mean = mean_t.sum(-1) / (D // tile)
    m2 = (m2_t + tile * (mean_t - mean[..., None]).square()).sum(-1)
    rstd = torch.rsqrt(m2 / D + eps)
    ln = (y.float() - mean[..., None]) * rstd[..., None]
    mod = ln * (scale_bias + scale.float()[:, None, :]) + shift.float()[:, None, :]
    return (residual.float() + mod).to(residual.dtype), mean, m2 / D


@pytest.mark.parametrize("D", [256, 512, 1024, 2048])
def test_tiled_layernorm_equals_two_pass(D):
    rng = np.random.default_rng(D)
    B, L = 2, 5
    y = rng.standard_normal((B, L, D)).astype(np.float32)
    y[0, 1] += 100.0   # a row with a large mean: E[y^2] - mean^2 loses its variance
    y[1, 2, : D // 2] += 30.0  # tiles of one row with different means
    y = torch.from_numpy(y)
    x = torch.from_numpy(rng.standard_normal((B, L, D)).astype(np.float32))
    shift = torch.from_numpy(0.1 * rng.standard_normal((B, D)).astype(np.float32))
    scale = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    want = mlp.film_layernorm_residual(y, x, shift, scale, 0.5, 1e-5)
    got, mean, var = _tiled_film_layernorm_residual(y, x, shift, scale, 0.5, 1e-5)
    branch = (want - x).abs().max().item()
    # f32 rounding: the two means of the row near 100 may differ by an ulp of 100 (7.6e-6).
    assert (got - want).abs().max().item() <= 2e-5 * branch
    # The variance of a row near 1000: the merged centred squares hold it, the one-pass form
    # E[y^2] - mean^2 that the kernels avoid does not.
    far = y[:1, :1] + 1000.0
    _, _, var = _tiled_film_layernorm_residual(far, far, shift[:1], scale[:1], 0.0, 1e-5)
    exact = far.double().var(-1, unbiased=False).item()
    assert abs(var.item() - exact) <= 1e-4 * exact
    naive = (far.square().mean(-1) - far.mean(-1).square()).item()
    assert abs(naive - exact) > 1e-2 * exact


@pytest.mark.parametrize("M,D,Hd", MLP_CARD_SHAPES + [(100, 512, 512), (65536, 512, 2048),
                                                     (65537, 512, 2048), (1, 2048, 8192)])
def test_mlp_row_chunks_cover_every_row_once(M, D, Hd):
    chunks = mlp.mlp_row_chunks(M, Hd)
    seen = np.zeros(M, np.int32)
    for r0, rows in chunks:
        assert rows > 0 and rows * Hd * 2 <= mlp.MLP_SCRATCH_BYTES
        seen[r0:r0 + rows] += 1
    assert seen.min() == 1 and seen.max() == 1
    assert [r0 for r0, _ in chunks] == sorted(r0 for r0, _ in chunks)
    assert all(rows == chunks[0][1] and rows % 128 == 0 for _, rows in chunks[:-1])
    assert chunks[0][1] == max(rows for _, rows in chunks)  # the scratch is sized by the first


def test_mlp_row_chunks_follow_the_cap():
    assert mlp.MLP_SCRATCH_BYTES == 256 << 20
    want = [(r, min(128, 1000 - r)) for r in range(0, 1000, 128)]
    assert mlp.mlp_row_chunks(1000, 512, cap=128 * 512 * 2) == want
    assert mlp.mlp_row_chunks(16200, 8192) == [(0, 16200)]
    assert len(mlp.mlp_row_chunks(842400, 2048)) == 13
    with pytest.raises(ValueError, match="scratch"):
        mlp.mlp_row_chunks(1000, 512, cap=1000)


@pytest.mark.parametrize("M,D,Hd", MLP_CARD_SHAPES)
def test_mlp_shape_rule_takes_the_card_shapes(M, D, Hd):
    mlp.check_mlp_shape(M, D, Hd)


@pytest.mark.parametrize("M,D,Hd,word", [
    (1000, 256, 1024, "D=256"), (1000, 768, 3072, "D=768"), (1000, 4096, 16384, "D=4096"),
    (1000, 512, 2000, "hidden=2000"), (1000, 512, 256, "hidden=256"),
    (1000, 1024, 4160, "hidden=4160"),
    (0, 512, 2048, "M=0"), (2**31, 512, 2048, f"M={2**31}"),
])
def test_mlp_shape_rule_refuses_other_shapes(M, D, Hd, word):
    with pytest.raises(ValueError) as e:
        mlp.check_mlp_shape(M, D, Hd)
    msg = str(e.value)
    assert word in msg and f"D={D}" in msg and f"hidden={Hd}" in msg
