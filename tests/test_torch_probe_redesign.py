"""The redesigned K9 ``mlp_t`` and K10 ``attn_probe`` on the CPU: what can be held here
without the card.

* K9's schedule (``ops/probes.py::mlp_t_schedule`` and ``mlp_t_item``, which
  ``csrc/mlp_t.cu`` decodes the same way) covers every (token, feature) of both products
  once, puts no token tile across two units, fills the card at every case of the tool and
  keeps each chunk's hidden under K3's scratch cap.
* K9's LayerNorm as its kernels compute it (per 128-feature tile of ``y^T`` a mean and a
  centred sum of squares down the tile's rows, merged exactly by K3's row kernel) equals
  the two-pass form.
* No wrapper's CUDA branch (K9, K10, K11) makes a transposed copy of a weight, and the old
  K9 / K10 / K11 kernels, K9's weight helper and ``csrc/window_attention.cuh`` are gone.
* K11's two work orders (``ops/probes.py::attn5d_schedule`` and ``attn5d_unit``, which
  ``csrc/attn5d_direct.cu`` decodes the same way) cover every (window, head) once, and
  ``vec`` gives each block whole strips for one head.
"""

import ast
import inspect
import pathlib

import numpy as np
import pytest
import torch

import aurora_tpu_torch
from aurora_tpu_torch.ops import _lib, mlp, probes
from tests.test_torch_redesign import _cuda_branch, _helpers

# (L, D) of the backbone's stages at the 0.25 degree grid, each R of the tool that divides L.
TOOL_CASES = [(L, D, 4 * D, R) for L, D in ((259200, 512), (64800, 1024), (16200, 2048))
              for R in (1800, 3600, 5400) if L % R == 0]
SMALL_CASES = [(256, 512, 512, 256), (512, 512, 2048, 256), (480, 512, 2048, 160),
               (3600, 1024, 4096, 1800), (1000, 512, 512, 1000), (1200, 2048, 1024, 40)]
SMS = 132  # the H100's SMs: one persistent block each


def _coverage(L, D, Hd, R, cap=mlp.MLP_SCRATCH_BYTES):
    """Times each (token, 128-feature tile) is computed by fc1 and by fc2, and each
    launch's item counts."""
    sched = probes.mlp_t_schedule(L, D, Hd, R, cap)
    T, F = probes.MLP_T_TILE
    tpu = sched["tiles_per_unit"]
    cover = {"fc1": np.zeros((Hd // F, L + 1), np.int64), "fc2": np.zeros((D // F, L + 1), np.int64)}
    for (unit0, units), items in zip(sched["chunks"], sched["items"]):
        for what, m_tiles, n in (("fc1", Hd // F, items[0]), ("fc2", D // F, items[1])):
            assert n == units * tpu * m_tiles
            for i in range(n):
                row0, rows, f0 = probes.mlp_t_item(i, unit0, R, tpu, m_tiles)
                assert 0 < rows <= T and f0 % F == 0
                assert row0 // R == (row0 + rows - 1) // R, "a token tile stays in its unit"
                assert unit0 <= row0 // R < unit0 + units
                cover[what][f0 // F, row0] += 1  # a difference array over the rows
                cover[what][f0 // F, row0 + rows] -= 1
    return sched, {k: np.cumsum(v, axis=1)[:, :L] for k, v in cover.items()}


@pytest.mark.parametrize("L,D,Hd,R", TOOL_CASES + SMALL_CASES)
def test_mlp_t_schedule_covers_every_token_and_feature_once(L, D, Hd, R):
    sched, cover = _coverage(L, D, Hd, R)
    for what, c in cover.items():
        assert c.min() == 1 and c.max() == 1, what
    T, _ = probes.MLP_T_TILE
    assert sched["padded_unit"] == T * -(-R // T)
    # The chunks are what the C entry walks: units_per_chunk each, the last the rest.
    per, n_units = sched["units_per_chunk"], L // R
    assert sched["chunks"] == [(u0, min(per, n_units - u0)) for u0 in range(0, n_units, per)]
    for _, units in sched["chunks"]:
        assert Hd * units * sched["padded_unit"] * 2 <= mlp.MLP_SCRATCH_BYTES


@pytest.mark.parametrize("L,D,Hd,R", TOOL_CASES)
def test_mlp_t_schedule_fills_the_card_at_every_tool_case(L, D, Hd, R):
    """Every launch of both products has at least one item for each SM, whatever R: the old
    kernel ran L / R blocks (3 at stage 3, R 5400)."""
    sched = probes.mlp_t_schedule(L, D, Hd, R)
    assert min(min(items) for items in sched["items"]) >= SMS
    # The chunks are as equal as whole units allow.
    sizes = [units for _, units in sched["chunks"]]
    assert max(sizes) - min(sizes) <= max(sizes) // 2 + 1


def test_mlp_t_schedule_follows_the_cap_and_refuses_bad_shapes():
    sched = probes.mlp_t_schedule(16200, 2048, 8192, 5400)
    assert sched["tiles_per_unit"] == 22 and sched["chunks"] == [(0, 2), (2, 1)]
    small = probes.mlp_t_schedule(1000, 512, 512, 100, cap=512 * 256 * 2 * 3)
    assert small["units_per_chunk"] == 3 and [u for _, u in small["chunks"]] == [3, 3, 3, 1]
    with pytest.raises(ValueError, match="divide"):
        probes.mlp_t_schedule(1000, 512, 512, 300)
    with pytest.raises(ValueError, match="scratch"):
        probes.mlp_t_schedule(1000, 512, 512, 100, cap=1000)


def _feature_major_layernorm(y, x, shift, scale, eps, tile=128):
    """K9's LayerNorm as ``csrc/mlp_t.cu`` computes it, in f32: fc2's tile of ``y^T`` (tile
    feature rows x tokens) gives each token column the mean and centred sum of squares of
    its rows; ``ln_rows_kernel<RowsResidual, 128>`` merges the ``D / tile`` pairs (equal
    counts: mean of means; centred squares plus ``tile`` times the squared offsets of the
    means), normalises, applies the FiLM row and adds the residual."""
    L, D = y.shape
    yT = y.float().T.reshape(D // tile, tile, L)
    mean_t = yT.sum(1) * (1.0 / tile)                       # (D / tile, L)
    m2_t = (yT - mean_t[:, None, :]).square().sum(1)
    mean = mean_t.sum(0) / (D // tile)
    m2 = (m2_t + tile * (mean_t - mean).square()).sum(0)
    rstd = torch.rsqrt(m2 / D + eps)
    ln = (y.float() - mean[:, None]) * rstd[:, None]
    return (x.float() + ln * scale.float() + shift.float()).to(x.dtype)


@pytest.mark.parametrize("D", [256, 512, 1024, 2048])
def test_feature_tile_statistics_merge_equals_two_pass(D):
    rng = np.random.default_rng(D + 1)
    L = 6
    y = rng.standard_normal((L, D)).astype(np.float32)
    y[1] += 100.0              # a token with a large mean
    y[2, : D // 2] += 30.0     # feature tiles of one token with different means
    y = torch.from_numpy(y)
    x = torch.from_numpy(rng.standard_normal((L, D)).astype(np.float32))
    shift = torch.from_numpy(0.1 * rng.standard_normal((1, D)).astype(np.float32))
    scale = torch.from_numpy(rng.standard_normal((1, D)).astype(np.float32))
    want = mlp.film_layernorm_residual(y[None], x[None], shift, scale, 0.0, 1e-5)[0]
    got = _feature_major_layernorm(y, x, shift, scale, 1e-5)
    branch = (want - x).abs().max().item()
    assert (got - want).abs().max().item() <= 2e-5 * branch


# ------------------------------------------------------------------------------ sources

CSRC = pathlib.Path(aurora_tpu_torch.__file__).resolve().parent / "csrc"
TRANSPOSES = {"t", "T", "mT", "mH", "H", "transpose", "permute", "swapaxes", "swapdims",
              "movedim", "_mlp_weights"}


@pytest.mark.parametrize("fn", [probes.mlp_t, probes.attn_probe, probes.attn5d_direct],
                         ids=["mlp_t", "attn_probe", "attn5d_direct"])
def test_cuda_branch_makes_no_transposed_weight_copy(fn):
    """The CUDA branch and the private helpers it calls read the weights as stored: no
    ``.t()``, ``.T`` or ``.transpose`` (or any other transposing call) reaches them."""
    branch = _cuda_branch(fn)
    trees = list(branch) + [ast.parse(inspect.getsource(h)) for h in _helpers(fn, branch)]
    assert len(trees) > len(branch), "the branch launches through a helper"
    names = set()  # what is reached as an attribute or called by name
    for tree in trees:
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute):
                names.add(node.attr)
            elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                names.add(node.func.id)
    assert not names & TRANSPOSES, names & TRANSPOSES
    assert {"kernel", "launch", "contiguous"} <= names


def test_old_probe_kernels_are_gone_and_only_k11_includes_the_old_body():
    """The first designs are gone: K11 was the old body's last user, and now no source
    includes it. K11's entry point is on the shared headers, as K9's and K10's are."""
    assert not hasattr(mlp, "_mlp_weights")
    sources = {p.name: p.read_text() for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh")}
    assert "window_attention.cuh" not in sources
    for name in ("mlp_t_kernel", "attn_probe_kernel", "attn_fulld_kernel", "attn5d_direct_kernel",
                 "window_attention.cuh"):
        assert not any(name in text for text in sources.values()), name
    assert 'extern "C" int mlp_t(' in sources["mlp_t.cu"]
    assert 'extern "C" int attn_probe(' in sources["attn_probe.cu"]
    assert 'extern "C" int attn5d_direct(' in sources["attn5d_direct.cu"]
    for src in ("attn_probe.cu", "attn5d_direct.cu"):
        assert '#include "gemm_rows_sm90.cuh"' in sources[src]
        assert '#include "sdpa_sm90.cuh"' in sources[src]
    for entry in ('int mlp_t(', 'int attn_probe(', 'int attn5d_direct('):
        assert entry not in sources["probes.cu"]
    assert "attn5d_direct" in _lib.SOURCES


# ------------------------------------------------------------------------------ K11

# (B, Cp, Hp, Wp, heads): the tool's padded grids at stages 1-3, then small and ragged ones
# (units no multiple of the slots; a run that ends inside the last block; B = 2).
ATTN5D_GRIDS = [(1, 4, 180, 360, 8), (1, 4, 90, 180, 16), (1, 4, 48, 96, 32),
                (1, 2, 12, 24, 2), (2, 4, 18, 36, 4), (1, 2, 30, 60, 8), (3, 2, 6, 132, 3)]
WS = (2, 6, 12)


@pytest.mark.parametrize("mode", probes.ATTN5D_MODES)
@pytest.mark.parametrize("B,Cp,Hp,Wp,heads", ATTN5D_GRIDS)
def test_attn5d_schedule_covers_every_window_and_head_once(B, Cp, Hp, Wp, heads, mode):
    sched = probes.attn5d_schedule(B, Cp, Hp, Wp, WS, heads, mode)
    units, run, W1 = sched["units"], sched["run"], sched["W1"]
    nW = (Cp // WS[0]) * (Hp // WS[1]) * W1
    assert sched["nW"] == nW and units == B * nW * heads
    assert run % sched["group"] == 0 and (sched["blocks"] - 1) * run < units <= sched["blocks"] * run
    seen = np.zeros((B * nW, heads), np.int64)
    for blk in range(sched["blocks"]):
        mine = [probes.attn5d_unit(u, mode, heads, W1)
                for u in range(blk * run, min((blk + 1) * run, units))]
        assert mine, "no block without a unit"
        for window, head in mine:
            seen[window, head] += 1
        if mode == "vec":  # whole strips, one head at a time: (strip, head) items of W1 units
            items = [mine[i:i + W1] for i in range(0, len(mine), W1)]
            for item in items:
                strips = {w // W1 for w, _ in item}
                assert len(item) == W1 and len(strips) == 1 and len({h for _, h in item}) == 1
                assert sorted(w % W1 for w, _ in item) == list(range(W1))
        else:  # one window at a time, its heads in turn
            assert [u % heads for u in range(blk * run, blk * run + len(mine))] == [h for _, h in mine]
    assert seen.min() == 1 and seen.max() == 1


@pytest.mark.parametrize("B,Cp,Hp,Wp,heads", ATTN5D_GRIDS[:3])
def test_attn5d_schedule_fills_the_card_at_the_tool_stages(B, Cp, Hp, Wp, heads):
    """Both orders keep at least 240 of the 264 slots (two blocks an SM) busy in one wave:
    a block per strip would have run 60 / 30 / 16 blocks."""
    for mode in probes.ATTN5D_MODES:
        sched = probes.attn5d_schedule(B, Cp, Hp, Wp, WS, heads, mode)
        assert 240 <= sched["blocks"] <= 264, (mode, sched)


def test_attn5d_schedule_refuses_bad_arguments():
    with pytest.raises(ValueError, match="mode"):
        probes.attn5d_schedule(1, 2, 12, 24, WS, 2, "scan")
    with pytest.raises(ValueError, match="multiple"):
        probes.attn5d_schedule(1, 2, 12, 20, WS, 2, "vec")
