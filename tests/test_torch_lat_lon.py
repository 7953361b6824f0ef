"""The port's ``(lat, lon)`` split of the grid (``aurora_tpu_torch/parallel/halo.py``,
``model/spmd.py``, the backbone's mesh path) against ``aurora_tpu`` on the CPU, in float64.

* One run of ``multihost_sim --lat 2 --lon 2`` (four gloo processes over a ``FileStore``,
  ``AuroraSmallPretrained(use_lora=True)`` at widths 64 and two blocks a stage) on two pixel
  grids: 40 x 96 (tokens 10 x 24, split into whole patches) and 44 x 96 (11 x 24 tokens; the
  mesh does not split 44 rows into whole patches of 4 over 2, so the encoder and decoder run
  whole), with the same model at ``enc_depth = dec_depth = 2`` (``--deep-params``) adding a
  forward on the first grid, equal to its one-process forward. Its gathered forward, 2-step ``rollout`` and host-offload ``rollout_scan`` equal the
  one-process port's and ``aurora_tpu``'s forward and ``rollout`` under
  ``make_mesh(data=1, lat=2, lon=2)`` on the virtual CPU devices (mean-rel 1e-8 per
  variable), and the blocks saw every case: a grid over-padded (``extra``), a patch merge of
  an odd block, uneven splits, halos across both lines, a pixel grid run whole.
* In process: ``window_group_ids(..., extra=...)`` and ``pad_3d`` / ``crop_3d`` with
  ``extra`` equal the JAX package's; the split rule; the halo strips of the main path's
  720 x 1440 grid over ``lat = lon = 2``; the bytes each rank sent per block, counted by the
  collective's wrapper, equal the strips an independent count finds (no block gathers the
  grid).

The tool runs once for the module, beside the JAX package's two compiles.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu import AuroraSmallPretrained as JaxSmall
from aurora_tpu import Batch as JBatch
from aurora_tpu import Metadata as JMetadata
from aurora_tpu import rollout as j_rollout
from aurora_tpu.model.swin3d import crop_3d as j_crop_3d
from aurora_tpu.model.swin3d import pad_3d as j_pad_3d
from aurora_tpu.ops.masks import window_group_ids as j_window_group_ids
from aurora_tpu.parallel import mesh as jmesh
from aurora_tpu_torch import AuroraSmallPretrained as PortSmall
from aurora_tpu_torch.checkpoint import save_params
from aurora_tpu_torch.model.config import LARGE_CONFIG
from aurora_tpu_torch.model.swin3d import crop_3d, get_encoder_specs, maybe_adjust_windows, pad_3d
from aurora_tpu_torch.ops.masks import three_sided_padding, window_group_ids
from aurora_tpu_torch.parallel import halo, split_bounds
from aurora_tpu_torch.tools import multihost_sim
from tests.test_torch_support import mean_rel, seeded_matched_variant

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(use_lora=True, embed_dim=64, encoder_depths=(2, 2, 2), decoder_depths=(2, 2, 2))
GRIDS = {"aligned": (40, 96), "misaligned": (44, 96)}
MESH = dict(data=1, lat=2, lon=2)
TOL = 1e-8  # mean relative error per variable, float64


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------------------ in process


@pytest.mark.parametrize("geom", [
    ((4, 90, 180), (2, 6, 12), (1, 3, 6), (0, 6, 12)),
    ((4, 90, 180), (2, 6, 12), (0, 0, 0), (0, 6, 12)),
    ((4, 45, 90), (2, 6, 12), (1, 3, 6), (0, 0, 24)),
    ((4, 5, 12), (2, 5, 12), (0, 0, 0), (0, 5, 12)),
    ((4, 11, 24), (2, 6, 12), (1, 3, 6), (2, 6, 0)),
])
def test_window_group_ids_with_extra_match_jax(geom):
    (C, H, W), ws, ss, extra = geom
    got = window_group_ids(C, H, W, ws, ss, True, extra)
    want = j_window_group_ids(C, H, W, ws, ss, True, extra)
    assert got.shape == want.shape and np.array_equal(got, want)
    # Whole pad-only windows change no real token's window: the windows without ``extra``
    # lead the grid of windows, with the same ids; the extra ones hold the pad's id alone.
    base = window_group_ids(C, H, W, ws, ss, True)
    n1 = [(n + (-n) % w) // w for n, w in zip((C, H, W), ws)]
    grid = got.reshape(*[(n + (-n) % w + e) // w for n, w, e in zip((C, H, W), ws, extra)], -1)
    assert np.array_equal(grid[:n1[0], :n1[1], :n1[2]].reshape(base.shape), base)
    pad_id = base.max() if (C % ws[0] or H % ws[1] or W % ws[2]) else None
    rest = np.concatenate([grid[n1[0]:].ravel(), grid[:, n1[1]:].ravel(),
                           grid[:, :, n1[2]:].ravel()])
    assert len(np.unique(rest)) <= 1 and (pad_id is None or len(rest) == 0
                                          or rest[0] == pad_id)


@pytest.mark.parametrize("pad,extra", [((0, 3, 6), (0, 6, 12)), ((1, 0, 5), (2, 0, 0)),
                                       ((0, 0, 0), (0, 6, 24))])
def test_pad_and_crop_with_extra_match_jax(pad, extra):
    x = np.random.default_rng(0).standard_normal((1, 3, 7, 9, 4))
    got = pad_3d(torch.from_numpy(x), pad, extra)
    want = np.asarray(j_pad_3d(jnp.asarray(x), pad, extra))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(crop_3d(got, pad, extra).numpy(), x)
    assert np.array_equal(np.asarray(j_crop_3d(jnp.asarray(want), pad, extra)), x)


@pytest.mark.parametrize("n,k", [(45, 2), (90, 2), (5, 4), (11, 2), (360, 4), (1, 3)])
def test_the_split_rule(n, k):
    """Blocks of ceil(n / k) in rank order, contiguous over [0, n), the last ones shorter."""
    b = split_bounds(n, k)
    assert len(b) == k and b[0][0] == 0 and b[-1][1] == n
    assert all(b[i][1] == b[i + 1][0] for i in range(k - 1))
    sizes = [e - s for s, e in b]
    assert sizes == sorted(sizes, reverse=True) and sizes[0] == -(-n // k)
    assert split_bounds(45, 2) == [(0, 23), (23, 45)]


class _Mesh:
    shape = MESH

    @staticmethod
    def axis_index(axis):
        return 0


def test_main_path_halo_strips():
    """The 720 x 1440 grid over lat = lon = 2: a shifted block of the first stage moves 3 rows
    and 6 columns of a 90 x 180 block (4 x 3 x 180 x 512 and 4 x 90 x 6 x 512 bf16, ~2.2 MB
    against a 66 MB block), an unshifted one nothing; the second stage's 90 x 180 grid
    over-pads by (0, 6, 12) and holds 45 rows a rank, odd at the merge into the third; the
    third stage's 45 rows split 23 / 22."""
    cfg = LARGE_CONFIG.backbone
    res_all, _ = get_encoder_specs(cfg, (4, 180, 360))
    assert res_all == [(4, 180, 360), (4, 90, 180), (4, 45, 90)]
    seen = {}
    for res in res_all:
        for shift in ((0, 0, 0), (1, 3, 6)):
            ws, ss = maybe_adjust_windows(cfg.window_size, shift, res)
            geo = halo.window_geometry(res, ws, ss, _Mesh)
            plans = halo.enter_plans(geo, MESH)
            seen[res, shift] = geo, {a: max(sum(len(p) for p in row) for row in sends)
                                     for a, (_, sends) in plans.items()}
    geo, rows = seen[(4, 180, 360), (1, 3, 6)]
    assert rows == {"lat": 3, "lon": 6} and geo.extra == (0, 0, 0) and geo.block == (90, 180)
    lat_bytes, lon_bytes = 4 * 3 * 180 * 512 * 2, 4 * 90 * 6 * 512 * 2
    assert lat_bytes == 2211840 and lon_bytes == 2211840
    assert lat_bytes * 30 == lon_bytes * 30 == 4 * 90 * 180 * 512 * 2  # 1/30 of the block
    assert seen[(4, 180, 360), (0, 0, 0)][1] == {"lat": 0, "lon": 0}
    geo, _ = seen[(4, 90, 180), (0, 0, 0)]
    assert geo.extra == (0, 6, 12) and geo.padded == (4, 96, 192)
    assert [e - s for s, e in split_bounds(90, 2)] == [45, 45]
    assert [e - s for s, e in split_bounds(45, 2)] == [23, 22]
    geo, rows = seen[(4, 45, 90), (0, 0, 0)]
    assert geo.block == (24, 48) and rows == {"lat": 0, "lon": 0}


# ------------------------------------------------------------------------------ the mesh


def _jax_batch(grid):
    """The tool's float64 batch on ``grid`` as the JAX package's Batch."""
    b = multihost_sim.make_inputs("cpu", 0, grid, batch=1).astype(torch.float64)
    md = b.metadata
    arr = lambda d: {k: v.numpy() for k, v in d.items()}  # noqa: E731
    return JBatch(surf_vars=arr(b.surf_vars), static_vars=arr(b.static_vars),
                  atmos_vars=arr(b.atmos_vars),
                  metadata=JMetadata(lat=np.asarray(md.lat), lon=np.asarray(md.lon),
                                     time=md.time, atmos_levels=md.atmos_levels,
                                     rollout_step=0))


def _jax_under_mesh(jm, params, grid):
    """``aurora_tpu``'s forward and 2-step ``rollout`` under ``make_mesh(1, 2, 2)``."""
    batch = _jax_batch(grid)

    def host(b):
        return {k: np.asarray(v) for k, v in {**b.surf_vars, **b.atmos_vars}.items()}

    with jax.set_mesh(jmesh.make_mesh(**MESH)):
        fwd = host(jm.forward(params, batch))
        steps = [host(p) for p in j_rollout(jm, params, batch, steps=2)]
    return dict(forward=fwd, rollout=steps)


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """The tool's results (four ranks and the one-process run) on both grids, and the JAX
    package's under the same mesh, from one float64 tree."""
    folder = tmp_path_factory.mktemp("lat_lon")
    jm, params, tm = seeded_matched_variant(JaxSmall, PortSmall, dtype=jnp.float64, **ARCH)
    save_params(tm, folder / "params.pt")
    del tm
    deep = multihost_sim.build("cpu", None, 2, seed=1, width=64, dtype=torch.float64,
                               resampler_depth=2)
    save_params(deep, folder / "deep.pt")
    del deep
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "aurora_tpu_torch.tools.multihost_sim", "--device", "cpu",
         "--lat", "2", "--lon", "2", "--depths", "2", "--width", "64", "--dtype", "float64",
         "--grids", ",".join(f"{h}x{w}" for h, w in GRIDS.values()), "--params",
         str(folder / "params.pt"), "--deep-params", str(folder / "deep.pt"), "--save",
         str(folder / "out.pt")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        jax_out = {name: _jax_under_mesh(jm, params, grid) for name, grid in GRIDS.items()}
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out.decode(errors="replace")[-3000:]
    res = torch.load(folder / "out.pt", weights_only=False)
    return dict(res, jax=jax_out)


def _key(name):
    h, w = GRIDS[name]
    return f"{h - h % 4}x{w}"


@pytest.mark.parametrize("name", GRIDS)
def test_forward_and_rollouts_match_the_one_process_port(sim, name):
    ref, got = sim["reference"]["grids"][_key(name)], sim["rank0"]["grids"][_key(name)]
    parts = [("forward", ref["forward"], got["forward"])]
    parts += [(f"rollout {i}", r, g) for i, (r, g) in enumerate(zip(ref["rollout"],
                                                                   got["rollout"]))]
    parts += [(f"scan {i}", r, g) for i, (r, g) in enumerate(zip(ref["scan"], got["scan"]))]
    assert len(parts) == 5
    for what, r, g in parts:
        assert sorted(r) == sorted(g)
        for k in r:
            assert g[k].shape == r[k].shape and g[k].shape[-2:] == (GRIDS[name][0] // 4 * 4,
                                                                    GRIDS[name][1])
            assert mean_rel(g[k], r[k]) <= TOL, (what, k, mean_rel(g[k], r[k]))
    assert sim["result"]["grids"][_key(name)]["ok"] and sim["result"]["ok"]


@pytest.mark.parametrize("name", GRIDS)
def test_forward_and_rollout_match_jax_under_the_mesh(sim, name):
    want, got = sim["jax"][name], sim["rank0"]["grids"][_key(name)]
    pairs = [(want["forward"], got["forward"])] + list(zip(want["rollout"], got["rollout"]))
    assert len(pairs) == 3
    for w, g in pairs:
        assert sorted(w) == sorted(g)
        for k in w:
            assert g[k].shape == w[k].shape, k
            assert mean_rel(g[k], w[k]) <= TOL, (k, mean_rel(g[k], w[k]))


def test_depth2_resamplers_forward_matches_the_one_process_port(sim):
    """The columns are independent: the encoder's and decoder's deeper resampler layers run
    on each rank's block with no halo of their own."""
    ref, got = sim["reference"]["deep"], sim["rank0"]["deep"]
    assert ref["depth"] == got["depth"] == 2 and ref["grid"] == got["grid"] == [40, 96]
    assert sorted(ref["forward"]) == sorted(got["forward"])
    for k, w in ref["forward"].items():
        assert got["forward"][k].shape == w.shape, k
        assert mean_rel(got["forward"][k], w) <= TOL, (k, mean_rel(got["forward"][k], w))
    assert sim["result"]["deep"]["ok"]


def test_the_blocks_saw_every_case(sim):
    """Over-padding, a patch merge of an odd block, uneven splits, halos across the lat and
    the lon lines, and a pixel grid the mesh does not split into whole patches."""
    aligned = sim["result"]["grids"][_key("aligned")]["geometry"]
    whole = sim["result"]["grids"][_key("misaligned")]["geometry"]
    for g in (aligned, whole):
        assert g["overpadded"] and g["odd_merges"] and g["uneven"]
        assert g["shifted_lat"] and g["shifted_lon"]
    assert aligned["encoder_local"] and not aligned["encoder_whole"]
    assert whole["encoder_whole"] and not whole["encoder_local"]
    assert ((4, 5, 12), (0, 5, 12)) in aligned["overpadded"]
    assert "refuses_training" not in sim["rank0"] and sim["result"]["processes"] == 4


def _moved(cur, blocks):
    """The most rows one rank of a line sends: for each sender, the distinct rows it holds
    that other ranks' new blocks name (``blocks[r]``: rank r's rows, -1 a pad row)."""
    out = 0
    for s, (a, b) in enumerate(cur):
        n = sum(len({v for v in blocks[r] if a <= v < b}) for r in range(len(cur)) if r != s)
        out = max(out, n)
    return out


def _expected_bytes(rec, at, D, item=8, B=1):
    """The bytes a rank sends in one block, counted independently: the grid's index rolled
    by ``np.roll`` and padded by ``np.pad``, cut into the ranks' blocks."""
    (C, H, W), ss = rec["res"], tuple(rec["shift"])
    ws, _ = maybe_adjust_windows((2, 6, 12), (0, 0, 0), (C, H, W))
    k = 2
    pad = ((-C) % ws[0], (-H) % ws[1], (-W) % ws[2])
    Cp = C + pad[0]
    left, _, top, _, _, _ = three_sided_padding(*pad)
    total = 0
    canon = {n: split_bounds(n, k) for n in (H, W)}
    m = rec["padded_block"]
    lines = []
    for n, s, lo, mm in ((H, ss[1], top, m[0]), (W, ss[2], left, m[1])):
        idx = np.pad(np.roll(np.arange(n), -s), (lo, mm * k - n - lo), constant_values=-1)
        enter = _moved(canon[n], [idx[r * mm:(r + 1) * mm] for r in range(k)])
        back = np.roll(np.arange(n), s) + lo
        leave = _moved([(r * mm, (r + 1) * mm) for r in range(k)],
                       [back[a:b] for a, b in canon[n]])
        lines.append((enter, leave))
    (eh, lh), (ew, lw) = lines
    i, j = at
    w_canon = canon[W][j][1] - canon[W][j][0]
    h_canon = canon[H][i][1] - canon[H][i][0]
    row = B * Cp * D * item
    total += eh * w_canon * row + ew * m[0] * row  # enter: rows, then columns
    total += lh * m[1] * row + lw * h_canon * row  # leave: rows, then columns
    return total


def test_halo_bytes_per_block_are_the_strips(sim):
    """Each block's bytes sent by each rank, counted by the collective's wrapper, equal the
    strips an independent count finds; no collective sends a whole block of the grid."""
    widths = {(4, 10, 24): 64, (4, 11, 24): 64, (4, 5, 12): 128, (4, 6, 12): 128,
              (4, 3, 6): 256}
    checked = 0
    for name in GRIDS:
        g = sim["result"]["grids"][_key(name)]["geometry"]
        coords = [(i, j) for i in range(2) for j in range(2)]  # rank r = 2 i + j
        reports = sim["result"]["grids"][_key(name)]
        seen = [s for s in sim["rank0"]["grids"][_key(name)]["halo"]["seen"]
                if s["kind"] == "block"]
        for r, blocks in enumerate(g["block_bytes"]):
            for res, shift, nbytes in blocks:
                # The geometry (padded block) is every rank's; the bytes are this rank's.
                rec = next(s for s in seen if tuple(s["res"]) == tuple(res)
                           and tuple(s["shift"]) == tuple(shift))
                want = _expected_bytes(rec, coords[r], widths[tuple(res)])
                assert nbytes == want, (name, r, res, shift, nbytes, want)
                checked += 1
        whole_grid = 4 * 10 * 24 * 64 * 8
        assert 0 < g["largest_sent"] < whole_grid, g["largest_sent"]
        assert reports["ok"]
    assert checked >= 24

