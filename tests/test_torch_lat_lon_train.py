"""The port's train steps under a ``(lat, lon)`` split of the grid (``aurora_tpu_torch``'s
``parallel/halo.py`` transposes, ``parallel/sharding.py``'s gradient sums, ``training``,
``checkpoint.py`` under a mesh, ``tools/multihost_sim``'s train half) on the CPU, in
float64.

* One run of ``multihost_sim --data 2 --lat 2 --lon 2 --train ...`` (eight gloo processes
  over a ``FileStore``, ``AuroraSmallPretrained(use_lora=True)`` at widths 64 and two blocks
  a stage, ``remat`` at "full"): the LoRA step, the K = 2 roll-out step and the stochastic
  step (``drop_path=0.2, drop_rate=0.1``, one seed) under each ``make_mesh(1, 2, 2)`` plane,
  on 40 x 96 (tokens 10 x 24, split into whole patches) and 44 x 96 (11 x 24 tokens: the
  encoder and decoder run whole), equal the one-process port's steps within 1e-8 mean-rel:
  the loss, every LoRA gradient and the updated LoRA parameters. The full step under
  ``make_mesh(2, 2, 2)`` with ``shard_params`` equals ``aurora_tpu.training.train.
  make_train_step`` under the same mesh on the virtual CPU devices (the loss and every
  updated parameter within 1e-8), its training state saved under the mesh restores into one
  process (the same parameters, the same file byte for byte) and back under the mesh bit for
  bit. A rank's own gradient, had it skipped the sum over its ``(lat, lon)`` plane, misses
  the one-process gradient by orders of magnitude.
* In process: every move of the two grids' blocks (``halo.enter_windows`` /
  ``leave_windows``, ``merge_rows``, ``split_crop``, each a :func:`~aurora_tpu_torch.parallel.
  halo.fetch` a split axis) on a ``lat = lon = 2`` mesh of four threads that meet in a
  simulated all-gather: its forward equals the whole grid moved in one process, and its
  backward is its transpose, ``<move(x), y> = <x, move^T(y)>``.

The tool runs once for the module, beside the JAX package's one train-step compile.
"""

import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu import AuroraSmallPretrained as JaxSmall
from aurora_tpu.parallel import mesh as jmesh
from aurora_tpu.parallel import sharding as jsharding
from aurora_tpu.training.train import adamw as j_adamw
from aurora_tpu.training.train import make_train_step as j_make_train_step
from aurora_tpu_torch import AuroraSmallPretrained as PortSmall
from aurora_tpu_torch.checkpoint import save_params
from aurora_tpu_torch.model.config import BackboneConfig
from aurora_tpu_torch.model.swin3d import (
    crop_3d,
    get_encoder_specs,
    maybe_adjust_windows,
    pad_3d,
)
from aurora_tpu_torch.parallel import halo, split_bounds
from aurora_tpu_torch.tools import multihost_sim, scaling_bytes
from tests.test_torch_support import mean_rel, seeded_matched_variant, tree_name

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(use_lora=True, embed_dim=64, encoder_depths=(2, 2, 2), decoder_depths=(2, 2, 2))
GRIDS = {"aligned": (40, 96), "misaligned": (44, 96)}
STEPS = ("lora", "rollout", "stochastic")
TOL = 1e-8  # mean relative error, float64


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------------------ in process


class _Rank:
    """Rank ``(i, j)`` of a simulated ``lat = lon = 2`` mesh."""

    shape = {"data": 1, "lat": 2, "lon": 2}

    def __init__(self, i: int, j: int):
        self.at = {"data": 0, "lat": i, "lon": j}

    def axis_index(self, axis):
        return self.at[axis]


def _on_mesh(fn):
    """``fn(mesh)`` for each rank of a ``lat = lon = 2`` mesh, on four threads whose
    all-gathers meet along their lines (``halo._all_gather`` stood in for); the results in
    rank order."""
    lines = {(a, o): threading.Barrier(2) for a in ("lat", "lon") for o in range(2)}
    bufs: dict = {}
    out: list = [None] * 4
    errors: list = []

    def gather(buf, k, mesh, axis):
        other = mesh.at["lon" if axis == "lat" else "lat"]
        barrier = lines[axis, other]
        bufs[axis, other, mesh.at[axis]] = buf.detach().clone()
        barrier.wait()
        got = torch.stack([bufs[axis, other, r] for r in range(2)])
        barrier.wait()
        return got

    def body(r):
        try:
            out[r] = fn(_Rank(*divmod(r, 2)))
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errors.append(e)
            for b in lines.values():
                b.abort()

    real = halo._all_gather
    halo._all_gather = gather
    try:
        threads = [threading.Thread(target=body, args=(r,)) for r in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        halo._all_gather = real
    if errors:
        raise errors[0]
    return out


def _cases():
    """The blocks' geometries of the small model on the two grids: each stage's ``(res,
    shift)``, shifted or not, and each merge's and split's."""
    cfg = BackboneConfig(embed_dim=64, encoder_depths=(2, 2, 2), decoder_depths=(2, 2, 2))
    out = []
    for H, W in GRIDS.values():
        res_all, pads = get_encoder_specs(cfg, (4, H // 4, W // 4))
        for res in res_all:
            for shift in ((0, 0, 0), tuple(w // 2 for w in cfg.window_size)):
                ws, ss = maybe_adjust_windows(cfg.window_size, shift, res)
                out.append(("windows", res, (ws, ss)))
        for res in res_all[:-1]:
            out.append(("merge", res, None))
        for res, crop in zip(res_all[1:], pads[:-1]):
            out.append(("split", res, crop))
    return out


CASES = _cases()


def _block(X, rows, cols):
    return X[:, :, rows[0]:rows[1], cols[0]:cols[1]]


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{k} {r} {x[1] if k == 'windows' else x}" for k, r, x in CASES])
def test_fetch_and_its_transpose(case):
    """Each move of a block on the mesh (``enter_windows`` / ``leave_windows``,
    ``merge_rows``, ``split_crop``) against the whole grid moved in one process, and its
    backward the transpose: <move(x), y> = <x, move^T(y)> summed over the ranks."""
    kind, (C, H, W), extra = CASES[case]
    g = torch.Generator().manual_seed(case)
    h, w = (2 * H, 2 * W) if kind == "split" else (H, W)
    X = torch.randn(2, C, h, w, 3, dtype=torch.float64, generator=g)
    if kind == "windows":
        ws, ss = extra
        geo = halo.window_geometry((C, H, W), ws, ss, _Rank(0, 0))
        moved = pad_3d(torch.roll(X, (-ss[0], -ss[1], -ss[2]), (1, 2, 3)), geo.pad, geo.extra)
        n_rows, n_cols = geo.block
        want_rows = [(i * n_rows, (i + 1) * n_rows) for i in range(2)]
        want_cols = [(j * n_cols, (j + 1) * n_cols) for j in range(2)]
    elif kind == "merge":
        moved = pad_3d(X, (0, H % 2, W % 2))
        want_rows = [(2 * a, 2 * b) for a, b in split_bounds((H + H % 2) // 2, 2)]
        want_cols = [(2 * a, 2 * b) for a, b in split_bounds((W + W % 2) // 2, 2)]
    else:
        moved = crop_3d(X, extra)
        want_rows, want_cols = split_bounds(moved.shape[2], 2), split_bounds(moved.shape[3], 2)
    have_rows = split_bounds(h, 2) if kind != "split" else [(2 * a, 2 * b) for a, b in
                                                            split_bounds(H, 2)]
    have_cols = split_bounds(w, 2) if kind != "split" else [(2 * a, 2 * b) for a, b in
                                                            split_bounds(W, 2)]

    def rank(mesh):
        i, j = mesh.at["lat"], mesh.at["lon"]
        x = _block(X, have_rows[i], have_cols[j]).clone().requires_grad_(True)
        if kind == "windows":
            y = halo.enter_windows(x, geo, mesh)
            back = halo.leave_windows(y, geo, mesh)
            round_trip = torch.equal(back.detach(), x.detach())
        elif kind == "merge":
            y, round_trip = halo.merge_rows(x, (C, H, W), mesh), True
        else:
            y, round_trip = halo.split_crop(x, (C, H, W), extra, mesh), True
        Y = torch.randn(y.shape, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(100 * case + 2 * i + j))
        (gx,) = torch.autograd.grad(y, x, Y)
        same = torch.equal(y.detach(), _block(moved, want_rows[i], want_cols[j]))
        return float((y.detach() * Y).sum()), float((x.detach() * gx).sum()), same, round_trip

    res = _on_mesh(rank)
    lhs, rhs = sum(r[0] for r in res), sum(r[1] for r in res)
    assert all(r[2] for r in res) and all(r[3] for r in res), res
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0), (lhs, rhs)


def test_the_cases_cover_every_move():
    """Shifted and unshifted blocks, over-padded grids, odd merges and split crops."""
    kinds = [k for k, _, _ in CASES]
    assert kinds.count("windows") == 12 and kinds.count("merge") == 4
    assert kinds.count("split") == 4
    geos = [halo.window_geometry(r, *x, _Rank(0, 0)) for k, r, x in CASES if k == "windows"]
    assert any(any(g.extra) for g in geos) and any(any(g.ss) for g in geos)
    assert any(r[1] % 2 for k, r, _ in CASES if k == "merge")


# ------------------------------------------------------------------------------ the mesh


def _jax_full_step(jm, params):
    """``aurora_tpu``'s full train step (``make_train_step``, ``adamw(LR)``) under
    ``make_mesh(2, 2, 2)`` with ``shard_params``, on the tool's first grid, batch 2, zero
    targets."""
    b = multihost_sim.make_inputs("cpu", 0, GRIDS["aligned"], batch=2).astype(
        torch.float64).crop(4)
    from aurora_tpu import Batch as JBatch
    from aurora_tpu import Metadata as JMetadata

    arr = lambda d: {k: jnp.asarray(v.numpy()) for k, v in d.items()}  # noqa: E731
    md = b.metadata
    batch = JBatch(surf_vars=arr(b.surf_vars), static_vars=arr(b.static_vars),
                   atmos_vars=arr(b.atmos_vars),
                   metadata=JMetadata(lat=np.asarray(md.lat), lon=np.asarray(md.lon),
                                      time=md.time, atmos_levels=md.atmos_levels,
                                      rollout_step=0))
    levels = tuple(float(x) for x in md.atmos_levels)
    enc = jm.prepare_encodings(batch, dtype=jnp.float64)
    tgt_s = {k: jnp.zeros_like(v[:, -1]) for k, v in batch.surf_vars.items()}
    tgt_a = {k: jnp.zeros_like(v[:, -1]) for k, v in batch.atmos_vars.items()}
    tx = j_adamw(multihost_sim.LR)
    step = j_make_train_step(jm.cfg, tx, levels)
    mesh = jmesh.make_mesh(data=2, lat=2, lon=2)
    with jax.set_mesh(mesh):
        p = jsharding.shard_params(params, mesh)
        s, st, a = jsharding.shard_batch_arrays(batch.surf_vars, batch.static_vars,
                                                batch.atmos_vars, mesh)
        new, _, loss = step(p, tx.init(p), s, st, a, enc, jnp.asarray(0, jnp.int32), tgt_s,
                            tgt_a)
        flat = {tree_name(path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(new)[0]}
    return dict(loss=float(loss), params=flat)


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """The tool's results (eight ranks and the one-process run) and the JAX package's full
    step under the same mesh, from one float64 tree."""
    folder = tmp_path_factory.mktemp("lat_lon_train")
    jm, params, tm = seeded_matched_variant(JaxSmall, PortSmall, dtype=jnp.float64, **ARCH)
    save_params(tm, folder / "params.pt")
    del tm
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "aurora_tpu_torch.tools.multihost_sim", "--device", "cpu",
         "--data", "2", "--lat", "2", "--lon", "2", "--depths", "2", "--width", "64",
         "--dtype", "float64", "--grids", ",".join(f"{h}x{w}" for h, w in GRIDS.values()),
         "--no-serve", "--train", ",".join(("forward",) + STEPS + ("full",)), "--params",
         str(folder / "params.pt"), "--save", str(folder / "out.pt")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        jax_out = _jax_full_step(jm, params)
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out.decode(errors="replace")[-3000:]
    res = torch.load(folder / "out.pt", weights_only=False)
    return dict(res, jax=jax_out)


def _step(sim, name, step):
    """The one-process step and the step of the plane that ran ``name``'s grid."""
    key = "x".join(map(str, (GRIDS[name][0] // 4 * 4, GRIDS[name][1])))
    lead = 4 * list(GRIDS).index(name)  # the planes take the grids in turn
    want = sim["reference"]["train"]["small"]["grids"][key][step]
    got = sim["ranks"][lead]["train"]["small"]["grids"][key][step]
    return want, got


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("name", GRIDS)
def test_steps_match_the_one_process_port(sim, name, step):
    """The loss, every LoRA gradient (summed over the plane) and every updated LoRA
    parameter of the step under ``make_mesh(1, 2, 2)`` against the one-process step."""
    want, got = _step(sim, name, step)
    assert abs(got["loss"] - want["loss"]) <= TOL * abs(want["loss"])
    assert sorted(got["grads"]) == sorted(want["grads"]) and len(want["grads"]) >= 24
    assert all(n.split(".")[-2].startswith("lora_") for n in want["grads"])
    for n, w in want["grads"].items():
        assert mean_rel(got["grads"][n], w) <= TOL, (n, mean_rel(got["grads"][n], w))
        assert mean_rel(got["params"][n], want["params"][n]) <= TOL, n
    key = "x".join(map(str, (GRIDS[name][0] // 4 * 4, GRIDS[name][1])))
    assert sim["result"]["train"]["configs"]["small"][key][step]["ok"]


@pytest.mark.parametrize("step", STEPS)
def test_skipping_the_plane_sum_fails_the_gradient_check(sim, step):
    """A rank's own gradient (its block's share, as the backward left it) against the
    one-process gradient: what the check reads had the rank skipped the sum over its
    ``(lat, lon)`` plane, orders of magnitude above the bound."""
    for name in GRIDS:
        want, got = _step(sim, name, step)
        worst = max(mean_rel(got["local_grads"][n], w) for n, w in want["grads"].items())
        assert worst > 1e6 * TOL, (name, worst)


def test_the_stochastic_step_drew_masks(sim):
    """The stochastic step's loss is not the deterministic loss at the same weights: the
    knobs acted (and the step above holds both processes to the same masks)."""
    for name in GRIDS:
        want, got = _step(sim, name, "stochastic")
        for step in (want, got):
            assert abs(step["loss"] - step["deterministic_loss"]) > 1e-6 * abs(step["loss"])
        assert abs(got["deterministic_loss"] - want["deterministic_loss"]) <= TOL * abs(
            want["deterministic_loss"])


def test_full_step_matches_jax_under_the_mesh(sim):
    """The full step under ``make_mesh(2, 2, 2)`` with ``shard_params``: the loss and every
    updated parameter against ``aurora_tpu``'s step under the same mesh."""
    full = sim["rank0"]["train"]["small"]["full"]
    got, want = full["full"], sim["jax"]
    assert abs(got["loss"] - want["loss"]) <= TOL * abs(want["loss"])
    assert sorted(got["params"]) == sorted(want["params"])
    worst = {n: mean_rel(got["params"][n], w) for n, w in want["params"].items()}
    assert max(worst.values()) <= TOL, max(worst.items(), key=lambda kv: kv[1])
    assert full["split"] and all(s["slice"] * 2 == s["param"] for s in full["split"].values())
    res = sim["result"]["train"]["configs"]["small"]["full"]
    assert res["ok"] and res["moments_are_slices"] and res["split_params"] >= 10


def test_checkpoint_under_the_mesh_round_trips(sim):
    """Saved under the mesh (the ZeRO slices and moments gathered, one rank writing), the
    state restores into one process (its parameters the ranks' gathered ones; saved again,
    the same bytes) and back under the mesh on every rank, bit for bit."""
    res = sim["result"]["train"]
    assert res["configs"]["small"]["full"]["checkpoint_restored_on_every_rank"]
    one = res["checkpoint_one_process"]["small"]
    assert one["params_equal"] and one["file_bytes_equal"] and one["step"] == 1
    assert all(r["train"]["small"]["full"]["checkpoint"]["bits_equal"] for r in sim["ranks"])
    assert res["ok"] and sim["result"]["ok"] and sim["result"]["processes"] == 8


def test_the_inventory_is_the_run_collective_for_collective(sim):
    """``tools.scaling_bytes.inventory``, counted from the plans and parameter sizes, equals
    every rank's ``halo.STATS`` by kind (count and bytes): the forward, the LoRA and
    stochastic steps on both grids under ``make_mesh(1, 2, 2)``, the full step under
    ``make_mesh(2, 2, 2)`` with ``shard_params``."""
    args = multihost_sim.main.__globals__["argparse"].Namespace(depths=2, width=64,
                                                               config="small")
    cfg = multihost_sim.spatial_config(args).replace(remat=True, remat_scope="full")
    shapes = scaling_bytes.param_shapes(cfg, torch.float64)
    plane = dict(data=1, lat=2, lon=2)
    kw = dict(batch=2, input_bytes=8, levels=4, shapes=shapes)
    checked = set()
    for g, name in enumerate(GRIDS):
        key = "x".join(map(str, (GRIDS[name][0] // 4 * 4, GRIDS[name][1])))
        for r in range(4):
            got = sim["ranks"][4 * g + r]["train"]["small"]["grids"][key]
            at = dict(data=0, lat=r // 2, lon=r % 2)
            for step, mode in (("forward", "fwd"), ("lora", "train"), ("stochastic", "train")):
                want = scaling_bytes.inventory(cfg, GRIDS[name], plane, mode, at=at, **kw)
                assert got[step]["halo"]["by_kind"] == want, (name, r, step)
                checked |= set(want)
    for r in range(8):
        got = sim["ranks"][r]["train"]["small"]["full"]["full"]["halo"]["by_kind"]
        at = dict(data=r // 4, lat=(r % 4) // 2, lon=r % 2)
        want = scaling_bytes.inventory(cfg, GRIDS["aligned"], dict(data=2, lat=2, lon=2),
                                       "train", "zero", at=at, trainable="all", **kw)
        assert got == want, r
        checked |= set(want)
    assert {"fetch:enter", "fetch_T:leave", "fetch:merge", "fetch_T:split", "gather",
            "gather_T", "grad:all_reduce", "grad:plane_sum", "grad:reduce_scatter",
            "zero:all_gather", "loss", "grid"} <= checked, checked


def test_the_mesh_tools_read_the_run(sim):
    """``tools.halo_analysis`` reads each step's collectives off the ranks' reports (the
    most over a plane's ranks), and ``tools.scaling_bytes`` counts a cell of the 1.3 B model
    at 721 x 1440: every rank of the plane, the halo moves, their transposes and the
    gradient and ZeRO buckets of the train step under ZeRO."""
    from aurora_tpu_torch.tools import halo_analysis

    key = "x".join(map(str, GRIDS["aligned"]))
    lora = halo_analysis.collectives(sim["ranks"][:4], "small", key, "lora")
    want = max(r["train"]["small"]["grids"][key]["lora"]["halo"]["by_kind"]["fetch:enter"][
        "bytes"] for r in sim["ranks"][:4])
    assert lora["by_kind"]["fetch:enter"]["bytes"] == want and len(lora["total_bytes"]) == 4
    full = halo_analysis.collectives(sim["ranks"], "small", key, "full")
    assert "zero:all_gather" in full["by_kind"] and len(full["total_bytes"]) == 8
    cell = scaling_bytes.cell("2,2,2:train:zero")
    assert len(cell["ranks"]) == 4 and cell["param_count"] > 1.2e9
    kinds = set(cell["collectives_per_rank_max"])
    assert {"fetch:enter", "fetch_T:leave", "fetch:merge", "fetch:split", "grad:all_reduce",
            "zero:all_gather", "loss", "grid"} <= kinds, kinds
    assert 0 < cell["halo_bytes_per_rank_max"] < cell["total_bytes_per_rank_max"]
