"""The port's data axis (``aurora_tpu_torch/parallel``, the train steps under a data mesh,
``tools/multihost_sim``) against ``aurora_tpu.parallel`` on the CPU.

* ``auto_mesh`` factorises as the JAX package's for 1-8 devices, the grids None, (180,
  360), (450, 900) and (113, 225), and batch 1, 2 and 4;
* eight processes enter a ``lat=2, lon=4`` mesh and move a token grid's blocks through the
  halo (``tests/test_torch_lat_lon.py`` holds the model under a ``(lat, lon)`` mesh);
* ``zero_partition_spec`` places every leaf of the LARGE LoRA tree as the JAX package's at
  data = 2, 4 and 8 (the JAX shapes from ``jax.eval_shape``, the port's from a model on the
  ``meta`` device, matched by ``convert.py``'s path rule);
* one run of ``multihost_sim --data 2`` (two gloo processes over a ``FileStore``, float32,
  ``AuroraSmallPretrained(use_lora=True)`` at two blocks a stage, the JAX tool's 33 x 64
  batch of 2) from a numpy-seeded tree that the JAX model holds too: its forward and a
  one-step ``rollout`` equal the one-process port's, the forward also ``aurora_tpu``'s
  ``forward_core`` under ``make_mesh(data=2)``; its full fine-tune step under
  ``shard_params`` moves ``encoder.surf_token_embeds.weights.2t`` as the JAX package's step
  under that mesh and ``shard_params`` does (``make_train_step``'s arithmetic: the loss's
  value and gradient, then ``adamw(1e-4)``); each rank's AdamW moments of a split leaf are
  half of it; its LoRA step and its K = 2 roll-out step equal the one-process steps.

The tool runs once for the module, beside the JAX package's compile.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aurora_tpu import AuroraSmallPretrained as JaxSmall
from aurora_tpu.model.aurora import forward_core
from aurora_tpu.model.config import LARGE_CONFIG
from aurora_tpu.parallel import mesh as jmesh
from aurora_tpu.parallel import sharding as jsharding
from aurora_tpu.training.train import adamw as j_adamw
from aurora_tpu.training.train import mae_loss as j_mae_loss
from aurora_tpu_torch import AuroraSmallPretrained as PortSmall
from aurora_tpu_torch.checkpoint import save_params
from aurora_tpu_torch.model.aurora import Aurora
from aurora_tpu_torch.parallel import (
    auto_mesh,
    initialize,
    make_mesh,
    process_summary,
    zero_partition_spec,
)
from aurora_tpu_torch.tools import multihost_sim
from tests.conftest import make_batch
from tests.test_torch_support import max_rel, port_config, seeded_matched_variant, tree_name

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTHS = dict(encoder_depths=(2, 2, 2), decoder_depths=(2, 2, 2))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------------------ the mesh


@pytest.mark.parametrize("n", range(1, 9))
def test_auto_mesh_factorises_as_jax(n):
    for grid in (None, (180, 360), (450, 900), (113, 225)):
        for batch in (1, 2, 4):
            want = jmesh.auto_mesh(n, grid=grid, batch=batch)
            got = auto_mesh(n, devices=range(8), grid=grid, batch=batch, device="cpu")
            assert got.shape == dict(want.shape), (n, grid, batch)
            assert got.ranks.ravel().tolist() == list(range(n))


@pytest.mark.parametrize("data", [2, 4, 8])
def test_zero_partition_spec_places_the_large_tree_as_jax(data):
    cfg = LARGE_CONFIG.replace(use_lora=True)
    from aurora_tpu.model.aurora import init_params

    tree = jax.eval_shape(lambda k: init_params(k, cfg, dtype=jnp.float32),
                          jax.random.PRNGKey(0))
    port = dict(Aurora(port_config(cfg), device="meta", seed=None).named_parameters())
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(leaves) == len(port)
    split = 0
    for path, leaf in leaves:
        p = port[tree_name(path)]
        assert tuple(p.shape) == leaf.shape, tree_name(path)
        want = tuple(jsharding.zero_partition_spec(leaf, data))
        assert zero_partition_spec(p.shape, data) == want, tree_name(path)
        split += "data" in want
    assert split >= 300


_ENTER_PROBE = """
import sys

import torch

from aurora_tpu_torch.model.swin3d import pad_3d
from aurora_tpu_torch.parallel import (TOKENS_5D_SPEC, gather_tensor, halo, initialize,
                                       make_mesh, shard_tensor)

rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
initialize(coordinator_address=f"file://{store}", num_processes=8, process_id=rank)
mesh = make_mesh(data=1, lat=2, lon=4, device="cpu")
x = torch.arange(2 * 13 * 22 * 3, dtype=torch.float64).reshape(1, 2, 13, 22, 3)
res = {}
with mesh:
    local = shard_tensor(x, TOKENS_5D_SPEC, mesh)
    geo = halo.window_geometry((2, 13, 22), (2, 6, 12), (1, 3, 6), mesh)
    xp = halo.enter_windows(local, geo, mesh)
    want = pad_3d(torch.roll(x, (-1, -3, -6), (1, 2, 3)), geo.pad, geo.extra)
    i, j = mesh.axis_index("lat"), mesh.axis_index("lon")
    m = geo.block
    res["enter"] = torch.equal(xp, want[:, :, i * m[0]:(i + 1) * m[0], j * m[1]:(j + 1) * m[1]])
    res["leave"] = torch.equal(halo.leave_windows(xp, geo, mesh), local)
    res["gather"] = torch.equal(gather_tensor(local, TOKENS_5D_SPEC, mesh), x)
    res["lon_line"], res["lon_neighbours"] = mesh.line("lon"), mesh.neighbours("lon")
    res["lat_neighbours"] = mesh.neighbours("lat")
torch.save(res, f"{out}/r{rank}.pt")
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""


def test_a_lat_lon_mesh_is_entered_and_the_tool_accepts_it(tmp_path, monkeypatch):
    """Eight gloo processes enter ``make_mesh(lat=2, lon=4)``: each rank's block of a 13 x 22
    token grid (rows 7 / 6, columns 6 / 6 / 6 / 4), rolled by half a window and over-padded
    to window x mesh multiples by the halo moves, is the block of the whole grid rolled and
    padded in one process, and moves back; the blocks gather to the grid; the lon line is a
    ring of four. ``multihost_sim`` takes ``--lat 2 --lon 4`` (its default layout) and gets as
    far as the device, which without a card it refuses."""
    script = tmp_path / "probe.py"
    script.write_text(_ENTER_PROBE)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(tmp_path / "store"),
                               str(tmp_path)], cwd=ROOT, env=env) for r in range(8)]
    try:
        rcs = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert rcs == [0] * 8
    for r in range(8):
        res = torch.load(tmp_path / f"r{r}.pt", weights_only=False)
        assert res["enter"] and res["leave"] and res["gather"], (r, res)
        i, j = divmod(r, 4)
        assert res["lon_line"] == [4 * i + n for n in range(4)]
        assert res["lon_neighbours"] == (4 * i + (j - 1) % 4, 4 * i + (j + 1) % 4)
        assert res["lat_neighbours"] == ((r + 4) % 8, (r + 4) % 8)
    args = multihost_sim.main.__globals__["argparse"].Namespace(data=None, lat=None, lon=None)
    assert multihost_sim.layout(args) == (1, 2, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="No CUDA device"):
        multihost_sim.main(["--lat", "2", "--lon", "4"])


def test_one_process_needs_no_process_group():
    initialize()  # a single process: a no-op
    assert process_summary()["process_count"] == 1
    mesh = auto_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "lat": 1, "lon": 1} and mesh.group("data") is None
    with mesh:
        pass
    with pytest.raises(ValueError, match="Need 2 devices"):
        make_mesh(data=2, device="cpu")


def test_the_card_is_the_default_device(monkeypatch):
    """A mesh and the tool compute on the card unless the caller asks for the CPU: without a
    card they raise rather than carry on on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="No CUDA device"):
        auto_mesh(1)
    with pytest.raises(RuntimeError, match="No CUDA device"):
        multihost_sim.main([])
    assert auto_mesh(1, device="cpu").device == torch.device("cpu")


def test_initialize_raises_only_with_explicit_topology(monkeypatch):
    """A failure with explicit topology arguments raises (no one-process fallback); a
    topology from an incomplete environment is skipped, as the JAX package's auto-detect."""
    with pytest.raises(RuntimeError):
        initialize(coordinator_address="localhost:1", num_processes=2, process_id=1,
                   timeout_s=1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    initialize()
    assert process_summary()["process_count"] == 1


# ------------------------------------------------------------------------------ the data axis


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """The tool's results (two processes and the one-process run) and the JAX package's
    forward and full step under ``make_mesh(data=2)``, from one float32 tree."""
    folder = tmp_path_factory.mktemp("multihost")
    jm, params, tm = seeded_matched_variant(JaxSmall, PortSmall, dtype=jnp.float32,
                                            use_lora=True, **DEPTHS)
    save_params(tm, folder / "params.pt")
    del tm
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "aurora_tpu_torch.tools.multihost_sim", "--data", "2",
         "--device", "cpu", "--params", str(folder / "params.pt"), "--depths", "2", "--save",
         str(folder / "out.pt")], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    try:
        jax_out = _jax_data_mesh(jm, params)
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out.decode(errors="replace")[-3000:]
    res = torch.load(folder / "out.pt", weights_only=False)
    return dict(res, jax=jax_out)


def _jax_data_mesh(jm, params):
    """JAX's forward and full fine-tune step under ``make_mesh(data=2)`` with
    ``shard_params``: ``make_train_step``'s arithmetic in one jit (the loss's value and
    gradient, the forward its by-product, then ``adamw(1e-4)``), on the JAX tool's batch."""
    batch = make_batch(H=33, W=64, B=2, dtype=np.float32).crop(jm.cfg.patch_size)
    enc = jm.prepare_encodings(batch)
    levels = tuple(batch.metadata.atmos_levels)
    cfg = jm.cfg
    as_j = lambda d: {k: jnp.asarray(np.asarray(v)) for k, v in d.items()}  # noqa: E731
    H, W = batch.spatial_shape
    tgt_s = {k: jnp.zeros((2, H, W), jnp.float32) for k in cfg.surf_vars}
    tgt_a = {k: jnp.zeros((2, len(levels), H, W), jnp.float32) for k in cfg.atmos_vars}
    tx = j_adamw(multihost_sim.LR)
    step = jnp.asarray(0, jnp.int32)

    @jax.jit
    def forward_and_step(p, o, surf, static, atmos):
        def loss_fn(p):
            ps, pa = forward_core(p, surf, static, atmos, enc, step, levels, cfg)
            return j_mae_loss(ps, pa, tgt_s, tgt_a), (ps, pa)

        (loss, out), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, _ = tx.update(g, o, p)
        return out, loss, optax.apply_updates(p, updates)

    mesh = jmesh.make_mesh(data=2)
    with jax.set_mesh(mesh):
        p = jsharding.shard_params(params, mesh)
        s, st, a = jsharding.shard_batch_arrays(as_j(batch.surf_vars), as_j(batch.static_vars),
                                                as_j(batch.atmos_vars), mesh)
        assert s["2t"].addressable_shards[0].data.shape[0] == 1  # the batch is split
        (ps, pa), loss, new = forward_and_step(p, tx.init(p), s, st, a)
    probe = new["encoder"]["surf_token_embeds"]["weights"]["2t"]
    return dict(forward={k: np.asarray(v) for k, v in {**ps, **pa}.items()},
                loss=float(loss), probe=np.asarray(probe))


def test_forward_and_rollout_match_the_one_process_port(sim):
    for f in ("forward", "rollout_forward"):
        ref, got = sim["reference"][f], sim["rank0"][f]
        for k in ref:
            assert got[k].shape == ref[k].shape and got[k].shape[0] == 2, (f, k)
            assert max_rel(got[k], ref[k]) <= multihost_sim.FORWARD_TOL, (f, k)
    assert sim["result"]["forward_max_rel"] <= multihost_sim.FORWARD_TOL


def test_forward_matches_jax_under_a_data_mesh(sim):
    want, got = sim["jax"]["forward"], sim["rank0"]["forward"]
    assert sorted(want) == sorted(got)
    for k in want:
        assert max_rel(got[k], want[k]) <= 1e-5, (k, max_rel(got[k], want[k]))


def test_full_step_moves_the_probe_as_jax_under_a_data_mesh(sim):
    got = sim["rank0"]["full_params"][multihost_sim.PROBE]
    assert not torch.equal(got, sim["rank0"]["probe_init"])
    assert max_rel(got, sim["jax"]["probe"]) <= 1e-5
    assert max_rel(got, sim["reference"]["full_params"][multihost_sim.PROBE]) <= 1e-5
    loss = sim["rank0"]["full_loss"]
    assert abs(loss - sim["jax"]["loss"]) <= 1e-6 * abs(sim["jax"]["loss"])


def test_split_leaves_keep_half_their_moments_on_each_rank(sim):
    res = sim["result"]
    assert res["moments_are_slices"] and res["split_params"] >= 10
    for s in sim["rank0"]["split"].values():
        assert s["slice"] * 2 == s["param"] and s["moments"] == [s["slice"]] * 2


def test_lora_and_rollout_steps_match_the_one_process_steps(sim):
    res = sim["result"]
    assert res["loss_rel"]["rollout_loss"] <= multihost_sim.LOSS_TOL
    assert res["rollout_grad_max_rel"] <= multihost_sim.ROLLOUT_GRAD_TOL
    assert sorted(sim["rank0"]["rollout_grads"]) == sorted(sim["rank0"]["lora_grads"])
    assert res["lora_grad_max_rel"] <= multihost_sim.PARAM_TOL
    # Rank 0's own gradient, had it skipped the average, lies far outside both bounds.
    assert res["rollout_grad_unaveraged_max_rel"] > 100 * multihost_sim.ROLLOUT_GRAD_TOL
    assert res["lora_grad_unaveraged_max_rel"] > 100 * multihost_sim.PARAM_TOL
    assert res["lora_param_max_rel"] <= multihost_sim.PARAM_TOL
    assert res["loss_rel"]["lora_loss"] <= multihost_sim.LOSS_TOL
    assert res["ok"] and res["backend"] == "gloo" and res["processes"] == 2
    assert res["replicate_from_rank0"]
