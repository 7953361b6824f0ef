"""``aurora_tpu_torch.tools.production_drift`` (the port of ``tools/production_drift.py``) on
the CPU, at the JAX tool's small config (``--small``) on a 17 x 32 grid.

* ``--small --steps 2`` writes every key of the JAX record (the key list read from
  ``PRODUCTION_DRIFT.json``) to the file it is given, and never writes the JAX record: the
  record's bytes are unchanged and ``--out`` naming it is refused. Its default output is
  ``PRODUCTION_DRIFT_torch.json``.
* The float32 roll-out run twice drifts from itself by exactly 0; the production stack
  drifts by more than 0 and less than 1e-1 (bf16 roundings over two steps).
* ``curve`` and ``growth`` agree with a float64 numpy recomputation on fixed arrays.
* The port's three roll-outs against the JAX tool's (``tools/production_drift.py``
  ``run_rollout``, the same small config, grid and weights) at the first step: float32 and
  the chaos control <= 1e-5 mean relative per variable, production <= 2e-2 (two bf16
  stacks, each ~8e-3 from float32), and the first row of each curve within a factor of 2 of
  the JAX tool's. That holds the model, the gates and LoRA banks opened, the batch, its
  perturbation and the production stack to the JAX tool's. The later steps are not held to
  the JAX tool: it prepares the time encodings once and keeps them for every step, where a
  roll-out advances the time a step (``aurora_tpu.rollout_scan``; the port's
  ``rollout_scan`` is held to it in ``tests/test_torch_rollout_scan.py``), so its second
  float32 step is another prediction, more than 1e-3 from the port's.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu_torch.convert import load_numpy_params
from aurora_tpu_torch.model.aurora import Aurora
from aurora_tpu_torch.tools import production_drift as drift
from tests.test_torch_support import _seeded_tree, mean_rel, numpy_tree

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--small", "--steps", "2", "--H", "17", "--W", "32"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, the caller's count restored after (the suite runs six workers
    at once; see ``tests/test_torch_training.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    jax_record = (ROOT / drift.JAX_RECORD).read_bytes()
    out = tmp_path_factory.mktemp("drift") / "drift.json"
    result = drift.main([*ARGS, "--out", str(out)])
    assert (ROOT / drift.JAX_RECORD).read_bytes() == jax_record
    return result, json.loads(out.read_text())


def test_small_run_writes_every_key_of_the_jax_record(record):
    result, written = record
    want = set(json.loads((ROOT / drift.JAX_RECORD).read_text()))
    assert want <= set(written), sorted(want - set(written))
    assert written == json.loads(json.dumps(result))
    assert written["config"] == "small" and written["steps"] == 2 and written["grid"] == [17, 32]
    assert written["device"] == "cpu"
    assert [r["step"] for r in written["per_step"]] == [1, 2]
    assert len(written["prod_step_growth_wrmse"]) == len(written["chaos_step_growth_wrmse"]) == 1
    assert drift.OUT.name == "PRODUCTION_DRIFT_torch.json"
    with pytest.raises(SystemExit):
        drift.main([*ARGS, "--out", str(ROOT / drift.JAX_RECORD)])


def test_production_drifts_and_float32_does_not(record):
    result, _ = record
    assert 0 < result["max_rel_err"] < 1e-1
    assert all(0 < r["wrmse_rel"] < 1e-1 for r in result["per_step"])
    model = drift.open_gates_and_lora(Aurora(drift.config(True, False), device="cpu", seed=0))
    batch = drift.initial_batch(17, 32, small=True)
    a, _ = drift.run_rollout(model, batch, 2)
    b, _ = drift.run_rollout(model, batch, 2)
    rows = drift.curve(a, b, drift.latitude_weights(17, 16))
    assert [(r["max_rel_err"], r["wrmse_rel"], r["wrmse_median"]) for r in rows] == [(0, 0, 0)] * 2
    assert {k: v.shape for k, v in a[0].items()}["atmos:t"] == (1, 4, 16, 32)


def test_curve_matches_a_float64_recomputation():
    rng = np.random.default_rng(7)
    H, W = 9, 12
    names = ("surf:2t", "atmos:z", "atmos:q")
    shapes = {"surf:2t": (1, H - 1, W), "atmos:z": (1, 3, H - 1, W), "atmos:q": (1, 3, H - 1, W)}
    ref = [{k: rng.standard_normal(shapes[k]).astype(np.float32) for k in names}
           for _ in range(3)]
    other = [{k: (v + 10.0 ** -(2 + i) * rng.standard_normal(v.shape)).astype(np.float32)
              for i, (k, v) in enumerate(step.items())} for step in ref]
    w = drift.latitude_weights(H, H - 1)
    lat = np.linspace(90, -90, H)[:H - 1]
    assert np.allclose(w[:, 0], np.cos(np.deg2rad(lat)) / np.cos(np.deg2rad(lat)).mean())
    rows = drift.curve(ref, other, w)
    for step, (r, o, row) in enumerate(zip(ref, other, rows)):
        mx, wr = {}, {}
        for k in names:
            d = o[k].astype(np.float64) - r[k].astype(np.float64)
            mx[k] = np.abs(d).max() / np.abs(r[k].astype(np.float64)).max()
            wr[k] = np.sqrt((w * d**2).mean()) / np.sqrt((w * r[k].astype(np.float64) ** 2).mean())
        assert row["step"] == step + 1
        assert row["max_rel_err"] == pytest.approx(max(mx.values()), rel=1e-6)
        assert row["wrmse_rel"] == pytest.approx(max(wr.values()), rel=1e-6)
        assert row["wrmse_median"] == pytest.approx(np.median(list(wr.values())), rel=1e-6)
        assert row["worst_var_max"] == max(mx, key=mx.get)
        assert row["worst_var_wrmse"] == max(wr, key=wr.get)
    want = [round(b["wrmse_rel"] / a["wrmse_rel"], 2) for a, b in zip(rows, rows[1:])]
    assert drift.growth(rows) == want


def test_first_step_matches_the_jax_tool(monkeypatch):
    """The port's ``rollouts`` against the JAX tool's ``run_rollout`` on the CPU, both from
    one numpy-seeded weight tree (the JAX init's structure; the tool's own
    ``open_gates_and_lora`` then opens the gates of both)."""
    from aurora_tpu.model import aurora as jax_aurora
    from aurora_tpu.model.config import AuroraConfig as JaxConfig
    from tools import production_drift as jax_tool

    H, W, perturb = 17, 32, 1e-6
    jmodel = jax_aurora.Aurora(JaxConfig(**drift.SMALL).replace(use_lora=True))
    params, _ = _seeded_tree(jmodel, Aurora(drift.config(True, False), device="cpu",
                                            seed=None), 0, jnp.float32)
    monkeypatch.setattr(jax_aurora, "init_params", lambda *a, **kw: params)
    # The tool points JAX's persistent compile cache at a directory outside the test's.
    update = jax.config.update
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: None if "cache" in k else update(k, v))
    want = {mode: jax_tool.run_rollout("f32" if mode == "chaos" else mode,
                                       2 if mode == "f32" else 1, H, W, small=True,
                                       perturb=perturb if mode == "chaos" else 0.0)
            for mode in ("f32", "production", "chaos")}

    model = load_numpy_params(Aurora(drift.config(True, False), device="cpu", seed=None),
                              numpy_tree(jax_tool.open_gates_and_lora(params)))
    ref, prod, chaos, _ = drift.rollouts(model, 2, H, W, True, perturb)
    got = {"f32": ref, "production": prod, "chaos": chaos}
    for mode, tol in [("f32", 1e-5), ("chaos", 1e-5), ("production", 2e-2)]:
        errs = {k: mean_rel(got[mode][0][k], want[mode][0][k]) for k in want[mode][0]}
        assert max(errs.values()) <= tol, (mode, errs)
    # The JAX tool's second step keeps the first step's time encodings.
    stale = max(mean_rel(ref[1][k], want["f32"][1][k]) for k in ref[1])
    assert stale > 1e-3, stale

    w = drift.latitude_weights(H, H - 1)
    for other in ("production", "chaos"):
        a = drift.curve(ref[:1], got[other][:1], w)[0]
        b = drift.curve(want["f32"][:1], want[other], w)[0]
        for key in ("max_rel_err", "wrmse_rel"):
            assert 0.5 <= a[key] / b[key] <= 2.0, (other, key, a, b)
