"""The port's command-line driver and the tools of the drivers' slice on the CPU.

* ``forecast --device cpu`` writes the files of the port's ``rollout`` bit for bit (seeded
  random weights, a port ``save_params`` file, a reference ``.ckpt``); the JAX package's
  ``Batch.from_netcdf`` reads them; ``--track`` writes the track of the tracker run on the
  roll-out's predictions.
* ``forecast`` from one reference-format ``.ckpt`` writes the JAX package's ``forecast``
  files within float32 rounding: both drivers build the facade's default config (float32
  all through).
* ``evaluate`` prints the JSON of the JAX package's ``evaluate`` on the same files.
* The error paths of ``tests/test_cli.py`` exit with code 2, and so does a run without a card
  and without ``--device cpu``, with a message.
* ``python -m aurora_tpu_torch`` without a card exits 2.
* ``tools.rollout_bench`` and ``tools.train_speed_probe`` with ``--device cpu`` at cut sizes.

The model: the small config's ``AuroraSmallPretrained`` facade cut to widths of 64 and two
blocks a stage (its ``default_config`` replaced for the test, in both packages), in its
default config, as the CLI builds it.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import aurora_tpu
import aurora_tpu_torch as port
from aurora_tpu import Batch as JBatch
from aurora_tpu.cli import main as j_main
from aurora_tpu_torch import Batch, rollout
from aurora_tpu_torch.checkpoint import save_params
from aurora_tpu_torch.cli import main
from aurora_tpu_torch.model.config import AuroraConfig
from aurora_tpu_torch.tools import rollout_bench, train_speed_probe
from aurora_tpu_torch.tools.perf_breakdown import PRODUCTION, open_gates
from aurora_tpu_torch.tracker import Tracker
from tests.conftest import make_batch
from tests.test_torch_support import batch_errors, reference_state_dict, seeded_matched_models


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, the caller's count restored after (the suite runs six workers
    at once; see ``tests/test_torch_training.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SMALL = dict(embed_dim=64, num_heads=4, encoder_depths=(2, 2), decoder_depths=(2, 2),
             encoder_num_heads=(2, 4), decoder_num_heads=(4, 2))
LEVELS = (100, 250, 500, 700, 850)


@pytest.fixture
def small_facade(monkeypatch):
    """``AuroraSmallPretrained`` at the test's widths, in both packages."""
    from aurora_tpu.model.config import AuroraConfig as JaxConfig

    monkeypatch.setattr(port.AuroraSmallPretrained, "default_config",
                        classmethod(lambda cls: AuroraConfig(**SMALL)))
    monkeypatch.setattr(aurora_tpu.AuroraSmallPretrained, "default_config",
                        classmethod(lambda cls: JaxConfig(**SMALL)))
    return port.AuroraSmallPretrained


def _built(cls, seed=0):
    """The model as ``forecast --random-init --seed`` builds it: the default config."""
    model = cls(device="cpu", seed=seed)
    assert not (model.cfg.autocast or model.cfg.agg_bf16 or model.cfg.deagg_bf16)
    return model


def _ic(path, H=17, W=32):
    make_batch(H=H, W=W, levels=LEVELS, dtype=np.float32).to_netcdf(path)
    return path


def _same_as_rollout(model, ic, out_dir, steps):
    """Every prediction file equals the port's ``rollout`` of ``model`` (bits, metadata), and
    the JAX package reads it to the same arrays."""
    preds = list(rollout(model, Batch.from_netcdf(ic), steps))
    files = sorted(os.listdir(out_dir))
    assert files[:steps] == [f"prediction-{i:03d}.nc" for i in range(steps)]
    for i, pred in enumerate(preds):
        path = out_dir / f"prediction-{i:03d}.nc"
        got, jgot = Batch.from_netcdf(path), JBatch.from_netcdf(path)
        assert got.metadata.rollout_step == jgot.metadata.rollout_step == i + 1
        assert got.metadata.time == pred.metadata.time
        for group in ("surf_vars", "atmos_vars", "static_vars"):
            want = getattr(pred, group)
            assert list(getattr(got, group)) == list(want)
            for k, v in want.items():
                v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                np.testing.assert_array_equal(getattr(got, group)[k], v)
                np.testing.assert_array_equal(np.asarray(getattr(jgot, group)[k]), v)
    return preds


def test_forecast_files_are_the_rollout_and_evaluate_is_jax(small_facade, tmp_path, capsys):
    ic = _ic(tmp_path / "ic.nc")
    out = tmp_path / "preds"
    rc = main(["forecast", "--model", "AuroraSmallPretrained", "--random-init", "--seed", "3",
               "--input", str(ic), "--steps", "2", "--output-dir", str(out), "--device", "cpu"])
    assert rc == 0
    _same_as_rollout(_built(small_facade, seed=3), ic, out, 2)

    # The forecast's float32 files: the two packages sum in float32 in their own orders, so
    # the scores agree to float32 rounding. Float64 copies of the same files: the same JSON.
    p0, p1 = str(out / "prediction-000.nc"), str(out / "prediction-001.nc")
    for i, p in enumerate((p0, p1)):
        Batch.from_netcdf(p).astype(torch.float64).to_netcdf(tmp_path / f"f64-{i}.nc")
    q0, q1 = str(tmp_path / "f64-0.nc"), str(tmp_path / "f64-1.nc")
    capsys.readouterr()
    for argv, exact in ((["--pred", p1, "--target", p0], False),
                        (["--pred", p0, p1, "--target", p1, p0], False),
                        (["--pred", q1, q0, "--target", q0, q1], True)):
        assert main(["evaluate", *argv, "--device", "cpu"]) == 0
        got = json.loads(capsys.readouterr().out)
        assert j_main(["evaluate", *argv]) == 0
        want = json.loads(capsys.readouterr().out)
        if exact:
            assert got == want
        else:
            _close_json(got, want)
    assert got[0]["scores"]["surf_vars"]["2t"]["rmse"] > 0
    assert len(got[0]["scores"]["atmos_vars"]["t"]["rmse"]) == len(LEVELS)


def _close_json(got, want):
    """The same files, pairs, variables and metrics, and each score within float32 rounding
    of the JAX package's: 1e-5 of the variable's mean absolute error (the size of the
    differences summed) plus the 6-decimal rounding's 1e-6."""
    got, want = (x if isinstance(x, list) else [x] for x in (got, want))
    assert [{k: v for k, v in g.items() if k != "scores"} for g in got] == \
        [{k: v for k, v in w.items() if k != "scores"} for w in want]
    for g, w in zip(got, want):
        assert list(g["scores"]) == list(w["scores"])
        for group, variables in w["scores"].items():
            assert list(g["scores"][group]) == list(variables)
            for var, ms in variables.items():
                assert list(g["scores"][group][var]) == list(ms)
                scale = np.abs(np.asarray(ms["mae"]))
                for k, v in ms.items():
                    err = np.abs(np.asarray(g["scores"][group][var][k]) - np.asarray(v))
                    assert np.all(err <= 1e-5 * scale + 1.5e-6), (group, var, k, err)


def test_forecast_loads_a_port_file_and_a_reference_checkpoint(small_facade, tmp_path):
    ic = _ic(tmp_path / "ic.nc")
    model = _built(small_facade, seed=5)
    open_gates(model)
    save_params(model, tmp_path / "params.pt")
    rc = main(["forecast", "--model", "AuroraSmallPretrained", "--checkpoint",
               str(tmp_path / "params.pt"), "--input", str(ic), "--steps", "1",
               "--output-dir", str(tmp_path / "a"), "--device", "cpu"])
    assert rc == 0
    _same_as_rollout(model, ic, tmp_path / "a", 1)

    # A reference-format file of a JAX tree of the same config, read through the converter.
    _, params, ported = seeded_matched_models(dict(SMALL))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                reference_state_dict(params).items()}, tmp_path / "ref.ckpt")
    rc = main(["forecast", "--model", "AuroraSmallPretrained", "--checkpoint",
               str(tmp_path / "ref.ckpt"), "--input", str(ic), "--steps", "1",
               "--output-dir", str(tmp_path / "b"), "--device", "cpu"])
    assert rc == 0
    want = small_facade(device="cpu", seed=None)
    want.load_state_dict({k: v.float() for k, v in ported.state_dict().items()})
    _same_as_rollout(want, ic, tmp_path / "b", 1)


def test_forecast_from_a_reference_checkpoint_is_the_jax_clis(small_facade, tmp_path):
    """One reference-format ``.ckpt`` (float32), ``forecast`` of both packages, 2 steps: the
    port's files hold the JAX package's within float32 rounding of two programs' summation
    orders (mean relative error <= 1e-5 per variable; a bf16 value or product anywhere gives
    1e-3 and more), the metadata equal."""
    ic = _ic(tmp_path / "ic.nc")
    _, params, _ = seeded_matched_models(dict(SMALL))
    torch.save({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in
                reference_state_dict(params).items()}, tmp_path / "ref.ckpt")
    argv = ["forecast", "--model", "AuroraSmallPretrained", "--checkpoint",
            str(tmp_path / "ref.ckpt"), "--input", str(ic), "--steps", "2"]
    assert main([*argv, "--output-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert j_main([*argv, "--output-dir", str(tmp_path / "jax")]) == 0
    for i in range(2):
        name = f"prediction-{i:03d}.nc"
        got, want = JBatch.from_netcdf(tmp_path / "port" / name), JBatch.from_netcdf(
            tmp_path / "jax" / name)
        assert got.metadata.rollout_step == want.metadata.rollout_step == i + 1
        assert tuple(got.metadata.time) == tuple(want.metadata.time)
        assert all(np.asarray(v).dtype == np.float32 for v in got.surf_vars.values())
        errs = batch_errors(got, want)
        assert max(errs.values()) <= 1e-5, (i, errs)


def test_forecast_tracks_the_predictions(small_facade, tmp_path):
    """At 1 degree (the ±5 degree search boxes hold whole minima); the track of the CLI's
    files is the tracker's on the roll-out's predictions, written as ``write_csv``."""
    ic = _ic(tmp_path / "ic.nc", H=181, W=360)
    out = tmp_path / "preds"
    rc = main(["forecast", "--model", "AuroraSmallPretrained", "--random-init", "--input",
               str(ic), "--steps", "2", "--output-dir", str(out), "--device", "cpu", "--track",
               "--init-lat", "25.0", "--init-lon", "130.0"])
    assert rc == 0
    preds = _same_as_rollout(_built(small_facade), ic, out, 2)
    tracker = Tracker(25.0, 130.0, Batch.from_netcdf(ic).metadata.time[0])
    for p in preds:
        tracker.step(p)
    tracker.write_csv(tmp_path / "want.csv")
    assert (out / "track.csv").read_text() == (tmp_path / "want.csv").read_text()
    assert len((out / "track.csv").read_text().splitlines()) == 4


def test_error_paths_exit_2(small_facade, tmp_path, capsys, monkeypatch):
    f = _ic(tmp_path / "x.nc", H=9, W=16)
    assert main(["evaluate", "--pred", str(f), str(f), "--target", str(f), "--device",
                 "cpu"]) == 2
    assert main(["forecast", "--model", "AuroraSmallPretrained", "--checkpoint",
                 str(tmp_path / "nope.ckpt"), "--input", str(f), "--output-dir",
                 str(tmp_path / "o"), "--device", "cpu"]) == 2
    assert "checkpoint not found" in capsys.readouterr().err
    assert main(["forecast", "--model", "NotAModel", "--random-init", "--input", str(f),
                 "--output-dir", str(tmp_path / "o"), "--device", "cpu"]) == 2
    assert main(["forecast", "--model", "AuroraSmallPretrained", "--random-init", "--input",
                 str(f), "--output-dir", str(tmp_path / "o"), "--device", "cpu",
                 "--track"]) == 2
    assert "--track requires" in capsys.readouterr().err
    # No card and no --device cpu: a message and code 2, never a quiet run on the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["forecast", "--model", "AuroraSmallPretrained", "--random-init", "--input",
                  str(f), "--output-dir", str(tmp_path / "o")],
                 ["evaluate", "--pred", str(f), "--target", str(f)]):
        assert main(argv) == 2
        assert "No CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()


def test_module_entry_point_without_a_card_exits_2(tmp_path):
    f = _ic(tmp_path / "x.nc", H=9, W=16)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "aurora_tpu_torch", "forecast", "--random-init",
                        "--input", str(f), "--output-dir", str(tmp_path / "o")],
                       capture_output=True, text=True, env=env, timeout=120,
                       cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 2, r.stderr
    assert "No CUDA device" in r.stderr


def _quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **kw)


def test_rollout_bench_tracks_on_the_cpu():
    model = port.Aurora(AuroraConfig(**SMALL, **PRODUCTION), device="cpu", seed=0)
    open_gates(model)
    out = _quiet(rollout_bench.main, ["--device", "cpu", "--H", "181", "--W", "360", "--steps",
                                      "2"], model=model)
    assert out["device"] == "cpu" and out["track_len"] == 3 and len(out["step_s"]) == 2
    assert out["steps_per_s"] > 0 and out["fails"] <= 2


def test_train_speed_probe_runs_its_arms_on_the_cpu():
    cfg = AuroraConfig(**SMALL, use_lora=True)
    out = _quiet(train_speed_probe.main, ["--device", "cpu", "--H", "17", "--W", "32",
                                          "--steps", "1", "--arms", "base,blocks_chunks,none"],
                 cfg=cfg)
    arms = {r["arm"]: r for r in out["arms"]}
    assert list(arms) == ["base", "blocks_chunks", "none"]
    assert arms["blocks_chunks"]["grad_chunk_mib"] == 4 * arms["base"]["grad_chunk_mib"]
    assert all(np.isfinite(r["loss_last"]) and r["s_per_step"] > 0 for r in arms.values())
    assert all(r["peak_gib"] is None for r in arms.values())  # no card: no peak to gate
    from aurora_tpu_torch.ops import ad

    assert ad.GRAD_CHUNK_BYTES == 512 << 20  # restored
