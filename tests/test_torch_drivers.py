"""The port's data plane and post-processing on the CPU against the JAX package: netCDF files,
regridding, the verification metrics, the cyclone tracker, the quick-look map and the
roofline table.

* A netCDF file written by either package is read by the other with equal arrays and
  metadata (float32 and float64 variables, vector and matrix grids).
* Regridding, the native kernel and the scipy form each, equals
  ``aurora_tpu.batch.interpolate_numpy`` (<= 1e-12) on a pole-containing grid, once
  downsampling and once upsampling onto the poles (latitude extrapolated); ``Batch.regrid``
  returns the JAX package's float32 fields as tensors.
* The metrics and ``evaluate`` equal ``aurora_tpu.metrics`` (<= 1e-12 in float64), with the
  same errors for another grid, a missing variable and a shape mismatch.
* The tracker on ``tests/test_tracker.py``'s moving and seam-crossing storms: the JAX track
  exactly, and ``write_csv`` the text of JAX's ``results().to_csv(index=False)``.
* ``quicklook`` under a stand-in ``matplotlib.pyplot`` draws the field JAX's draws;
  ``roofline`` knows the H100 and refuses other names.
"""

import sys
import types
from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

from aurora_tpu import Batch as JBatch
from aurora_tpu import metrics as j_metrics
from aurora_tpu import plot as j_plot
from aurora_tpu.batch import interpolate_numpy as j_interpolate
from aurora_tpu.tracker import Tracker as JTracker
from aurora_tpu_torch import metrics, native, plot
from aurora_tpu_torch.batch import Batch, interpolate_numpy, interpolate_scipy
from aurora_tpu_torch.tracker import Tracker
from aurora_tpu_torch.utils import profiling
from tests.conftest import make_batch
from tests.test_torch_support import torch_batch
from tests.test_tracker import _storm_batch


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, the caller's count restored after (the suite runs six workers
    at once; see ``tests/test_torch_training.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_same_batch(a, b):
    """Equal variable names, arrays (dtype and bits) and metadata."""
    for group in ("surf_vars", "static_vars", "atmos_vars"):
        ga, gb = getattr(a, group), getattr(b, group)
        assert list(ga) == list(gb), group
        for k in ga:
            x, y = _np(ga[k]), _np(gb[k])
            assert x.dtype == y.dtype and x.shape == y.shape, (group, k)
            np.testing.assert_array_equal(x, y)
    ma, mb = a.metadata, b.metadata
    np.testing.assert_array_equal(_np(ma.lat), _np(mb.lat))
    np.testing.assert_array_equal(_np(ma.lon), _np(mb.lon))
    assert tuple(ma.time) == tuple(mb.time)
    assert tuple(ma.atmos_levels) == tuple(mb.atmos_levels)
    assert ma.rollout_step == mb.rollout_step


@pytest.mark.parametrize("dtype,matrix", [(np.float32, False), (np.float64, True)])
def test_netcdf_files_cross_between_the_packages(tmp_path, dtype, matrix):
    jb = make_batch(H=9, W=16, dtype=dtype, matrix_grid=matrix)
    jb.metadata.rollout_step = 3
    jb.to_netcdf(tmp_path / "jax.nc")
    assert_same_batch(Batch.from_netcdf(tmp_path / "jax.nc"), jb)

    pb = torch_batch(make_batch(H=9, W=16, dtype=dtype, matrix_grid=matrix, seed=1))
    pb.metadata.time = (datetime(2021, 3, 4, 5, 6, 7),)
    pb.to_netcdf(tmp_path / "port.nc")
    assert_same_batch(JBatch.from_netcdf(tmp_path / "port.nc"), pb)
    assert_same_batch(Batch.from_netcdf(tmp_path / "port.nc"), pb)


def _regrid_case(down: bool):
    rng = np.random.default_rng(0 if down else 1)
    if down:  # 2 degrees with both poles onto 10 degrees
        lat, lon = np.linspace(90, -90, 91), np.linspace(0, 360, 180, endpoint=False)
        lat_new, lon_new = np.linspace(90, -90, 19), np.linspace(0, 360, 36, endpoint=False)
    else:  # 10 degrees without the poles onto 2.5 degrees with them: extrapolated
        lat, lon = np.linspace(85, -85, 18), np.linspace(5, 355, 36)
        lat_new, lon_new = np.linspace(90, -90, 73), np.linspace(0, 360, 144, endpoint=False)
    v = rng.standard_normal((2, 3, lat.size, lon.size))
    return v, lat, lon, lat_new, lon_new


@pytest.mark.parametrize("down", [True, False])
def test_regrid_native_and_scipy_equal_jax(down):
    args = _regrid_case(down)
    want = j_interpolate(*args)
    assert native.available()  # g++ builds it here; the card's machine asserts the same
    got_native = native.regrid_bilinear(*args)
    for got in (got_native, interpolate_scipy(*args), interpolate_numpy(*args)):
        assert got.shape == want.shape == (2, 3, args[3].size, args[4].size)
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_batch_regrid_equals_jax():
    jb = make_batch(H=17, W=32, dtype=np.float32)
    want = jb.regrid(10.0)
    got = torch_batch(jb).regrid(10.0)
    for group in ("surf_vars", "static_vars", "atmos_vars"):
        for k, v in getattr(want, group).items():
            g = getattr(got, group)[k]
            assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
            assert g.device.type == "cpu"
            w = np.asarray(v)
            assert np.abs(g.numpy() - w).max() <= 1e-6 * np.abs(w).max(), (group, k)
    np.testing.assert_array_equal(got.metadata.lat, np.asarray(want.metadata.lat))
    np.testing.assert_array_equal(got.metadata.lon, np.asarray(want.metadata.lon))


def _close(got, want, tol=1e-12):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("matrix", [False, True])
def test_metrics_equal_jax(matrix):
    rng = np.random.default_rng(2)
    lat = np.linspace(90, -90, 19)
    if matrix:
        lat = np.broadcast_to(lat[:, None], (19, 24)).copy()
    pred, target, clim = (rng.standard_normal((2, 3, 19, 24)) for _ in range(3))
    _close(metrics.latitude_weights(lat, torch.float64),
           j_metrics.latitude_weights(lat, np.float64))
    for name in ("rmse", "mae", "bias"):
        _close(getattr(metrics, name)(torch.from_numpy(pred), torch.from_numpy(target), lat),
               getattr(j_metrics, name)(pred, target, lat))
    _close(metrics.acc(torch.from_numpy(pred), target, clim[0, 0], lat),
           j_metrics.acc(pred, target, clim[0, 0], lat))
    with pytest.raises(ValueError):
        metrics.latitude_weights(np.zeros((2, 3, 4)))


def test_evaluate_equals_jax_and_raises_as_it_does():
    jp, jt = make_batch(seed=0), make_batch(seed=1)
    jc = make_batch(T=1, seed=2)
    want = j_metrics.evaluate(jp, jt, climatology=jc)
    got = metrics.evaluate(torch_batch(jp), torch_batch(jt), climatology=torch_batch(jc))
    assert list(got) == list(want)
    for group in want:
        assert list(got[group]) == list(want[group])
        for var, ms in want[group].items():
            assert list(got[group][var]) == list(ms) == ["rmse", "mae", "bias", "acc"]
            for k, v in ms.items():
                _close(got[group][var][k], v)
    assert tuple(got["atmos_vars"]["t"]["rmse"].shape) == (1, 2, 4)

    def both_raise(exc, match, p, t, c=None):
        with pytest.raises(exc, match=match):
            j_metrics.evaluate(p, t, climatology=c)
        with pytest.raises(exc, match=match):
            metrics.evaluate(torch_batch(p), torch_batch(t),
                             climatology=None if c is None else torch_batch(c))

    shifted = make_batch(seed=1)
    shifted.metadata.lon = shifted.metadata.lon + 0.5
    both_raise(ValueError, "different grid", jp, shifted)
    missing = make_batch(seed=1, surf_vars=("2t", "10u", "10v"))
    both_raise(KeyError, "target batch is missing", jp, missing)
    both_raise(KeyError, "climatology batch is missing", jp, jt,
               make_batch(T=1, surf_vars=("2t",), seed=2))
    both_raise(ValueError, "shape mismatch", jp, make_batch(T=1, seed=1))


def _track(tracker_cls, batch_fn, init, moves):
    t0 = datetime(2020, 9, 1)
    tracker = tracker_cls(init_lat=init[0], init_lon=init[1], init_time=t0)
    for i in range(1, moves + 1):
        tracker.step(batch_fn(i, t0 + i * timedelta(hours=6)))
    return tracker


STORMS = {  # name: (first fix, the eye at step i, steps)
    "moving": ((20.0, 200.0), lambda i: (20.0 + i, 200.0 - i), 5),
    "seam": ((15.0, 359.0), lambda i: (15.0, (359.0 + i) % 360), 3),
}


@pytest.mark.parametrize("storm", list(STORMS))
def test_tracker_equals_jax_and_writes_its_csv(storm, tmp_path):
    init, eye, moves = STORMS[storm]

    def jax_batch(i, t):
        return _storm_batch(*eye(i), t)

    j = _track(JTracker, jax_batch, init, moves)
    p = _track(Tracker, lambda i, t: torch_batch(jax_batch(i, t)), init, moves)
    assert p.fails == j.fails == 0
    df, got = j.results(), p.results()
    assert list(got) == list(df.columns)
    assert got["time"] == list(df["time"].dt.to_pydatetime())
    for col in ("lat", "lon", "msl", "wind"):
        np.testing.assert_array_equal(np.asarray(got[col], np.float64), df[col].to_numpy())
    df.to_csv(tmp_path / "jax.csv", index=False)
    p.write_csv(tmp_path / "port.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_quicklook_draws_the_field_jax_draws(monkeypatch):
    drawn = []

    class Ax:
        def imshow(self, field, **kw):
            drawn.append((np.array(field), kw))
            return "image"

        def __getattr__(self, name):  # set_title, set_xlabel, set_ylabel
            return lambda *a, **k: None

    pyplot = types.SimpleNamespace(subplots=lambda **kw: (None, Ax()),
                                   colorbar=lambda *a, **k: None)
    monkeypatch.setitem(sys.modules, "matplotlib", types.SimpleNamespace(pyplot=pyplot))
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", pyplot)
    jb = make_batch(dtype=np.float32)
    for var, level in (("2t", None), ("t", 500)):
        j_plot.quicklook(jb, var, level, cmap="viridis")
        plot.quicklook(torch_batch(jb), var, level, cmap="viridis")
        (want, kw_want), (got, kw_got) = drawn[-2:]
        np.testing.assert_array_equal(got, want)
        assert kw_got == kw_want


def test_profiling(tmp_path):
    r = profiling.roofline(989e12, 3.35e9, "NVIDIA H100 80GB HBM3")
    assert r["compute_s"] == pytest.approx(1.0) and r["memory_s"] == pytest.approx(1e-3)
    assert r["bound"] == "compute" and r["floor_s"] == r["compute_s"]
    for name in ("TPU v5 lite", "NVIDIA A100-SXM4-80GB", "cpu"):
        with pytest.raises(ValueError):
            profiling.roofline(1.0, 1.0, name)
    held = []
    with profiling.timed("block", held):
        torch.ones(4).sum()
    assert len(held) == 1 and held[0] >= 0
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(8) @ torch.ones(8)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
