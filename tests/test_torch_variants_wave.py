"""The wave, 12 h, HighRes and small models of the port against ``aurora_tpu`` on the CPU, in
float64 at the variants' small architecture (``SMALL_ARCH``; the small model at its own
config), gates open, mean relative error <= 1e-8 per output variable.

* Wave: forward and a 2-step ``rollout``; the NaN masks of the outputs are equal, and the
  batch hook's masking and the decoder's density masking both engage. Its
  ``batch_transform_hook`` gives JAX's arrays on the same numpy batch, and is idempotent.
* 12 h: forward; the metadata advances by 12 hours.
* HighRes: forward at patch size 10 (a 21 x 40 batch crops to 20 x 40, 2 x 4 patches).
* Small (``AuroraSmallPretrained``, D = 256): forward on the CPU, where every kernel wrapper
  runs its plain version. The card's kernels refuse D = 256 (``tests/test_torch_variants.py``).
"""

import dataclasses
from datetime import timedelta

import numpy as np
import pytest
import torch

import aurora_tpu
import aurora_tpu_torch
from aurora_tpu_torch.batch import Batch, Metadata
from tests.conftest import make_batch
from tests.test_torch_support import (
    SMALL_ARCH,
    batch_errors,
    make_wave_batch,
    matched_variant,
    torch_batch,
)


@pytest.fixture(scope="module")
def wave():
    jm, params, tm = matched_variant(aurora_tpu.AuroraWave, aurora_tpu_torch.AuroraWave,
                                     **SMALL_ARCH, use_lora=False)
    return jm, params, tm, make_wave_batch()


def test_wave_forward_matches_f64_with_equal_nan_masks(wave):
    jm, params, tm, batch = wave
    hooked = jm.batch_transform_hook(batch)
    assert np.isnan(hooked.surf_vars["swh"]).any()  # the hook's masking engaged
    want, got = jm.forward(params, batch), tm(torch_batch(batch))
    errs = batch_errors(got, want)  # asserts equal NaN masks
    assert max(errs.values()) <= 1e-8, errs
    swh = got.surf_vars["swh"].numpy()
    assert np.isnan(swh).any() and not np.isnan(swh).all()  # the density mask engaged
    assert not any(k.endswith(("_sin", "_cos", "_density")) for k in got.surf_vars)
    assert {"mwd", "10u_wave", "10v_wave"} <= set(got.surf_vars) and "dwi" not in got.surf_vars


def test_wave_rollout_matches_f64(wave):
    from aurora_tpu.rollout import rollout as j_rollout
    from aurora_tpu_torch import rollout as t_rollout

    jm, params, tm, batch = wave
    want = list(j_rollout(jm, params, batch, steps=2))
    got = list(t_rollout(tm, torch_batch(batch), steps=2))
    assert len(got) == 2
    for step, (g, w) in enumerate(zip(got, want)):
        errs = batch_errors(g, w)
        assert max(errs.values()) <= 1e-8, (step, errs)


def _port_numpy_batch(b) -> Batch:
    md = b.metadata
    return Batch(surf_vars=dict(b.surf_vars), static_vars=dict(b.static_vars),
                 atmos_vars=dict(b.atmos_vars),
                 metadata=Metadata(lat=md.lat, lon=md.lon, time=md.time,
                                   atmos_levels=md.atmos_levels, rollout_step=md.rollout_step))


def _assert_same_arrays(got: dict, want: dict):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and np.array_equal(g, w, equal_nan=True), k


def test_wave_batch_hook_matches_jax_and_is_idempotent(wave):
    jm, _, tm, batch = wave
    want = jm.batch_transform_hook(batch)
    got = tm.batch_transform_hook(_port_numpy_batch(batch))
    _assert_same_arrays(got.surf_vars, want.surf_vars)
    _assert_same_arrays(tm.batch_transform_hook(got).surf_vars, got.surf_vars)
    # Past the first step the masking is left alone, as in JAX.
    later = dataclasses.replace(batch, metadata=dataclasses.replace(batch.metadata,
                                                                    rollout_step=1))
    _assert_same_arrays(tm.batch_transform_hook(_port_numpy_batch(later)).surf_vars,
                        jm.batch_transform_hook(later).surf_vars)


@pytest.mark.parametrize("name, batch_kw", [
    ("Aurora12hPretrained", dict()),
    ("AuroraHighRes", dict(H=21, W=40)),
])
def test_forward_matches_f64(name, batch_kw):
    jm, params, tm = matched_variant(getattr(aurora_tpu, name), getattr(aurora_tpu_torch, name),
                                     **SMALL_ARCH, use_lora=False)
    batch = make_batch(**batch_kw)
    want, got = jm.forward(params, batch), tm(torch_batch(batch))
    errs = batch_errors(got, want)
    assert max(errs.values()) <= 1e-8, errs
    assert got.metadata.time[0] - batch.metadata.time[0] == timedelta(hours=tm.cfg.timestep_hours)
    H, W = batch.crop(tm.cfg.patch_size).spatial_shape
    assert tuple(got.surf_vars["2t"].shape) == (1, 1, H, W)


def test_small_pretrained_forward_matches_f64_on_the_cpu():
    jm, params, tm = matched_variant(aurora_tpu.AuroraSmallPretrained,
                                     aurora_tpu_torch.AuroraSmallPretrained)
    assert tm.cfg.embed_dim == 256 and tm.device.type == "cpu"
    batch = make_batch()
    errs = batch_errors(tm(torch_batch(batch)), jm.forward(params, batch))
    assert max(errs.values()) <= 1e-8, errs
    assert isinstance(tm, torch.nn.Module)
