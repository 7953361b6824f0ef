"""The released variants of the port against ``aurora_tpu`` on the CPU: the facades' configs
and checkpoint identities, and the air-pollution model.

* Each facade's ``default_config`` equals the JAX facade's field by field (the port has every
  field but the TPU's ``agg_chunk_size``), with the derived variable sets, the checkpoint
  repository, name and revision.
* AirPollution in float64 at the variants' small architecture (``SMALL_ARCH``), gates open,
  against the JAX model holding the same weights: forward and a 2-step ``rollout`` at mean
  relative error <= 1e-8 per output variable, without LoRA and with it (the SO2 clamp at
  850 hPa, which this batch reaches). Its dynamic time encodings are equal.
* The kernels on the small model's paths (K2, K3, K4, and K5 on route X) take its D = 256
  shapes; the probe kernel whose shape rule was not widened (K11) refuses D = 256, and every
  kernel refuses a width between those taken (``ValueError``). On the CPU the small model runs the
  plain versions (``tests/test_torch_variants_wave.py``); its launches per step are in
  ``tests/test_torch_small.py``.

The wave, 12 h and HighRes models are in ``tests/test_torch_variants_wave.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import aurora_tpu
import aurora_tpu_torch
from tests.test_torch_support import (
    SMALL_ARCH,
    VARIANT_LEVELS,
    batch_errors,
    make_pollution_batch,
    matched_variant,
    torch_batch,
)

FACADES = ("Aurora", "AuroraPretrained", "AuroraSmallPretrained", "AuroraSmall",
           "Aurora12hPretrained", "AuroraHighRes", "AuroraAirPollution", "AuroraWave")
DERIVED = ("timestep", "decoder_embed_dim", "dynamic_var_names", "all_static_vars",
           "all_surf_vars", "all_atmos_vars")


@pytest.mark.parametrize("name", FACADES)
def test_default_config_and_checkpoint_match_jax(name):
    jcls, tcls = getattr(aurora_tpu, name), getattr(aurora_tpu_torch, name)
    jcfg, tcfg = jcls.default_config(), tcls.default_config()
    jfields = {f.name for f in dataclasses.fields(jcfg)}
    tfields = {f.name for f in dataclasses.fields(tcfg)}
    assert jfields - tfields == {"agg_chunk_size"} and tfields <= jfields
    for f in sorted(tfields):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    for prop in DERIVED:
        assert getattr(tcfg, prop) == getattr(jcfg, prop), prop
    for attr in ("default_checkpoint_repo", "default_checkpoint_name",
                 "default_checkpoint_revision"):
        assert getattr(tcls, attr) == getattr(jcls, attr), attr


POLLUTION = dict(SMALL_ARCH, level_condition=tuple(int(x) for x in VARIANT_LEVELS))


@pytest.fixture(scope="module")
def pollution():
    jm, params, tm = matched_variant(aurora_tpu.AuroraAirPollution,
                                     aurora_tpu_torch.AuroraAirPollution,
                                     **POLLUTION, use_lora=False)
    return jm, params, tm, make_pollution_batch()


def test_air_pollution_forward_matches_f64(pollution):
    jm, params, tm, batch = pollution
    want, got = jm.forward(params, batch), tm(torch_batch(batch))
    errs = batch_errors(got, want)
    assert max(errs.values()) <= 1e-8, errs
    assert set(got.surf_vars) == set(jm.cfg.surf_vars)  # no _mod head left
    assert got.metadata.time[0] - batch.metadata.time[0] == jm.cfg.timestep


def test_air_pollution_rollout_matches_f64(pollution):
    from aurora_tpu.rollout import rollout as j_rollout
    from aurora_tpu_torch import rollout as t_rollout

    jm, params, tm, batch = pollution
    want = list(j_rollout(jm, params, batch, steps=2))
    got = list(t_rollout(tm, torch_batch(batch), steps=2))
    assert len(got) == 2
    for step, (g, w) in enumerate(zip(got, want)):
        errs = batch_errors(g, w)
        assert max(errs.values()) <= 1e-8, (step, errs)


def test_air_pollution_lora_so2_clamp_matches_f64():
    """With LoRA on, SO2 is clamped to 1 (normalised) at 850 hPa and more: the clamp is
    reached on this batch, and the port agrees with the JAX model."""
    from aurora_tpu_torch.normalisation import atmos_stats

    jm, params, tm = matched_variant(
        aurora_tpu.AuroraAirPollution, aurora_tpu_torch.AuroraAirPollution,
        **POLLUTION, use_lora=True, lora_mode="all", lora_steps=2)
    batch = make_pollution_batch()
    want, got = jm.forward(params, batch), tm(torch_batch(batch))
    errs = batch_errors(got, want)
    assert max(errs.values()) <= 1e-8, errs
    loc, scale = atmos_stats("so2", VARIANT_LEVELS)
    so2 = (got.atmos_vars["so2"][0, 0].numpy() - loc[:, None, None]) / scale[:, None, None]
    assert np.isclose(so2[3].max(), 1.0) and np.sum(np.isclose(so2[3], 1.0)) > 1
    assert so2[2].max() > 1.5  # 500 hPa is not clamped


def test_dynamic_encodings_match_jax(pollution):
    """The time-of-day, -week and -year features of ``prepare_encodings``, with the other
    encodings, for two batch elements on different days."""
    jm, _, tm, batch = pollution
    from datetime import datetime

    md = dataclasses.replace(batch.metadata, time=(datetime(2021, 3, 7, 18),
                                                   datetime(2022, 11, 30, 6)))
    batch = dataclasses.replace(batch, metadata=md)
    want = jm.prepare_encodings(batch.crop(jm.cfg.patch_size), dtype=jax.numpy.float64)
    got = tm.prepare_encodings(torch_batch(batch).crop(jm.cfg.patch_size), torch.float64)
    assert got.dynamic_scalars.shape == (2, 6)
    for f in dataclasses.fields(got):
        assert np.array_equal(getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))), f


def test_kernels_refuse_the_small_models_width():
    """D = 256 reaches the perceiver core's output, the MLP kernels and the window attention.
    K2, K3 and K4 (and K6 and K8, which share their shape rules) and K5 (route X's tail) take
    the small model's shapes; K11, a probe, still refuses D = 256; a width between those taken
    (384) is refused by every rule, so nothing falls back to a plain version on the card."""
    from aurora_tpu_torch.ops import mlp, probes, resampler, window_attention

    D = aurora_tpu_torch.SMALL_CONFIG.embed_dim
    assert D == 256
    ws = (2, 6, 12)
    resampler.check_perceiver_shape(13, 64800, D, 8, 32, 3, D)
    mlp.check_mlp_shape(259200, D, 4 * D)
    assert window_attention.check_window_attention_shape((1, 4, 180, 360, D), 4, ws) == (
        1, 1800, 259200)
    mlp.check_linear_shape(259200, D)
    with pytest.raises(ValueError, match="D=384"):
        mlp.check_linear_shape(259200, 384)
    with pytest.raises(ValueError, match="D=256"):
        window_attention.check_window_attention_shape((1, 4, 180, 360, D), 4, ws,
                                                      probes.ATTN5D_D)
    with pytest.raises(ValueError, match="D_out=384"):
        resampler.check_perceiver_shape(13, 64800, D, 8, 32, 3, 384)
    with pytest.raises(ValueError, match="D=384"):
        mlp.check_mlp_shape(259200, 384, 1536)
    with pytest.raises(ValueError, match="D=384"):
        window_attention.check_window_attention_shape((1, 4, 180, 360, 384), 6, ws)


def test_variant_tools_run_on_the_cpu():
    """``tools.variant_bench`` and ``tools.highres_bench`` as a user runs them, on the CPU
    with small models: one row per variant, the roll-out's steps, and the predictions hold
    the user's variables after the hooks."""
    from aurora_tpu_torch.tools import highres_bench, perf_breakdown, variant_bench

    def small(cls):
        cfg = perf_breakdown.production_config(cls.default_config().replace(**SMALL_ARCH))
        return aurora_tpu_torch.cast_backbone_params(cls(cfg, device="cpu"))

    models = {"pollution": small(aurora_tpu_torch.AuroraAirPollution),
              "wave": small(aurora_tpu_torch.AuroraWave)}
    rows = variant_bench.main(["--device", "cpu", "--H", "25", "--W", "48", "--steps", "2"],
                              models=models)
    rows += highres_bench.main(["--device", "cpu", "--H", "41", "--W", "80", "--steps", "2"],
                               model=small(aurora_tpu_torch.AuroraHighRes))
    assert [r["label"] for r in rows] == ["air_pollution_0.4deg", "wave_0.25deg",
                                          "highres_0.1deg"]
    for r, cfg in zip(rows, [m.cfg for m in models.values()] + [None]):
        assert r["device"] == "cpu" and len(r["step_s"]) == 2 and r["rollout_step"] == 2
        assert not any(k.endswith(("_mod", "_sin", "_cos", "_density")) for k in r["outputs"])
        assert not any(r["inf_points"].values())
        if cfg is not None and cfg.variant == "wave":
            assert {"mwd", "10u_wave"} <= set(r["outputs"])
            assert r["outputs"]["swh"] == [1, 1, 24, 48]
            assert set(k for k, n in r["nan_points"].items() if n) <= set(
                cfg.density_channel_surf_vars)
        else:
            assert not any(r["nan_points"].values())
    assert rows[2]["outputs"]["z"] == [1, 1, 13, 40, 80] and rows[2]["patch_size"] == 10

