"""``rollout_scan``, the roll-out that stays on the device, and the port's benchmark entry
(``aurora_tpu_torch/rollout.py``, ``aurora_tpu_torch/tools/bench.py``) on the CPU.

* float64, gates open, 3 steps: the port's ``rollout_scan`` against
  ``aurora_tpu.rollout.rollout_scan`` with ``host_offload`` False and True, at mean relative
  error <= 1e-8 on every variable and step, with the same ``time``, ``rollout_step`` and
  static fields: on the plain small model, and on the air-pollution model with per-step LoRA
  (its hooks, dynamic time features and SO2 clamp inside the roll-out).
* The port's ``rollout_scan`` equals the port's ``rollout`` bit for bit at both settings.
* ``rollout`` reads the caller's history once, before its first step.
* ``prepare_encodings``'s grid constants come from one device copy on the model, bit for bit
  equal to the host float64 arithmetic rounded once, for two grids in turn and after
  ``model.to`` another dtype; the copy is not in the ``state_dict``.
* Neither roll-out writes to the caller's arrays.
* ``Batch.astype``, ``to_numpy`` and ``replace`` against the JAX ``Batch``'s.
* ``python -m aurora_tpu_torch.tools.bench --device cpu`` at a tiny grid and config runs
  every roll-out and labels its numbers ``cpu``; the idle share's interval union.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aurora_tpu
import aurora_tpu_torch
from aurora_tpu.rollout import rollout_scan as j_rollout_scan
from aurora_tpu_torch import rollout, rollout_scan
from tests.conftest import make_batch
from tests.test_torch_support import (
    SMALL_ARCH,
    VARIANT_LEVELS,
    batch_errors,
    make_pollution_batch,
    matched_models,
    matched_variant,
    torch_batch,
)

CFG = dict(
    embed_dim=64, num_heads=4, encoder_depths=(2, 2, 2), decoder_depths=(2, 2, 2),
    encoder_num_heads=(2, 4, 8), decoder_num_heads=(8, 4, 2), use_lora=True,
)
LEVELS = (100, 250, 500, 850)
STEPS = 3
OFFLOAD = [False, True]
OFFLOAD_IDS = ["on_device", "host_offload"]


@pytest.fixture(scope="module")
def plain():
    jm, params, tm = matched_models(CFG)
    return jm, params, tm, make_batch(levels=LEVELS)


@pytest.fixture(scope="module")
def pollution():
    """Per-step LoRA (a bank of 3, one per step) and the SO2 clamp: the step index reaches
    the model inside the roll-out."""
    jm, params, tm = matched_variant(
        aurora_tpu.AuroraAirPollution, aurora_tpu_torch.AuroraAirPollution,
        **SMALL_ARCH, level_condition=tuple(int(x) for x in VARIANT_LEVELS),
        use_lora=True, lora_mode="all", lora_steps=STEPS)
    return jm, params, tm, make_pollution_batch()


def _as_numpy(v) -> np.ndarray:
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _check_against_jax(got, want):
    assert len(got) == len(want) == STEPS
    for step, (g, w) in enumerate(zip(got, want)):
        errs = batch_errors(g, w)
        assert max(errs.values()) <= 1e-8, (step, errs)
        assert g.metadata.time == w.metadata.time, step
        assert g.metadata.rollout_step == w.metadata.rollout_step == step + 1
        assert set(g.static_vars) == set(w.static_vars)
        for k, v in w.static_vars.items():
            assert np.array_equal(_as_numpy(g.static_vars[k]), np.asarray(v)), k


@pytest.mark.parametrize("host_offload", OFFLOAD, ids=OFFLOAD_IDS)
def test_rollout_scan_matches_jax_f64(plain, host_offload):
    jm, params, tm, jb = plain
    want = j_rollout_scan(jm, params, jb, STEPS, host_offload=host_offload)
    got = rollout_scan(tm, torch_batch(jb), STEPS, host_offload=host_offload)
    _check_against_jax(got, want)
    kind = np.ndarray if host_offload else torch.Tensor
    assert all(isinstance(v, kind) for p in got for v in (*p.surf_vars.values(),
                                                          *p.atmos_vars.values()))


@pytest.mark.parametrize("host_offload", OFFLOAD, ids=OFFLOAD_IDS)
def test_variant_rollout_scan_matches_jax_f64(pollution, host_offload):
    jm, params, tm, jb = pollution
    want = j_rollout_scan(jm, params, jb, STEPS, host_offload=host_offload)
    got = rollout_scan(tm, torch_batch(jb), STEPS, host_offload=host_offload)
    _check_against_jax(got, want)
    assert set(got[0].surf_vars) == set(jm.cfg.surf_vars)  # the hooks ran: no _mod head


@pytest.mark.parametrize("host_offload", OFFLOAD, ids=OFFLOAD_IDS)
def test_rollout_scan_equals_rollout_bit_for_bit(plain, pollution, host_offload):
    for _, _, tm, jb in (plain, pollution):
        loop = list(rollout(tm, torch_batch(jb), STEPS))
        scan = rollout_scan(tm, torch_batch(jb), STEPS, host_offload=host_offload)
        for step, (s, l) in enumerate(zip(scan, loop)):
            for group in ("surf_vars", "atmos_vars"):
                a, b = getattr(s, group), getattr(l, group)
                assert list(a) == list(b), (step, group)
                for k in b:
                    assert np.array_equal(_as_numpy(a[k]), b[k].numpy(), equal_nan=True), (
                        step, k)
            a, b = s.metadata, l.metadata
            assert (a.time, a.rollout_step, a.atmos_levels) == (
                b.time, b.rollout_step, b.atmos_levels), step
            assert np.array_equal(a.lat, b.lat) and np.array_equal(a.lon, b.lon), step


def test_rollout_reads_the_callers_history_once(plain):
    """The caller's history is uploaded before the first step and never read again: NaN
    written into it after the first prediction leaves every later step as it was. (A
    float32 batch for the float64 model, so the upload is a copy on the CPU too.)"""
    _, _, tm, jb = plain

    def f32_batch():
        b = torch_batch(jb)
        return dataclasses.replace(
            b, surf_vars={k: v.float().numpy() for k, v in b.surf_vars.items()},
            atmos_vars={k: v.float().numpy() for k, v in b.atmos_vars.items()})

    want = list(rollout(tm, f32_batch(), STEPS))
    batch = f32_batch()
    got = []
    for pred in rollout(tm, batch, STEPS):
        got.append(pred)
        for v in (*batch.surf_vars.values(), *batch.atmos_vars.values()):
            v[...] = np.nan
    for step, (g, w) in enumerate(zip(got, want)):
        for k in w.atmos_vars:
            assert torch.equal(g.atmos_vars[k], w.atmos_vars[k]), (step, k)
        for k in w.surf_vars:
            assert torch.equal(g.surf_vars[k], w.surf_vars[k]), (step, k)


@pytest.mark.parametrize("form", ["tensors", "numpy"])
def test_the_callers_arrays_are_not_written(plain, form):
    """Both roll-outs at both settings leave the caller's arrays as they were, whether
    float64 tensors the float64 model could alias or NumPy arrays."""
    _, _, tm, jb = plain
    batch = torch_batch(jb)
    if form == "numpy":
        batch = batch.to_numpy()
    before = {(g, k): np.array(_as_numpy(v)) for g in ("surf_vars", "static_vars", "atmos_vars")
              for k, v in getattr(batch, g).items()}
    list(rollout(tm, batch, STEPS))
    for host_offload in OFFLOAD:
        rollout_scan(tm, batch, STEPS, host_offload=host_offload)
    for (g, k), v in before.items():
        assert np.array_equal(_as_numpy(getattr(batch, g)[k]), v), (g, k)


def _uncached_grid_encodings(cfg, lat, lon, levels, dtype):
    """The grid's constants straight from the host float64 arithmetic, rounded once."""
    from aurora_tpu_torch.fourier import lead_time_expansion, levels_expansion
    from aurora_tpu_torch.posencoding import pos_scale_enc

    lat, lon = np.asarray(lat, np.float64), np.asarray(lon, np.float64)
    pos, scale = pos_scale_enc(cfg.embed_dim, lat, lon, cfg.patch_size)
    lv = np.asarray(levels, np.float64)
    host = dict(pos=pos, scale=scale, levels=levels_expansion(lv, cfg.embed_dim),
                levels_dec=levels_expansion(lv, cfg.decoder_embed_dim),
                lead_time=lead_time_expansion(np.array(cfg.timestep_hours, np.float64),
                                              cfg.embed_dim))
    return {k: torch.from_numpy(np.asarray(v)).to(dtype) for k, v in host.items()}


def test_cached_grid_encodings_equal_the_uncached_arithmetic():
    from aurora_tpu_torch import Aurora
    from aurora_tpu_torch.model.config import AuroraConfig

    model = Aurora(AuroraConfig(**CFG), device="cpu", dtype=torch.float64)
    first = torch_batch(make_batch(levels=LEVELS)).crop(4)
    second = torch_batch(make_batch(H=25, W=48, levels=(50, 500))).crop(4)
    for dtype, batch in ((torch.float64, first), (torch.float64, second),
                         (torch.float64, first), (torch.float32, second)):
        if dtype != model.compute_dtype:
            model.to(dtype)
            assert model._grid_encodings is None  # model.to drops the old copy
        enc = model.prepare_encodings(batch, dtype)
        md = batch.metadata
        want = _uncached_grid_encodings(model.cfg, md.lat, md.lon, md.atmos_levels, dtype)
        for k, v in want.items():
            got = getattr(enc, k)
            assert got.dtype == dtype and torch.equal(got, v), (k, dtype, batch.spatial_shape)
        again = model.prepare_encodings(batch, dtype)
        assert all(getattr(again, k) is getattr(enc, k) for k in want)  # one copy, reused
        absolute_time, _ = model.step_encodings(md.time, dtype)
        assert torch.equal(enc.absolute_time, absolute_time)
    assert not any("grid" in k for k in model.state_dict())


def test_batch_helpers_match_jax(plain):
    _, _, _, jb = plain
    tb = torch_batch(jb)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        want, got = jb.astype(jdt), tb.astype(tdt)
        for g in ("surf_vars", "static_vars", "atmos_vars"):
            for k, w in getattr(want, g).items():
                v = getattr(got, g)[k]
                assert v.dtype == tdt and np.array_equal(v.numpy(), np.asarray(w)), (g, k)
        for f in ("lat", "lon"):
            w, v = np.asarray(getattr(want.metadata, f)), getattr(got.metadata, f)
            assert isinstance(v, np.ndarray) and v.dtype == w.dtype, (f, v.dtype, w.dtype)
            assert np.array_equal(v, w), f
        assert got.metadata.time == want.metadata.time
    bf = tb.astype(torch.bfloat16)
    assert bf.surf_vars["2t"].dtype == torch.bfloat16 and bf.metadata.lat.dtype == np.float32
    want, got = jb.to_numpy(), tb.to_numpy()
    for g in ("surf_vars", "static_vars", "atmos_vars"):
        for k, w in getattr(want, g).items():
            v = getattr(got, g)[k]
            assert isinstance(v, np.ndarray) and np.array_equal(v, w), (g, k)
    got = tb.replace(surf_vars={"2t": tb.surf_vars["2t"]})
    want = jb.replace(surf_vars={"2t": jb.surf_vars["2t"]})
    assert set(got.surf_vars) == set(want.surf_vars) == {"2t"}
    assert got.atmos_vars is tb.atmos_vars and want.atmos_vars is jb.atmos_vars
    assert set(tb.surf_vars) == set(jb.surf_vars) == {"2t", "10u", "10v", "msl"}


def test_bench_runs_on_the_cpu(capsys):
    """Every roll-out through the bench at a tiny grid and config: each line says ``cpu``,
    no device metric is printed, and the three roll-outs agree."""
    from aurora_tpu_torch.model.config import AuroraConfig
    from aurora_tpu_torch.tools import bench
    from aurora_tpu_torch.tools.perf_breakdown import build_model, production_config

    cfg = production_config(AuroraConfig(**dict(CFG, encoder_depths=(1, 1, 1),
                                                decoder_depths=(1, 1, 1))))
    model = build_model(cfg, "cpu")
    rows = {}
    for kind in bench.ROLLOUTS:
        rows[kind] = bench.main(["--device", "cpu", "--rollout", kind, "--steps", "3",
                                 "--H", "17", "--W", "32"], model=model)
        last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert last == json.loads(json.dumps(rows[kind]))
    for kind, r in rows.items():
        assert r["device"] == "cpu" and r["card"] == "cpu" and r["rollout"] == kind
        assert r["grid"] == "16x32" and len(r["step_s"]) == 3 and r["steady_from_step"] == 2
        assert r["steady_step_s"] == float(np.median(r["step_s"][1:])) > 0
        assert r["rollout_steps_per_s"] > 0
        assert r["grid_points_per_s"] == pytest.approx(16 * 32 * r["rollout_steps_per_s"])
        assert r["peak_mem_gib"] is None and r["build_s"] is None
        assert not [k for k in r if k.startswith("idle_share")]
    batch = bench.build("main", torch.device("cpu"), 17, 32, model)[1]
    preds = {kind: bench.timed(model, batch, kind, 2)[1] for kind in bench.ROLLOUTS}
    for kind in ("scan", "scan_offload"):
        for a, b in zip(preds[kind], preds["loop"]):
            for k, v in b.atmos_vars.items():
                assert np.array_equal(_as_numpy(a.atmos_vars[k]), v.numpy()), (kind, k)
