"""The released models in their facades' default config (float32 all through) on the CPU:
the port against the JAX package.

One parametrised check over ``AuroraAirPollution``, ``AuroraWave``, ``AuroraHighRes``,
``Aurora12hPretrained`` and ``AuroraPretrained``, the models the serving registry and the
command-line interface build in that config: the first two here, the other three in
``tests/test_torch_f32_pretrained.py`` (each case compiles its own JAX program; two files
let the suite's workers share them). Each facade's default config is cut to widths of
64 and two blocks a stage in two stages (``TINY``, as ``tests/test_torch_f32.py`` cuts the
small model's); every other field stays the facade's own: the pollution model's patch 3,
level conditioning, second de-aggregation and modulation heads, the wave model's
``stabilise_level_agg`` (``ln_k`` in the level aggregation), ``lora_mode="from_second"``,
density and angle variables, HighRes's patch 10, the 12 h timestep (LoRA in the first three,
none in the last two). Both packages hold the same numpy-seeded float32 weights (gates open)
and roll out two steps from the same float32 batch (the wave model's LoRA starts at the
second). Mean relative error per variable <= 1e-5 (float32 summation orders of two
programs; a bf16 or TF32 product anywhere gives 1e-3 and more), the wave model's NaN masks
equal (``batch_errors``).

Beside it: the variant tools' ``--default-config``, and each facade's kernel calls a step at
full depth against the launches ``chip_smoke.py`` holds the card's roll-outs to.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aurora_tpu
import aurora_tpu_torch as port
import chip_smoke
from aurora_tpu_torch.tools import variant_bench
from tests.conftest import make_batch
from tests.test_torch_support import (
    batch_errors,
    make_pollution_batch,
    make_wave_batch,
    seeded_matched_variant,
    torch_batch,
)

TINY = dict(embed_dim=64, num_heads=4, encoder_depths=(2, 2), decoder_depths=(2, 2),
            encoder_num_heads=(2, 4), decoder_num_heads=(4, 2))
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, the caller's count restored after (the suite runs six workers
    at once; see ``tests/test_torch_training.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _f32(batch):
    """``batch`` with float32 fields (the port's float32 model takes them as given)."""
    import dataclasses

    def cast(d):
        return {k: np.asarray(v, np.float32) for k, v in d.items()}

    return dataclasses.replace(batch, surf_vars=cast(batch.surf_vars),
                               static_vars=cast(batch.static_vars),
                               atmos_vars=cast(batch.atmos_vars))


BATCHES = {
    "AuroraAirPollution": lambda: make_pollution_batch(H=13, W=24),
    "AuroraWave": lambda: make_wave_batch(H=17, W=36),
    "AuroraHighRes": lambda: make_batch(H=21, W=40),
    "Aurora12hPretrained": lambda: make_batch(),
    "AuroraPretrained": lambda: make_batch(),
}


def check_default_config(name: str) -> None:
    """The facade ``name``'s default config, cut to ``TINY``, port against JAX in float32
    over two roll-out steps (the module's docstring)."""
    jcls, tcls = getattr(aurora_tpu, name), getattr(port, name)
    default = tcls.default_config()
    assert not (default.autocast or default.agg_bf16 or default.deagg_bf16), default
    assert default.stabilise_level_agg == (name == "AuroraWave")
    assert default.use_lora == (name in ("AuroraAirPollution", "AuroraWave", "AuroraHighRes"))
    jmodel, params, tmodel = seeded_matched_variant(jcls, tcls, dtype=jnp.float32, **TINY)
    assert tmodel.cfg == default.replace(**TINY)
    assert {p.dtype for p in tmodel.parameters()} == {torch.float32}
    batch = _f32(BATCHES[name]())
    want = list(aurora_tpu.rollout(jmodel, params, batch, steps=2))
    got = list(port.rollout(tmodel, torch_batch(batch), steps=2))
    assert len(got) == len(want) == 2
    for step, (g, w) in enumerate(zip(got, want)):
        assert all(v.dtype == torch.float32 for v in {**g.surf_vars, **g.atmos_vars}.values())
        errs = batch_errors(g, w)  # equal NaN masks
        assert max(errs.values()) <= TOL, (step, errs)
    if name == "AuroraWave":
        swh = got[-1].surf_vars["swh"].numpy()
        assert np.isnan(swh).any() and not np.isnan(swh).all()  # the density mask engaged


@pytest.mark.parametrize("name", ["AuroraAirPollution", "AuroraWave"])
def test_default_config_matches_jax_in_float32(name):
    check_default_config(name)


def test_variant_tools_build_the_default_config(monkeypatch):
    """``tools.variant_bench --default-config`` and ``tools.highres_bench --default-config``
    build each facade's default config (float32 all through, here cut to ``TINY``) where
    they otherwise build the production knobs: rows of form "default", float32 weights and
    outputs, two roll-out steps on the CPU."""
    from aurora_tpu_torch.tools import highres_bench, variant_bench

    built = []
    for cls in (port.AuroraAirPollution, port.AuroraWave, port.AuroraHighRes):
        cut = cls.default_config().replace(**TINY)
        monkeypatch.setattr(cls, "default_config", classmethod(lambda c, cut=cut: cut))
    real = variant_bench.build_variant

    def spy(cls, device, **kw):
        built.append(real(cls, device, **kw))
        return built[-1]

    monkeypatch.setattr(variant_bench, "build_variant", spy)
    monkeypatch.setattr(highres_bench, "build_variant", spy)
    rows = variant_bench.main(["--default-config", "--device", "cpu", "--H", "25", "--W", "48",
                               "--steps", "2"])
    rows += highres_bench.main(["--default-config", "--device", "cpu", "--H", "41", "--W", "80",
                                "--steps", "2"])
    assert [m.cfg for m in built] == [c.default_config() for c in (
        port.AuroraAirPollution, port.AuroraWave, port.AuroraHighRes)]
    for r, m in zip(rows, built):
        assert r["config"] == "default" and r["dtypes"] == ["float32"], r
        assert {p.dtype for p in m.parameters()} == {torch.float32}
        assert r["rollout_step"] == 2 and not any(r["inf_points"].values())
    production = variant_bench.main(["--variants", "wave", "--device", "cpu", "--H", "25",
                                     "--W", "48", "--steps", "1"])[0]
    assert production["config"] == "production"
    assert built[-1].cfg.autocast and built[-1].backbone.encoder_layers[0].blocks[0].attn.qkv \
        .weight.dtype == torch.bfloat16


def _counted(monkeypatch) -> collections.Counter:
    """Count each kernel wrapper's calls on the model's path (K4 with ``ln_k`` apart)."""
    from aurora_tpu_torch.model import perceiver, swin3d

    calls = collections.Counter()
    for module, name in [(swin3d, "roll3d"), (swin3d, "window_attention_tail"),
                         (swin3d, "mlp_adaln_residual"), (perceiver, "mlp_adaln_residual"),
                         (perceiver, "perceiver_core")]:
        key = {"window_attention_tail": "window_attention"}.get(name, name)

        def counted(*a, _f=getattr(module, name), _k=key, **kw):
            calls[_k] += 1
            calls["perceiver_core ln_k"] += _k == "perceiver_core" and kw["lnk"] is not None
            return _f(*a, **kw)

        monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("name", [*chip_smoke.VARIANT_RUNS, "pretrained"])
def test_launches_a_step_are_the_derived_counts(monkeypatch, name):
    """One step of each facade in its default config at full depth (widths cut to 64) on a
    small grid: the kernel calls are ``chip_smoke.py``'s launches a step (``VARIANT_RUNS``;
    ``AuroraPretrained`` the main route's), the wave model's aggregation K4 with ``ln_k``
    and no other."""
    if name == "pretrained":
        cls, expected = port.AuroraPretrained, chip_smoke.ROUTES["main"][1]
    else:
        facade, _, _, expected = chip_smoke.VARIANT_RUNS[name]
        cls = getattr(port, facade)
    cfg = cls.default_config().replace(embed_dim=64)
    model = cls(cfg, device="cpu", seed=None)  # the calls do not depend on the values
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(0.01)
    calls = _counted(monkeypatch)
    H, W = (25, 48) if cfg.patch_size == 3 else (41, 80) if cfg.patch_size == 10 else (17, 32)
    model(variant_bench.raw_batch(cfg, H, W))
    assert {k: n for k, n in calls.items() if n and k != "perceiver_core ln_k"} == expected
    assert calls["perceiver_core ln_k"] == (name == "wave")
