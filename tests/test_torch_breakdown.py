"""The main path's breakdown tools of the port (``aurora_tpu_torch/tools/{perf,encoder,
decoder}_breakdown.py``) on the CPU.

* Each tool runs through ``main([... "--device", "cpu", small --H/--W ...], cfg=...)`` on a
  small config and returns its rows under the JAX tools' labels, with finite positive times.
* Each part's callable, on ``matched_models`` weights in float64, against the JAX function the
  JAX tool times under the same label: ``forward_core``, ``encoder_apply``,
  ``level_patch_embed_apply``, ``enc_mod._aggregate_levels``, the surface MLP chain, the
  pos/scale adds, ``dec._deaggregate`` (whole, and as the port's K4 + K3 halves),
  ``dec._stack_heads`` + ``linear`` and ``unpatchify``; mean relative error <= 1e-8.
* Without a card and without ``--device cpu`` every tool raises.
"""

import math
from datetime import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.batch import Batch as JaxBatch
from aurora_tpu.batch import Metadata as JaxMetadata
from aurora_tpu.model import decoder as j_dec
from aurora_tpu.model import encoder as j_enc
from aurora_tpu.model.aurora import forward_core as j_forward_core
from aurora_tpu.model.nn import layernorm as j_layernorm
from aurora_tpu.model.nn import linear as j_linear
from aurora_tpu.model.nn import mlp as j_mlp
from aurora_tpu.model.patchembed import level_patch_embed_apply
from aurora_tpu_torch.model.config import AuroraConfig
from aurora_tpu_torch.model.encoder import EncoderEncodings
from aurora_tpu_torch.tools import decoder_breakdown, encoder_breakdown, perf_breakdown
from tests.test_torch_support import matched_models, mean_rel, torch_batch

CFG = dict(
    embed_dim=64, num_heads=4, encoder_depths=(2, 2, 2), decoder_depths=(2, 2, 2),
    encoder_num_heads=(2, 4, 8), decoder_num_heads=(8, 4, 2), use_lora=True,
)
SMALL = AuroraConfig(**CFG)
GRID = ["--H", "24", "--W", "48"]
LABELS = {
    perf_breakdown: {"prepare_encodings", "batch upload", "batch upload (host arrays, first step)",
                     "Aurora.forward (whole step)", "forward_core (device-resident)", "encoder",
                     "backbone (bf16)", "decoder", "sum enc+bb+dec"},
    encoder_breakdown: {"encoder FULL", "surf patch embed (7ch)", "atmos patch embed (13 lvl)",
                        "level aggregation", "surf MLP chain", "pos+scale adds"},
    decoder_breakdown: {"deaggregate FULL", "  K4 perceiver_core", "  K3 MLP half",
                        "fused atmos head GEMM", "unpatchify (13 levels)",
                        "input rearrange (C,L)->(L,C)"},
}
TOOLS = [perf_breakdown, encoder_breakdown, decoder_breakdown]
IDS = ["perf_breakdown", "encoder_breakdown", "decoder_breakdown"]


@pytest.mark.parametrize("tool", TOOLS, ids=IDS)
def test_breakdown_tool_runs_on_the_cpu(tool, capsys):
    rows = tool.main(["--device", "cpu", "--steps", "1", *GRID], cfg=SMALL)
    assert [r["label"] for r in rows] == list(dict.fromkeys(r["label"] for r in rows))
    assert {r["label"] for r in rows} == LABELS[tool]
    for r in rows:
        assert r["device"] == "cpu"
        assert math.isfinite(r["ms"]) and r["ms"] > 0, r
        assert r.get("launches", {}) == {}  # the plain versions launch nothing
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 + len(rows)  # the device line, then one per row
    if tool is perf_breakdown:
        ms = {r["label"]: r for r in rows}
        parts = ("encoder", "backbone (bf16)", "decoder")
        assert ms["sum enc+bb+dec"]["ms"] == pytest.approx(sum(ms[k]["ms"] for k in parts))
        step = ms["Aurora.forward (whole step)"]
        assert step["minus_forward_core_ms"] == pytest.approx(
            step["ms"] - ms["forward_core (device-resident)"]["ms"])


@pytest.mark.parametrize("tool", TOOLS, ids=IDS)
def test_breakdown_tool_raises_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main([], cfg=SMALL)


@pytest.mark.parametrize("tool", TOOLS, ids=IDS)
def test_breakdown_tool_refuses_a_model_on_another_device(tool):
    model = perf_breakdown.build_model(perf_breakdown.production_config(SMALL), "cpu")
    with pytest.raises(ValueError, match="the tool runs on cuda"):
        tool.main(["--device", "cuda", *GRID], model=model)


# ------------------------------------------------------------------------------ parity


@pytest.fixture(scope="module")
def f64_pair():
    jm, params, tm = matched_models(CFG)
    return jm, params, tm


def _pair(rng, *shape, positive=False):
    a = rng.standard_normal(shape)
    a = np.abs(a) if positive else a
    return jnp.asarray(a), torch.from_numpy(a)


def _jax_encodings(enc_t):
    return j_enc.EncoderEncodings(**{k: jnp.asarray(getattr(enc_t, k).numpy()) for k in
                                     ("pos", "scale", "levels", "levels_dec", "lead_time",
                                      "absolute_time")})


def _check(got, want, what):
    err = mean_rel(got, want)
    assert err <= 1e-8, (what, err)


def test_encoder_parts_match_the_jax_functions(f64_pair):
    jm, params, tm = f64_pair
    cfg, p = jm.cfg, params["encoder"]
    rng = np.random.default_rng(3)
    H, W, T, C_A, P, D = 24, 48, 2, 5, cfg.patch_size, cfg.embed_dim
    L = (H // P) * (W // P)
    levels = (100.0, 250.0, 500.0, 700.0, 850.0)
    j, t = {}, {}
    for key, shape, names, pos in (("surf", (1, T, H, W), cfg.surf_vars, False),
                                   ("static", (1, T, H, W), cfg.static_vars, True),
                                   ("atmos", (1, T, C_A, H, W), cfg.atmos_vars, False)):
        pairs = {k: _pair(rng, *shape, positive=pos) for k in names}
        j[key], t[key] = {k: a for k, (a, _) in pairs.items()}, {k: b for k, (_, b) in pairs.items()}
    enc = EncoderEncodings(*(torch.from_numpy(rng.standard_normal(s)) for s in
                             ((L, D), (L, D), (C_A, D), (C_A, 2 * D), (D,), (1, D))))
    for key, shape in (("x_surf", (1, 7, T, H, W)), ("x_atmos", (C_A, 5, T, H, W)),
                       ("xa", (1, C_A, L, D)), ("xs", (1, L, D)),
                       ("x4", (1, cfg.latent_levels, L, D))):
        j[key], t[key] = _pair(rng, *shape)
    t["enc"] = enc
    parts = encoder_breakdown.encoder_parts(tm, t)
    names7 = tuple(cfg.surf_vars) + tuple(cfg.static_vars)
    jenc = _jax_encodings(enc)
    want = {
        "encoder FULL": j_enc.encoder_apply(p, j["surf"], j["static"], j["atmos"], levels, jenc,
                                            cfg),
        "surf patch embed (7ch)": level_patch_embed_apply(p["surf_token_embeds"], j["x_surf"],
                                                          names7, P),
        "atmos patch embed (13 lvl)": level_patch_embed_apply(
            p["atmos_token_embeds"], j["x_atmos"], tuple(cfg.atmos_vars), P),
        "level aggregation": j_enc._aggregate_levels(p, j["xa"], cfg),
        "surf MLP chain": j["xs"] + j_layernorm(p["surf_norm"], j_mlp(p["surf_mlp"], j["xs"])),
        "pos+scale adds": (j["x4"] + j_linear(p["pos_embed"], jenc.pos)[None, None]
                           + j_linear(p["scale_embed"], jenc.scale)[None, None]),
    }
    assert set(parts) == set(want)
    for label, fn in parts.items():
        _check(fn(), want[label], label)


def test_decoder_parts_match_the_jax_functions(f64_pair):
    jm, params, tm = f64_pair
    cfg, p = jm.cfg, params["decoder"]
    rng = np.random.default_rng(4)
    H, W, C_A, P, D = 24, 48, 13, cfg.patch_size, cfg.decoder_embed_dim
    L, V, C_l = (H // P) * (W // P), len(cfg.atmos_vars), cfg.latent_levels
    j, t = {}, {"HW": (H, W)}
    for key, shape in (("ctx", (1, C_l - 1, L, D)), ("le", (C_A, D)), ("lat", (1, L, C_A, D)),
                       ("xa", (1, L, C_A, P * P * V)), ("x", (1, C_l * L, D))):
        j[key], t[key] = _pair(rng, *shape)
    parts = decoder_breakdown.decoder_parts(tm, t)
    deagg = j_dec._deaggregate(p["level_decoder"], j["le"], j["ctx"], cfg)
    want = {
        "deaggregate FULL": deagg,
        "  K3 MLP half": deagg.reshape(L, C_A, D),  # K4 then K3: the whole de-aggregation
        "fused atmos head GEMM": j_linear(j_dec._stack_heads(p["atmos_heads"], cfg.atmos_vars),
                                          j["lat"]),
        "unpatchify (13 levels)": j_dec.unpatchify(j["xa"], V, H, W, P),
        "input rearrange (C,L)->(L,C)": j["x"].reshape(1, C_l, L, D).transpose(0, 2, 1, 3),
    }
    assert set(parts) == set(want) | {"  K4 perceiver_core"}
    for label, want_v in want.items():
        _check(parts[label](), want_v, label)
    k4 = parts["  K4 perceiver_core"]()
    assert tuple(k4.shape) == (L, C_A, D) and k4.dtype == torch.float64


def test_step_parts_match_forward_core(f64_pair):
    jm, params, tm = f64_pair
    cfg = jm.cfg
    H, W, levels = 25, 48, (100, 250, 500, 850)
    rng = np.random.default_rng(5)
    jb = JaxBatch(
        surf_vars={k: rng.standard_normal((1, 2, H, W)) for k in cfg.surf_vars},
        static_vars={k: np.abs(rng.standard_normal((H, W))) for k in cfg.static_vars},
        atmos_vars={k: rng.standard_normal((1, 2, len(levels), H, W)) for k in cfg.atmos_vars},
        metadata=JaxMetadata(lat=np.linspace(90, -90, H), lon=np.linspace(0, 360, W, endpoint=False),
                             time=(datetime(2020, 6, 1, 12),), atmos_levels=levels),
    ).crop(cfg.patch_size)
    enc = jm.prepare_encodings(jb, dtype=jnp.float64)
    as_j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    want_surf, want_atmos = j_forward_core(
        params, as_j(jb.surf_vars), as_j(jb.static_vars), as_j(jb.atmos_vars), enc,
        jnp.asarray(0, jnp.int32), tuple(float(x) for x in levels), cfg)
    parts = perf_breakdown.step_parts(tm, torch_batch(jb))
    got_surf, got_atmos = parts["forward_core (device-resident)"]()
    for k in want_surf:
        _check(got_surf[k], want_surf[k], f"forward_core surf {k}")
    for k in want_atmos:
        _check(got_atmos[k], want_atmos[k], f"forward_core atmos {k}")
    step = parts["Aurora.forward (whole step)"]()
    for k in want_atmos:
        _check(step.atmos_vars[k][:, 0], want_atmos[k], f"forward atmos {k}")
    assert set(parts) == LABELS[perf_breakdown] - {"sum enc+bb+dec", "backbone (bf16)"} | {
        "backbone"}  # f64: no autocast
