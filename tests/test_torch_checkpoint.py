"""The port's checkpoint path (``aurora_tpu_torch/checkpoint.py``) against ``aurora_tpu``'s.

* The converter gives the JAX converter's tree bit for bit on the same reference-format
  dict, for a small config of each released variant; each schema migration gives the JAX
  migration's dict on hand-built old-schema dicts; ``adapt_max_history_size`` widens, refuses
  to shrink and is idempotent; a missing, unexpected or mis-shaped key raises ``ValueError``.
* The six released manifests (``tests/data/ckpt_manifests.json``) validate against the port's
  parameters with zero problems, on a model built on the ``meta`` device.
* A JAX tree written in reference format with ``torch.save`` is read by the port's
  ``load_checkpoint_local`` and the JAX ``load_torch_checkpoint``: the forwards agree in
  float64 at mean relative error <= 1e-8. ``save_params`` / ``restore_params`` keep the bits.

The reference-format writer is ``tests/test_torch_support.py::reference_state_dict``, held
here by the JAX converter turning its output back into the original tree.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aurora_tpu
import aurora_tpu_torch
from aurora_tpu import checkpoint as jck
from aurora_tpu_torch import checkpoint as tck
from aurora_tpu_torch.convert import flatten_tree
from tests.test_torch_support import (
    SMALL_ARCH,
    make_pollution_batch,
    matched_variant,
    mean_rel,
    numpy_tree,
    port_config,
    reference_state_dict,
    torch_batch,
)

MANIFESTS = json.loads((Path(__file__).parent / "data" / "ckpt_manifests.json").read_text())
# Manifest key -> (JAX facade, port facade).
VARIANTS = {
    name: (getattr(aurora_tpu, name), getattr(aurora_tpu_torch, name))
    for name in ("Aurora", "AuroraSmallPretrained", "Aurora12hPretrained", "AuroraHighRes",
                 "AuroraAirPollution", "AuroraWave")
}
# Small configs of each variant: LoRA on in the "all" mode, so the banks have several steps.
SMALL = {
    "Aurora": dict(SMALL_ARCH, lora_mode="all", lora_steps=3),
    "Aurora12hPretrained": dict(SMALL_ARCH),
    "AuroraHighRes": dict(SMALL_ARCH, use_lora=False),
    # The released 13 levels: the air-pollution migration aliases z per released level.
    "AuroraAirPollution": dict(SMALL_ARCH, lora_mode="all", lora_steps=2),
    "AuroraWave": dict(SMALL_ARCH),
}


def _small(name):
    jcls, tcls = VARIANTS[name]
    jm = jcls(**SMALL[name])
    return jm, tcls, numpy_tree(jm.init(jax.random.PRNGKey(0)))


def _assert_trees_equal(got, want):
    g, w = flatten_tree(got), flatten_tree(numpy_tree(want))
    assert set(g) == set(w), sorted(set(g) ^ set(w))[:10]
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), k


def _assert_dicts_equal(got: dict, want: dict):
    assert list(got) == list(want), sorted(set(got) ^ set(want))[:10]
    for k in want:
        assert np.asarray(got[k]).shape == np.asarray(want[k]).shape, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("name", sorted(SMALL))
def test_writer_round_trips_through_the_jax_converter(name):
    jm, _, params = _small(name)
    sd = reference_state_dict(params)
    _assert_trees_equal(jck.convert_torch_state_dict(sd, jm.cfg), params)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_converter_matches_jax_bit_for_bit(name):
    """The migrations, the conversion and the validation of both packages on one dict."""
    jm, _, params = _small(name)
    sd = reference_state_dict(params)
    want = jck.convert_reference_checkpoint(sd, jm.cfg)
    got = tck.convert_reference_checkpoint(sd, port_config(jm.cfg))
    _assert_trees_equal(got, want)


def _rng_sd(shapes: dict, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


D, P, T = 8, 2, 2


def test_adapt_pretrained_matches_jax():
    """``net.`` prefixes, the fused surface/atmos patch embeddings and heads."""
    sd = _rng_sd({
        "net.encoder.surf_token_embeds.weight": (D, 7, T, P, P),
        "net.encoder.atmos_token_embeds.weight": (D, 5, T, P, P),
        "net.decoder.surf_head.weight": (4 * P * P, 2 * D),
        "net.decoder.surf_head.bias": (4 * P * P,),
        "net.decoder.atmos_head.weight": (5 * P * P, 2 * D),
        "net.decoder.atmos_head.bias": (5 * P * P,),
        "net.encoder.pos_embed.weight": (D, D),
    })
    got = tck.adapt_checkpoint_pretrained(P, sd)
    _assert_dicts_equal(got, jck.adapt_checkpoint_pretrained(P, sd))
    assert "decoder.atmos_heads.q.bias" in got and not any(k.startswith("net.") for k in got)


def test_adapt_air_pollution_matches_jax():
    """``weight_new`` / ``weight_new2``, ``atmos_token_embeds_new.layers.*`` (biases add),
    the ``z`` / ``static_z`` aliasing, ``level_decoder_new``, the ``_new`` / ``_mod`` heads."""
    levels = (50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000)
    shapes = {
        "encoder.surf_token_embeds.weight_new": (D, 22, T, P, P),
        "encoder.atmos_token_embeds.bias": (D,),
        "encoder.atmos_token_embeds.weight_new2": (D, 17, T, P, P),
        "encoder.atmos_token_embeds.weight_new": (D, 3, T, P, P),
        "surf_feature_combiner.2t.weight": (1, 2),
        "atmos_feature_combiner.z.bias": (1,),
        "atmos_feature_combiner.co.weight": (1, 2),
        "decoder.level_decoder_new.layers.0.0.to_q.weight": (2 * D, 2 * D),
        "decoder.surf_head_new.weight": (8 * P * P, 2 * D),
        "decoder.surf_head_new.bias": (8 * P * P,),
        "decoder.surf_head_mod.weight": (12 * P * P, 2 * D),
        "decoder.surf_head_mod.bias": (12 * P * P,),
    }
    shapes.update({f"encoder.atmos_token_embeds.weights.{v}": (D, 1, T, P, P)
                   for v in ("z", "u", "v", "t", "q")})
    for lvl in levels:
        new = f"encoder.atmos_token_embeds_new.layers.{lvl}"
        shapes.update({f"{new}.weight": (D, 1, T, P, P), f"{new}.weight_new": (D, 5, T, P, P),
                       f"{new}.bias": (D,), f"{new}.weight_new2": (D, 1, T, P, P)})
        for head in ("atmos_head", "atmos_head_new", "atmos_head_mod", "atmos_head_mod_new"):
            shapes[f"decoder.{head}.layers.{lvl}.weight"] = (5 * P * P, 2 * D)
            shapes[f"decoder.{head}.layers.{lvl}.bias"] = (5 * P * P,)
    sd = _rng_sd(shapes)
    got = tck.adapt_checkpoint_air_pollution(P, sd)
    _assert_dicts_equal(got, jck.adapt_checkpoint_air_pollution(P, sd))
    emb = "encoder.atmos_token_embeds.layers.850"
    assert np.array_equal(got[f"{emb}.weights.z"], got[f"{emb}.weights.static_z"])
    assert np.array_equal(got[f"{emb}.bias"], sd["encoder.atmos_token_embeds.bias"]
                          + sd["encoder.atmos_token_embeds_new.layers.850.bias"])
    assert "decoder.atmos_heads.so2_mod.layers.925.weight" in got
    assert "decoder.level_decoder_alternate.layers.0.0.to_q.weight" in got


def test_adapt_wave_matches_jax():
    sd = _rng_sd({
        "encoder.level_agg.layers.0.0.k_ln.weight": (D,),
        "encoder.level_agg.layers.0.0.q_ln.bias": (D,),
        "encoder.level_agg.layers.0.0.to_q.weight": (D, D),
    })
    got = tck.adapt_checkpoint_wave(P, sd)
    _assert_dicts_equal(got, jck.adapt_checkpoint_wave(P, sd))
    assert "encoder.level_agg.layers.0.0.ln_k.weight" in got


def test_adapt_max_history_size_widens_refuses_to_shrink_and_is_idempotent():
    sd = _rng_sd({"encoder.surf_token_embeds.weights.2t": (D, 1, 1, P, P),
                  "encoder.atmos_token_embeds.layers.50.weights.z": (D, 1, 1, P, P),
                  "encoder.surf_token_embeds.bias": (D,)})
    got = tck.adapt_max_history_size(sd, 3)
    _assert_dicts_equal(got, jck.adapt_max_history_size(sd, 3))
    w = got["encoder.atmos_token_embeds.layers.50.weights.z"]
    assert w.shape == (D, 1, 3, P, P) and not w[:, :, 1:].any()
    _assert_dicts_equal(tck.adapt_max_history_size(got, 3), got)
    for mod in (tck, jck):
        with pytest.raises(AssertionError, match="max_history_size"):
            mod.adapt_max_history_size(got, 2)


def _break(sd: dict, kind: str) -> dict:
    bad = dict(sd)
    if kind == "missing":
        del bad["encoder.pos_embed.weight"]
    elif kind == "unexpected":
        bad["encoder.extra.weight"] = np.zeros((2, 2), np.float32)
    else:
        bad["encoder.pos_embed.weight"] = np.zeros((3, 3), np.float32)
    return bad


@pytest.mark.parametrize("kind", ["missing", "unexpected", "mismatched"])
def test_strict_conversion_raises_as_jax(kind):
    jm, _, params = _small("Aurora")
    bad = _break(reference_state_dict(params), kind)
    with pytest.raises(ValueError, match=kind) as jax_err:
        jck.convert_reference_checkpoint(bad, jm.cfg)
    with pytest.raises(ValueError, match=kind) as port_err:
        tck.convert_reference_checkpoint(bad, port_config(jm.cfg))
    assert str(port_err.value) == str(jax_err.value)
    tck.convert_reference_checkpoint(bad, port_config(jm.cfg), strict=False)


def test_lora_banks_are_exempt_when_the_file_predates_them(tmp_path):
    """A LoRA model loads a file without LoRA under ``strict=True`` and keeps its own banks."""
    jm, _, params = _small("AuroraWave")
    jm_plain = aurora_tpu.AuroraWave(**SMALL_ARCH, use_lora=False)
    sd = reference_state_dict(jm_plain.init(jax.random.PRNGKey(1)))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "plain.ckpt")
    model = aurora_tpu_torch.AuroraWave(port_config(jm.cfg), device="cpu", seed=3)
    banks = {n: p.clone() for n, p in model.named_parameters() if "lora" in n}
    assert banks and model.load_checkpoint_local(tmp_path / "plain.ckpt") is model
    for n, p in model.named_parameters():
        if "lora" in n:
            assert torch.equal(p, banks[n]), n
    assert torch.equal(model.encoder.pos_embed.weight,
                       torch.from_numpy(sd["encoder.pos_embed.weight"].T))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_released_manifest_validates_without_allocating(name):
    """Every key and shape of the released file, pushed through the port's migrations and
    converter (leaves as shapes), against the port's parameters built on ``meta``."""
    cfg = VARIANTS[name][1].default_config()
    sd = {k: np.broadcast_to(np.zeros((), np.float32), s) for k, s in MANIFESTS[name].items()}
    tree = tck.convert_reference_checkpoint(sd, cfg, leaf_fn=lambda v, d: v.shape)
    problems = tck.validate_params(tree, cfg)
    assert problems == {"missing": [], "unexpected": [], "mismatched": []}, problems
    model = VARIANTS[name][1](cfg, device="meta", seed=None)
    assert {p.device.type for p in model.parameters()} == {"meta"}
    assert len(tck.model_param_shapes(cfg)) == len(tck.tree_path_shapes(tree))


def test_file_round_trip_forward_matches_jax(tmp_path):
    """AirPollution (the most migrations): one reference-format file, read by both packages;
    the forwards in float64 agree."""
    jm, params, _ = matched_variant(
        aurora_tpu.AuroraAirPollution, aurora_tpu_torch.AuroraAirPollution,
        **SMALL_ARCH, use_lora=False)
    path = tmp_path / "aurora-air-pollution.ckpt"
    torch.save({k: torch.from_numpy(v) for k, v in reference_state_dict(params).items()}, path)

    jparams = jck.load_torch_checkpoint(str(path), jm.cfg, dtype=jnp.float64)
    tm = aurora_tpu_torch.AuroraAirPollution(port_config(jm.cfg), device="cpu",
                                             dtype=torch.float64, seed=None)
    assert tm.load_checkpoint_local(path) is tm
    batch = make_pollution_batch()
    want, got = jm.forward(jparams, batch), tm(torch_batch(batch))
    for group in ("surf_vars", "atmos_vars"):
        g, w = getattr(got, group), getattr(want, group)
        assert set(g) == set(w)
        for k in w:
            assert mean_rel(g[k], w[k]) <= 1e-8, (k, mean_rel(g[k], w[k]))


def test_save_restore_params_keep_the_bits(tmp_path):
    cfg = port_config(aurora_tpu.Aurora12hPretrained(**SMALL_ARCH).cfg)
    model = aurora_tpu_torch.Aurora12hPretrained(cfg, device="cpu", seed=5)
    tck.save_params(model, tmp_path / "params.pt")
    fresh = aurora_tpu_torch.Aurora12hPretrained(cfg, device="cpu", seed=None)
    assert tck.restore_params(tmp_path / "params.pt", like=fresh) is fresh
    sd = tck.restore_params(tmp_path / "params.pt")
    for n, p in model.named_parameters():
        assert torch.equal(dict(fresh.named_parameters())[n], p), n
        assert torch.equal(sd[n], p), n


def test_hub_loader_needs_huggingface_hub(monkeypatch):
    """Offline the hub path is not exercised; without the package it says so."""
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    model = aurora_tpu_torch.AuroraWave(device="meta", seed=None)
    with pytest.raises(ImportError, match="huggingface_hub"):
        model.load_checkpoint()
