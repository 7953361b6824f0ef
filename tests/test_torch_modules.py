"""The port's modules against their ``aurora_tpu`` counterparts on the CPU in float64.

Every comparison holds the port to a mean relative error of at most 1e-8 (the bar
tests/test_parity_torch.py set against the original torch Aurora); the host-side numpy
code (encodings, group ids) must agree exactly. Inputs and weights are made from numpy
seeds and handed to both sides; the FiLM and LoRA gates are open (seeded noise), so every
Swin block does real work.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_batch
from tests.test_torch_support import matched_models, mean_rel, numpy_tree, torch_batch

CFG = dict(
    embed_dim=64, num_heads=4, encoder_depths=(2, 2, 2), decoder_depths=(2, 2, 2),
    encoder_num_heads=(2, 4, 8), decoder_num_heads=(8, 4, 2), use_lora=True,
)
LEVELS = (100, 250, 500, 850)
BAR = 1e-8


@pytest.fixture(scope="module")
def models():
    return matched_models(CFG)


def test_normalisation_matches():
    from aurora_tpu_torch.normalisation import level_to_str

    jb = make_batch(H=17, W=32, levels=LEVELS)
    want = jb.normalise()
    got = torch_batch(jb).normalise()
    for group in ("surf_vars", "static_vars", "atmos_vars"):
        for k, v in getattr(want, group).items():
            assert mean_rel(getattr(got, group)[k], v) <= BAR, (group, k)
    back = got.unnormalise()
    for k, v in jb.atmos_vars.items():
        assert mean_rel(back.atmos_vars[k], v) <= BAR
    assert [level_to_str(x) for x in (850, 850.0, 0.5, 1000.25)] == ["850", "850", "0_5", "1000_25"]


def test_batch_crop_matches():
    jb = make_batch(H=17, W=32, levels=LEVELS)
    got = torch_batch(jb).crop(4)
    want = jb.crop(4)
    assert got.spatial_shape == (16, 32)
    np.testing.assert_array_equal(got.metadata.lat, np.asarray(want.metadata.lat))
    for k, v in want.atmos_vars.items():
        np.testing.assert_array_equal(got.atmos_vars[k].numpy(), np.asarray(v))
    with pytest.raises(ValueError):
        torch_batch(make_batch(H=18, W=32)).crop(4)


@pytest.mark.parametrize("H,W,P", [(17, 32, 4), (73, 144, 4), (721, 1440, 4)])
def test_encodings_match_exactly(H, W, P):
    """Pole-containing grids (lat runs from +90 to -90): the host float64 encodings are the
    same numpy arithmetic, so they agree bit for bit."""
    from aurora_tpu import fourier as jf
    from aurora_tpu.posencoding import pos_scale_enc as j_pos
    from aurora_tpu_torch import fourier as tf
    from aurora_tpu_torch.posencoding import pos_scale_enc as t_pos

    lat = np.linspace(90, -90, H)[: H - H % P]
    lon = np.linspace(0, 360, W, endpoint=False)
    for a, b in zip(t_pos(64, lat, lon, P), j_pos(64, lat, lon, P)):
        np.testing.assert_array_equal(a, b)
    lv = np.array(LEVELS, dtype=np.float64)
    np.testing.assert_array_equal(tf.levels_expansion(lv, 64), jf.levels_expansion(lv, 64))
    t = np.array([6.0])
    np.testing.assert_array_equal(tf.lead_time_expansion(t, 64), jf.lead_time_expansion(t, 64))
    hrs = np.array([438_000.0, 438_006.0])
    np.testing.assert_array_equal(
        tf.absolute_time_expansion(hrs, 64), jf.absolute_time_expansion(hrs, 64)
    )


@pytest.mark.parametrize(
    "C,H,W,ws,ss",
    [
        (4, 18, 36, (2, 6, 12), (1, 3, 6)),
        (4, 9, 18, (2, 6, 12), (1, 3, 6)),
        (4, 5, 9, (2, 5, 9), (1, 0, 0)),
        (4, 45, 90, (2, 6, 12), (1, 3, 6)),
        (4, 7, 10, (2, 3, 4), (0, 1, 2)),
    ],
)
def test_window_group_ids_match_exactly(C, H, W, ws, ss):
    from aurora_tpu.ops.masks import window_group_ids as j_ids
    from aurora_tpu_torch.ops.masks import window_group_ids as t_ids

    np.testing.assert_array_equal(t_ids(C, H, W, ws, ss), j_ids(C, H, W, ws, ss))


@pytest.mark.parametrize("mode", ["single", "from_second", "all"])
@pytest.mark.parametrize("step", [0, 1, 7, 40, 45])
def test_lora_weight_delta_matches(mode, step):
    from aurora_tpu.model.lora import lora_weight_delta as j_delta
    from aurora_tpu_torch.model.lora import lora_weight_delta as t_delta

    rng = np.random.default_rng(3)
    n = 40 if mode == "all" else 1
    A, B = rng.standard_normal((n, 8, 24)), rng.standard_normal((n, 8, 36))
    kw = dict(r=8, alpha=8, max_steps=40, mode=mode)
    want = np.asarray(j_delta({"A": jnp.asarray(A), "B": jnp.asarray(B)}, jnp.asarray(step), **kw))
    got = t_delta(torch.from_numpy(A), torch.from_numpy(B), step, **kw).numpy()
    assert got.shape == (24, 36)
    if not want.any():
        assert not got.any()
    else:
        assert mean_rel(got, want) <= BAR


def test_patch_embed_matches():
    from aurora_tpu.model.patchembed import level_patch_embed_apply, level_patch_embed_init
    from aurora_tpu_torch.convert import load_numpy_params
    from aurora_tpu_torch.model.patchembed import LevelPatchEmbed

    names = ("a", "b", "c")
    p = level_patch_embed_init(jax.random.PRNGKey(0), names, 4, 32, 2, dtype=jnp.float64)
    mod = LevelPatchEmbed(names, 4, 32, 2, device="cpu", dtype=torch.float64)
    load_numpy_params(mod, numpy_tree(p))
    x = np.random.default_rng(4).standard_normal((2, 2, 1, 16, 24))  # T=1 < history 2
    want = level_patch_embed_apply(p, jnp.asarray(x[:, :2]), names[:2], 4)
    got = mod(torch.from_numpy(x[:, :2]), names[:2])
    assert tuple(got.shape) == (2, 24, 32) and got.is_contiguous()
    assert mean_rel(got, want) <= BAR


def _normalised_inputs(seed=5, H=72, W=144, levels=LEVELS):
    """Random (already-normalised-scale) encoder inputs and the JAX/port encodings."""
    jb = make_batch(H=H, W=W, levels=levels, seed=seed).normalise()
    static = {k: np.broadcast_to(v[None, None], (1, 2, H, W)) for k, v in jb.static_vars.items()}
    return jb, static


def test_encoder_matches(models):
    from aurora_tpu.model.encoder import encoder_apply

    jm, params, tm = models
    jb, static = _normalised_inputs()
    enc_j = jm.prepare_encodings(jb, dtype=jnp.float64)
    want = encoder_apply(
        params["encoder"], {k: jnp.asarray(v) for k, v in jb.surf_vars.items()},
        {k: jnp.asarray(v) for k, v in static.items()},
        {k: jnp.asarray(v) for k, v in jb.atmos_vars.items()}, LEVELS, enc_j, jm.cfg,
    )
    tb = torch_batch(jb)
    got = tm.encoder(
        tb.surf_vars, {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in static.items()},
        tb.atmos_vars, tm.prepare_encodings(tb, torch.float64),
    )
    assert mean_rel(got, want) <= BAR


@pytest.mark.parametrize("step", [0, 1])
def test_backbone_matches(models, step):
    from aurora_tpu.model.swin3d import backbone_apply

    jm, params, tm = models
    patch_res = (4, 18, 36)  # stage 1 shifted windows; stage 2 (9, 18) pads; stage 3 shrinks
    L = 4 * 18 * 36
    x = np.random.default_rng(6).standard_normal((1, L, 64))
    lead = np.random.default_rng(7).standard_normal(64)
    want = jax.jit(backbone_apply, static_argnums=(4, 5))(
        params["backbone"], jnp.asarray(x), jnp.asarray(lead), jnp.asarray(step, jnp.int32),
        patch_res, jm.cfg.backbone,
    )
    got = tm.backbone(torch.from_numpy(x), torch.from_numpy(lead), step, patch_res)
    assert tuple(got.shape) == (1, L, 128)
    assert mean_rel(got, want) <= BAR


def test_decoder_matches(models):
    from aurora_tpu.model.decoder import decoder_apply

    jm, params, tm = models
    H, W = 72, 144
    patch_res = (4, 18, 36)
    x = np.random.default_rng(8).standard_normal((1, 4 * 18 * 36, 128))
    levels_dec = np.random.default_rng(9).standard_normal((len(LEVELS), 128))
    surf, atmos = ("2t", "10u", "10v", "msl"), ("z", "u", "v", "t", "q")
    ws, wa = decoder_apply(
        params["decoder"], jnp.asarray(x), surf, atmos, LEVELS, jnp.asarray(levels_dec),
        patch_res, H, W, jm.cfg,
    )
    gs, ga = tm.decoder(torch.from_numpy(x), surf, atmos, torch.from_numpy(levels_dec),
                        patch_res, H, W)
    for k in surf:
        assert mean_rel(gs[k], ws[k]) <= BAR, k
    for k in atmos:
        assert tuple(ga[k].shape) == (1, len(LEVELS), H, W)
        assert mean_rel(ga[k], wa[k]) <= BAR, k


def test_shared_query_resampler_matches(models):
    """The port's one resampler form (K4 core + K3 MLP half) against the JAX package's
    generic XLA route, at the de-aggregation geometry (K=3 < Q)."""
    from aurora_tpu.model.perceiver import resampler_shared_query_apply as j_apply
    from aurora_tpu_torch.model.perceiver import resampler_shared_query_apply as t_apply

    jm, params, tm = models
    rng = np.random.default_rng(10)
    queries, ctx = rng.standard_normal((5, 128)), rng.standard_normal((3, 40, 128))
    want = j_apply(params["decoder"]["level_decoder"], jnp.asarray(queries), jnp.asarray(ctx),
                   4, k_major=True)
    got = t_apply(tm.decoder.level_decoder, torch.from_numpy(queries), torch.from_numpy(ctx))
    assert mean_rel(got, want) <= BAR
