"""``stabilise_level_agg`` in the port: K4 with ``ln_k``, the perceiver's ``ln_q`` and the
model that turns them on, against ``aurora_tpu`` on the CPU.

* ``perceiver_core_plain(lnk=...)`` against ``perceiver_core_fused(..., lnk_w, lnk_b)`` in
  interpret mode, as tests/test_resampler_kernel.py runs it: f32 within 1e-5 (f32
  accumulation order), bf16 values within 1e-2 (a flipped bf16 rounding is up to 7.8e-3 of
  a value).
* ``resampler_shared_query_apply`` with ``ln_k_q=True`` and the small model with
  ``stabilise_level_agg=True`` (forward and a 2-step roll-out) in float64 at a mean
  relative error of at most 1e-8, with seeded noise in the ``ln_k``/``ln_q`` affines
  (at init they are one and zero).
* ``params_from_numpy`` consumes the ``ln_k``/``ln_q`` leaves, and fails on them when the
  port's config has no such module.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.ops.resampler import make_q_major_blockdiag, perceiver_core_fused
from aurora_tpu_torch.ops.resampler import perceiver_core
from tests.conftest import make_batch
from tests.test_torch_support import max_rel, mean_rel, numpy_tree, open_gates, torch_batch

CFG = dict(
    embed_dim=64, num_heads=4, encoder_depths=(2, 2, 2), decoder_depths=(2, 2, 2),
    encoder_num_heads=(2, 4, 8), decoder_num_heads=(8, 4, 2), use_lora=True,
    stabilise_level_agg=True,
)
LEVELS = (100, 250, 500, 850)
BAR = 1e-8


def _core_inputs(K, Q, seed=2):
    rng = np.random.default_rng(seed)
    M, D, h = 72, 32, 4
    dh = D // h
    a = dict(
        ctx=rng.standard_normal((K, M, D)),
        wk=0.3 * rng.standard_normal((D, D)), wv=0.3 * rng.standard_normal((D, D)),
        qh=rng.standard_normal((Q, h, dh)), wout=0.3 * rng.standard_normal((D, D)),
        ln1_w=1 + 0.1 * rng.standard_normal(D), ln1_b=0.1 * rng.standard_normal(D),
        queries=rng.standard_normal((Q, D)),
    )
    lnk = (1 + 0.2 * rng.standard_normal(D), 0.2 * rng.standard_normal(D))
    return a, lnk, h, dh


@pytest.mark.parametrize("value_bf16", [False, True])
@pytest.mark.parametrize("K,Q", [(5, 3), (3, 5)])
def test_perceiver_core_lnk_matches_pallas(K, Q, value_bf16):
    a, lnk, h, dh = _core_inputs(K, Q)
    j = {k: jnp.asarray(v, jnp.float32) for k, v in a.items()}
    want = perceiver_core_fused(
        j["ctx"], j["wk"], None, j["wv"], None, make_q_major_blockdiag(j["qh"], h), j["wout"],
        None, j["ln1_w"], j["ln1_b"], j["queries"], jnp.asarray(lnk[0], jnp.float32),
        jnp.asarray(lnk[1], jnp.float32), num_heads=h, scale=dh**-0.5, value_bf16=value_bf16,
        interpret=True,
    )
    t = {k: torch.from_numpy(v).float() for k, v in a.items()}
    got = perceiver_core(**t, scale=dh**-0.5, value_bf16=value_bf16,
                         lnk=tuple(torch.from_numpy(v).float() for v in lnk))
    assert got.dtype == (torch.bfloat16 if value_bf16 else torch.float32)
    assert max_rel(got, want) < (1e-2 if value_bf16 else 1e-5)


def test_lnk_changes_the_result_and_ignores_ln_eps():
    """``ln_k`` is exercised (the result moves), and its eps is the fixed 1e-5, not the
    ``ln_eps`` of ``ln1``: with ``ln_eps`` changed, k's normalisation stays, so the result
    differs from the default only through ``ln1``."""
    a, lnk, h, dh = _core_inputs(5, 3)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    lnk_t = tuple(torch.from_numpy(v) for v in lnk)
    base = perceiver_core(**t, scale=dh**-0.5)
    with_lnk = perceiver_core(**t, scale=dh**-0.5, lnk=lnk_t)
    assert max_rel(with_lnk, base) > 1e-2
    # A context scaled by 1e-3 gives k a variance of ~1e-6, below the fixed eps: were eps
    # ln_eps = 1e-12 instead, the normalised k (and so the result) would differ visibly.
    small = dict(t, ctx=t["ctx"] * 1e-3)
    got = perceiver_core(**small, scale=dh**-0.5, lnk=lnk_t, ln_eps=1e-12)
    k = (small["ctx"].reshape(-1, 32) @ small["wk"])
    k = (k - k.mean(-1, keepdim=True)) * torch.rsqrt(k.var(-1, unbiased=False, keepdim=True) + 1e-5)
    k = (k * lnk_t[0] + lnk_t[1]).reshape(5, 72, h, dh)
    logits = torch.einsum("kmhd,qhd->kmqh", k, t["qh"]) * dh**-0.5
    v = (small["ctx"].reshape(-1, 32) @ small["wv"]).reshape(5, 72, 1, h, dh)
    o = (torch.softmax(logits, 0)[..., None] * v).sum(0).reshape(72 * 3, 32) @ t["wout"]
    ln = (o - o.mean(-1, keepdim=True)) * torch.rsqrt(o.var(-1, unbiased=False, keepdim=True) + 1e-12)
    want = (ln * t["ln1_w"] + t["ln1_b"]).reshape(72, 3, 32) + t["queries"][None]
    assert max_rel(got, want) < 1e-12


def _noisy_ln(params, names=("ln_k", "ln_q"), std=0.2):
    """Seeded noise in the affines of the named LayerNorms (one and zero at init)."""

    def visit(path, v):
        ks = jax.tree_util.keystr(path)
        if any(f"['{n}']" in ks for n in names):
            rng = np.random.default_rng(zlib.crc32(ks.encode()))
            return v + jnp.asarray(std * rng.standard_normal(v.shape), v.dtype)
        return v

    return jax.tree_util.tree_map_with_path(visit, params)


@pytest.mark.parametrize("k_major", [True, False], ids=["k_major", "m_major"])
def test_resampler_ln_k_q_matches_f64(k_major):
    """The port's shared-query resampler with the stabilising LayerNorms against the JAX
    one through its k-major and its generic M-major route."""
    from aurora_tpu.model.perceiver import perceiver_resampler_init
    from aurora_tpu.model.perceiver import resampler_shared_query_apply as j_apply
    from aurora_tpu_torch.convert import load_numpy_params
    from aurora_tpu_torch.model.perceiver import PerceiverResampler
    from aurora_tpu_torch.model.perceiver import resampler_shared_query_apply as t_apply

    D, h, K, Q, M = 64, 4, 5, 3, 72
    p = _noisy_ln(perceiver_resampler_init(
        jax.random.PRNGKey(3), D, D, depth=1, head_dim=D // h, num_heads=h, ln_k_q=True,
        dtype=jnp.float64))
    tm = PerceiverResampler(D, D, depth=1, head_dim=D // h, num_heads=h, ln_k_q=True,
                            device="cpu", dtype=torch.float64)
    load_numpy_params(tm, numpy_tree(p))
    rng = np.random.default_rng(11)
    queries, ctx = rng.standard_normal((Q, D)), rng.standard_normal((K, M, D))
    jctx = jnp.asarray(ctx) if k_major else jnp.asarray(ctx.transpose(1, 0, 2))
    want = j_apply(p, jnp.asarray(queries), jctx, h, k_major=k_major)
    got = t_apply(tm, torch.from_numpy(queries), torch.from_numpy(ctx))
    assert mean_rel(got, want) <= BAR
    plain = PerceiverResampler(D, D, head_dim=D // h, num_heads=h, device="cpu")
    assert plain.layers[0].attn.ln_k is None and plain.layers[0].attn.ln_q is None


@pytest.fixture(scope="module")
def stabilised():
    from aurora_tpu.model.aurora import Aurora as JaxAurora
    from aurora_tpu.model.config import AuroraConfig as JaxConfig
    from aurora_tpu_torch.convert import params_from_numpy
    from aurora_tpu_torch.model.config import AuroraConfig

    jm = JaxAurora(JaxConfig(**CFG))
    params = _noisy_ln(open_gates(jm.init(jax.random.PRNGKey(0), dtype=jnp.float64)))
    tm = params_from_numpy(numpy_tree(params), AuroraConfig(**CFG), device="cpu",
                           dtype=torch.float64)
    return jm, params, tm, make_batch(H=73, W=144, levels=LEVELS)


def _errors(pred, ref) -> dict:
    out = {f"surf {k}": mean_rel(pred.surf_vars[k], v) for k, v in ref.surf_vars.items()}
    out.update({f"atmos {k}": mean_rel(pred.atmos_vars[k], v) for k, v in ref.atmos_vars.items()})
    return out


def test_stabilised_forward_matches_f64(stabilised):
    jm, params, tm, jb = stabilised
    errs = _errors(tm(torch_batch(jb)), jm.forward(params, jb))
    assert max(errs.values()) <= BAR, errs


def test_stabilised_rollout_matches_f64(stabilised):
    from aurora_tpu.rollout import rollout as j_rollout
    from aurora_tpu_torch import rollout as t_rollout

    jm, params, tm, jb = stabilised
    want = list(j_rollout(jm, params, jb, steps=2))
    got = list(t_rollout(tm, torch_batch(jb), steps=2))
    for step, (g, w) in enumerate(zip(got, want)):
        errs = _errors(g, w)
        assert max(errs.values()) <= BAR, (step, errs)
        assert g.metadata.rollout_step == step + 1


def test_stabilised_differs_from_the_base_model(stabilised):
    """The flag changes the prediction: the LayerNorms are on the path."""
    from aurora_tpu_torch.convert import load_numpy_params
    from aurora_tpu_torch.model.aurora import Aurora
    from aurora_tpu_torch.model.config import AuroraConfig

    _, params, tm, jb = stabilised
    tree = numpy_tree(params)
    attn = tree["encoder"]["level_agg"]["layers"][0]["attn"]
    base_tree = dict(tree, encoder=dict(tree["encoder"], level_agg={"layers": [
        dict(tree["encoder"]["level_agg"]["layers"][0],
             attn={k: v for k, v in attn.items() if k not in ("ln_k", "ln_q")})]}))
    base = Aurora(AuroraConfig(**dict(CFG, stabilise_level_agg=False)), device="cpu",
                  dtype=torch.float64, seed=None)
    load_numpy_params(base, base_tree)
    a, b = tm(torch_batch(jb)), base(torch_batch(jb))
    assert mean_rel(a.atmos_vars["t"], b.atmos_vars["t"]) > 1e-6


@pytest.mark.parametrize("leaf", ["ln_k.weight", "ln_k.bias", "ln_q.weight", "ln_q.bias"])
def test_params_from_numpy_consumes_ln_k_q(stabilised, leaf):
    from aurora_tpu_torch.convert import params_from_numpy
    from aurora_tpu_torch.model.config import AuroraConfig

    _, params, tm, _ = stabilised
    name = f"encoder.level_agg.layers.0.attn.{leaf}"
    ln, key = leaf.split(".")
    want = np.asarray(params["encoder"]["level_agg"]["layers"][0]["attn"][ln][key])
    np.testing.assert_array_equal(dict(tm.named_parameters())[name].detach().numpy(), want)
    assert not any("ln_k" in n or "ln_q" in n for n, _ in tm.decoder.named_parameters())
    with pytest.raises(ValueError, match="unconsumed"):
        params_from_numpy(numpy_tree(params),
                          AuroraConfig(**dict(CFG, stabilise_level_agg=False)), device="cpu")
