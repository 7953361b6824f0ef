"""Perceiver resamplers of any depth in the port (``aurora_tpu_torch/model/perceiver.py``) and
K4's bias inputs, against ``aurora_tpu`` on the CPU.

* ``resampler_shared_query_apply`` at depth 2 and 3 in the aggregation geometry (K 13 -> Q 3)
  and the de-aggregation's (K 3 -> Q 13), with and without ``ln_k_q``, in float64 at a mean
  relative error of at most 1e-8; layer 0 runs K4 and K3's plain versions, the deeper layers
  the generic per-column attention and K3's. With ``value_bf16`` in float32 within 1e-2.
* ``perceiver_resampler_apply`` with ``residual_latent`` True and False.
* A resampler whose ``to_kv`` / ``to_out`` hold biases (no config makes them; the JAX function
  reads them where the tree has them) at depth 1 and 2.
* ``perceiver_core_plain`` with ``bk``/``bv``/``bout``, with and without ``ln_k`` and
  ``value_bf16``, against ``perceiver_core_fused`` with the same biases in interpret mode:
  f32 within 1e-5, bf16 values within 1e-2 (the bars of ``tests/test_torch_kernels.py``); and
  the kernels' arithmetic with the biases (``perceiver_core_mirror``: ``bk`` folded into one
  logit bias and, with ``ln_k``, centred into the sums of squares) against the plain version.
* ``Decoder._deaggregate`` under ``deagg_bf16``: bf16 to the heads at depth 1, float32 at
  depth 2, as the JAX package's.
* The launches: each resampler's K4 and its K3 a layer, as
  ``tools.train_bench.resampler_launches`` derives them (with ``separate_perceiver`` too), and
  a LoRA train step's at depth 2 as ``expected_launches`` derives them.
* The gradient of a depth-2 resampler (its parameters and the context, as the LoRA step's
  backward reaches the decoder's de-aggregation) against ``jax.grad``.
* The small model (``SMALL_ARCH``) at ``enc_depth = dec_depth = 2``: its forward against the
  JAX model's, and a reference-format state dict (``reference_state_dict``) converted by both
  packages, equal bit for bit and loaded into the port. The air-pollution model at
  ``dec_depth = 2`` is in ``tests/test_torch_deep_resampler_variants.py``.

Parameter trees are numpy-seeded on ``jax.eval_shape`` structures; the one JAX compile of the
file is the small model's forward.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.model.perceiver import perceiver_resampler_apply
from aurora_tpu.model.perceiver import perceiver_resampler_init
from aurora_tpu.model.perceiver import resampler_shared_query_apply
from aurora_tpu.ops.resampler import make_q_major_blockdiag, perceiver_core_fused
from aurora_tpu_torch.convert import load_numpy_params
from aurora_tpu_torch.model.nn import Linear
from aurora_tpu_torch.model.perceiver import PerceiverResampler
from aurora_tpu_torch.model.perceiver import perceiver_resampler_apply as t_generic
from aurora_tpu_torch.model.perceiver import resampler_shared_query_apply as t_apply
from aurora_tpu_torch.ops.resampler import perceiver_core
from tests.conftest import make_batch
from tests.test_torch_support import (
    SMALL_ARCH,
    max_rel,
    mean_rel,
    numpy_tree,
    seeded_matched_models,
    torch_batch,
)

BAR = 1e-8
D, H = 64, 4
GEOMETRIES = {"aggregation": (13, 3), "deaggregation": (3, 13)}  # (K, Q)

# The JAX functions compiled (eager dispatch of their ops costs seconds a call on the CPU).
j_apply = jax.jit(resampler_shared_query_apply, static_argnums=(3,),
                  static_argnames=("k_major", "value_bf16"))
j_generic = jax.jit(perceiver_resampler_apply, static_argnums=(3,),
                    static_argnames=("residual_latent",))
j_core = jax.jit(functools.partial(perceiver_core_fused, interpret=True),
                 static_argnames=("num_heads", "scale", "value_bf16"))


def _tree(depth, ln_k_q=False, biases=False, seed=0, dtype=jnp.float64):
    """A numpy-seeded resampler tree: weights N(0, 0.1), LayerNorm affines 1 + N(0, 0.1) and
    N(0, 0.1); with ``biases`` every layer's ``to_kv`` and ``to_out`` hold N(0, 0.3) biases."""
    shapes = jax.eval_shape(lambda: perceiver_resampler_init(
        jax.random.PRNGKey(0), D, D, depth=depth, head_dim=D // H, num_heads=H,
        ln_k_q=ln_k_q, dtype=dtype))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        keys = jax.tree_util.keystr(path)
        x = 0.1 * rng.standard_normal(s.shape)
        if "ln" in keys and keys.endswith("['weight']"):
            x = 1 + x
        return jnp.asarray(x, s.dtype)

    p = jax.tree_util.tree_map_with_path(leaf, shapes)
    if biases:
        for layer in p["layers"]:
            for name in ("to_kv", "to_out"):
                n = layer["attn"][name]["weight"].shape[1]
                layer["attn"][name]["bias"] = jnp.asarray(0.3 * rng.standard_normal(n), dtype)
    return p


def _port(p, depth, ln_k_q=False, dtype=torch.float64):
    tm = PerceiverResampler(D, D, depth=depth, head_dim=D // H, num_heads=H, ln_k_q=ln_k_q,
                            device="cpu", dtype=dtype)
    for i, layer in enumerate(p["layers"]):  # the biases no config creates, where the tree
        for name in ("to_kv", "to_out"):    # holds them
            if "bias" in layer["attn"][name]:
                lin = getattr(tm.layers[i].attn, name)
                lin.bias = torch.nn.Parameter(torch.zeros(lin.weight.shape[1], dtype=dtype))
    return load_numpy_params(tm, numpy_tree(p))


def _inputs(K, Q, M=24, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((Q, D)), rng.standard_normal((K, M, D))


@pytest.mark.parametrize("ln_k_q", [False, True], ids=["plain", "ln_k_q"])
@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("depth", [2, 3])
def test_deep_shared_query_resampler_matches_f64(depth, geometry, ln_k_q):
    K, Q = GEOMETRIES[geometry]
    p = _tree(depth, ln_k_q)
    queries, ctx = _inputs(K, Q)
    want = j_apply(p, jnp.asarray(queries), jnp.asarray(ctx), H, k_major=True)
    got = t_apply(_port(p, depth, ln_k_q), torch.from_numpy(queries),
                                       torch.from_numpy(ctx))
    assert got.shape == want.shape == (ctx.shape[1], Q, D)
    assert mean_rel(got, want) <= BAR
    # The deeper layers are exercised: depth 1 of the same tree is another result.
    one = t_apply(_port(dict(layers=p["layers"][:1]), 1, ln_k_q),
                                       torch.from_numpy(queries), torch.from_numpy(ctx))
    assert mean_rel(one, want) > 1e-2


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_deep_value_bf16_matches_f32(geometry):
    """Under ``value_bf16`` layer 0's value path is bf16 and the deeper layers run in float32
    on the f32 layer-0 result, as the JAX package's: a float32 result."""
    K, Q = GEOMETRIES[geometry]
    p = _tree(2, dtype=jnp.float32)
    queries, ctx = (a.astype(np.float32) for a in _inputs(K, Q))
    want = j_apply(p, jnp.asarray(queries), jnp.asarray(ctx), H, k_major=True,
                   value_bf16=True)
    got = t_apply(_port(p, 2, dtype=torch.float32),
                                       torch.from_numpy(queries), torch.from_numpy(ctx),
                                       value_bf16=True)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert mean_rel(got, want) <= 1e-2


@pytest.mark.parametrize("residual_latent", [True, False])
def test_generic_resampler_matches_f64(residual_latent):
    p = _tree(2, ln_k_q=True)
    rng = np.random.default_rng(4)
    latents, x = rng.standard_normal((24, 3, D)), rng.standard_normal((24, 13, D))
    want = j_generic(p, jnp.asarray(latents), jnp.asarray(x), H,
                     residual_latent=residual_latent)
    got = t_generic(_port(p, 2, ln_k_q=True), torch.from_numpy(latents),
                                    torch.from_numpy(x), residual_latent=residual_latent)
    assert mean_rel(got, want) <= BAR


@pytest.mark.parametrize("ln_k_q", [False, True], ids=["plain", "ln_k_q"])
@pytest.mark.parametrize("depth", [1, 2])
def test_resampler_with_biases_matches_f64(depth, ln_k_q):
    """``shared_query_core_args`` hands K4 the biases of ``to_kv`` / ``to_out``; the deeper
    layers' ``Linear`` modules add their own."""
    p = _tree(depth, ln_k_q, biases=True)
    tm = _port(p, depth, ln_k_q)
    assert isinstance(tm.layers[0].attn.to_kv, Linear) and tm.layers[0].attn.to_kv.bias is not None
    queries, ctx = _inputs(13, 3)
    want = j_apply(p, jnp.asarray(queries), jnp.asarray(ctx), H, k_major=True)
    got = t_apply(tm, torch.from_numpy(queries), torch.from_numpy(ctx))
    assert mean_rel(got, want) <= BAR
    bare = t_apply(_port(_tree(depth, ln_k_q), depth, ln_k_q),
                                        torch.from_numpy(queries), torch.from_numpy(ctx))
    assert mean_rel(bare, want) > 1e-3  # the biases moved the result


def _core_inputs(K, Q, seed=5):
    rng = np.random.default_rng(seed)
    M, Dc, h = 64, 32, 4
    dh = Dc // h
    a = dict(
        ctx=rng.standard_normal((K, M, Dc)),
        wk=0.3 * rng.standard_normal((Dc, Dc)), wv=0.3 * rng.standard_normal((Dc, Dc)),
        qh=rng.standard_normal((Q, h, dh)), wout=0.3 * rng.standard_normal((Dc, Dc)),
        ln1_w=1 + 0.1 * rng.standard_normal(Dc), ln1_b=0.1 * rng.standard_normal(Dc),
        queries=rng.standard_normal((Q, Dc)),
    )
    lnk = (1 + 0.2 * rng.standard_normal(Dc), 0.2 * rng.standard_normal(Dc))
    b = dict(bk=0.5 * rng.standard_normal(Dc), bv=0.5 * rng.standard_normal(Dc),
             bout=0.5 * rng.standard_normal(Dc))
    return a, lnk, b, h, dh


@pytest.mark.parametrize("value_bf16", [False, True], ids=["f32", "bf16_values"])
@pytest.mark.parametrize("with_lnk", [False, True], ids=["plain_k", "ln_k"])
@pytest.mark.parametrize("K,Q", [(5, 3), (3, 5)])
def test_perceiver_core_biases_match_pallas(K, Q, with_lnk, value_bf16):
    a, lnk, b, h, dh = _core_inputs(K, Q)
    j = {k: jnp.asarray(v, jnp.float32) for k, v in {**a, **b}.items()}
    jl = tuple(jnp.asarray(v, jnp.float32) for v in lnk) if with_lnk else (None, None)
    want = j_core(
        j["ctx"], j["wk"], j["bk"], j["wv"], j["bv"], make_q_major_blockdiag(j["qh"], h),
        j["wout"], j["bout"], j["ln1_w"], j["ln1_b"], j["queries"], *jl, num_heads=h,
        scale=dh**-0.5, value_bf16=value_bf16,
    )
    t = {k: torch.from_numpy(v).float() for k, v in a.items()}
    tb = {k: torch.from_numpy(v).float() for k, v in b.items()}
    tl = tuple(torch.from_numpy(v).float() for v in lnk) if with_lnk else None
    got = perceiver_core(**t, **tb, scale=dh**-0.5, value_bf16=value_bf16, lnk=tl)
    assert got.dtype == (torch.bfloat16 if value_bf16 else torch.float32)
    assert max_rel(got, want) < (1e-2 if value_bf16 else 1e-5)
    bare = perceiver_core(**t, scale=dh**-0.5, value_bf16=value_bf16, lnk=tl)
    assert max_rel(bare, want) > 2e-2  # the biases are exercised


def test_deep_resampler_gradient_matches_jax_grad():
    """The gradients of ``sum(out * g)`` for every parameter of a depth-2 resampler and for
    the context (the de-aggregation geometry), against ``jax.grad`` in float64."""
    from aurora_tpu_torch.convert import flatten_tree

    K, Q = GEOMETRIES["deaggregation"]
    p = _tree(2)
    queries, ctx = _inputs(K, Q, M=16)
    g = np.random.default_rng(7).standard_normal((ctx.shape[1], Q, D))

    def loss(p, c):
        return jnp.sum(j_apply(p, jnp.asarray(queries), c, H, k_major=True) * g)

    jp, jc = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, jnp.asarray(ctx))
    tm = _port(p, 2)
    tc = torch.from_numpy(ctx).requires_grad_(True)
    out = t_apply(tm, torch.from_numpy(queries), tc)
    (out * torch.from_numpy(g)).sum().backward()
    assert mean_rel(tc.grad, jc) <= BAR
    want = flatten_tree(numpy_tree(jp))
    got = {n: q.grad for n, q in tm.named_parameters()}
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        assert mean_rel(got[n], w) <= BAR, n
    assert any(n.startswith("layers.1.") and np.abs(w).max() > 0 for n, w in want.items())


# ------------------------------------------------------------------------------ whole models

DEEP = dict(SMALL_ARCH, enc_depth=2, dec_depth=2)


@pytest.fixture(scope="module")
def deep_small():
    return seeded_matched_models(DEEP)


def test_small_model_depth2_forward_matches_f64(deep_small):
    jm, params, tm = deep_small
    assert len(tm.encoder.level_agg.layers) == len(tm.decoder.level_decoder.layers) == 2
    batch = make_batch(H=17, W=32, levels=(100, 250, 500, 850))
    want, got = jm.forward(params, batch), tm(torch_batch(batch))
    for group in ("surf_vars", "atmos_vars"):
        w, g = getattr(want, group), getattr(got, group)
        assert set(w) == set(g)
        for k in w:
            assert mean_rel(g[k], w[k]) <= BAR, (k, mean_rel(g[k], w[k]))


def test_depth2_reference_checkpoint_matches_jax_bit_for_bit(deep_small):
    """``level_agg.layers.1.<0-3>.*`` and ``level_decoder.layers.1.*`` map through both
    converters to the same tree, and the port's model loads it with no leaf left over."""
    from aurora_tpu import checkpoint as jck
    from aurora_tpu_torch import checkpoint as tck
    from aurora_tpu_torch.convert import flatten_tree, params_from_numpy
    from tests.test_torch_support import port_config, reference_state_dict

    jm, params, _ = deep_small
    sd = reference_state_dict(params)
    assert any(k.startswith("encoder.level_agg.layers.1.0.") for k in sd)
    assert any(k.startswith("decoder.level_decoder.layers.1.3.") for k in sd)
    want = flatten_tree(numpy_tree(jck.convert_reference_checkpoint(sd, jm.cfg)))
    got = flatten_tree(tck.convert_reference_checkpoint(sd, port_config(jm.cfg)))
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    model = params_from_numpy(got, port_config(jm.cfg), device="cpu", dtype=torch.float64)
    state = model.state_dict()
    for k in want:
        assert np.array_equal(state[k].numpy(), np.asarray(want[k], np.float64)), k


# ------------------------------------------------------------------------------ launches


def _counted(monkeypatch):
    """Count the calls of each kernel wrapper (the launches on the card) made through the
    backbone's and the perceiver's modules."""
    import collections

    from aurora_tpu_torch.model import perceiver, swin3d

    counts = collections.Counter()
    keys = {"roll3d": "roll3d", "window_attention_tail": "window_attention",
            "mlp_adaln_residual": "mlp_adaln_residual", "perceiver_core": "perceiver_core"}
    for module, name in [(swin3d, "roll3d"), (swin3d, "window_attention_tail"),
                         (swin3d, "mlp_adaln_residual"), (perceiver, "perceiver_core"),
                         (perceiver, "mlp_adaln_residual")]:
        def counted(*a, _f=getattr(module, name), _k=keys[name], **kw):
            counts[_k] += 1
            return _f(*a, **kw)

        monkeypatch.setattr(module, name, counted)
    return counts


@pytest.mark.parametrize("separate", [False, True], ids=["one_decoder", "separate_perceiver"])
def test_resampler_launches_are_the_wrappers_calls(monkeypatch, separate):
    """A forward's resampler calls: K4 once a resampler, K3 once a resampler layer, as
    ``tools.train_bench.resampler_launches`` derives them."""
    from aurora_tpu_torch.model.aurora import Aurora
    from aurora_tpu_torch.model.config import AuroraConfig
    from aurora_tpu_torch.tools.train_bench import resampler_launches
    from aurora_tpu_torch.tools.perf_breakdown import numpy_batch

    cfg = AuroraConfig(**dict(SMALL_ARCH, enc_depth=2, dec_depth=3),
                       separate_perceiver=("q",) if separate else ())
    model = Aurora(cfg, device="cpu", seed=0)
    counts = _counted(monkeypatch)
    with torch.no_grad():
        model(numpy_batch(cfg, 16, 32, levels=(100, 250, 500, 850)))
    want = resampler_launches(cfg)
    assert want == {"perceiver_core": 3 if separate else 2,
                    "mlp_adaln_residual": 2 + 3 * (2 if separate else 1)}
    blocks = sum(cfg.encoder_depths) + sum(cfg.decoder_depths)
    assert counts["perceiver_core"] == want["perceiver_core"]
    assert counts["mlp_adaln_residual"] == want["mlp_adaln_residual"] + blocks


def test_train_step_launches_at_depth_2(monkeypatch):
    """``expected_launches`` of a LoRA train step (remat "full") at ``enc_depth = dec_depth =
    2`` equal the wrappers' calls of ``tools.train_bench`` on the CPU (a warm-up and one
    timed update, halved), as ``tests/test_torch_training.py`` holds them at depth 1."""
    import contextlib
    import io

    from aurora_tpu_torch.model.config import AuroraConfig
    from aurora_tpu_torch.tools import train_bench

    tiny = AuroraConfig(embed_dim=64, num_heads=4, encoder_depths=(2, 2), decoder_depths=(2, 2),
                        encoder_num_heads=(2, 4), decoder_num_heads=(4, 2), use_lora=True,
                        enc_depth=2, dec_depth=2)
    counts = _counted(monkeypatch)
    cfg = train_bench.train_config(tiny, remat=True, remat_scope="full")
    model = train_bench.build(cfg, torch.device("cpu"), "lora")
    with contextlib.redirect_stdout(io.StringIO()):
        out = train_bench.main(["--device", "cpu", "--H", "17", "--W", "32", "--steps", "1",
                                "--mode", "lora"], model=model)
    want = dict(out["expected_launches"])
    want.pop("roll3d_bwd")
    # K3's input gradient: every block and the decoder's first layer (the deeper layers run
    # in float32).
    blocks = sum(tiny.encoder_depths + tiny.decoder_depths)
    assert want.pop("mlp_adaln_residual_grad") == blocks + 1
    assert {k: v // 2 for k, v in counts.items()} == want
    at_depth1 = train_bench.expected_launches(cfg.replace(enc_depth=1, dec_depth=1), lora=True)
    # LoRA: the encoder runs once, the decoder twice (its replay under remat "full").
    assert want["mlp_adaln_residual"] - at_depth1["mlp_adaln_residual"] == 1 + 2
    assert want["perceiver_core"] == at_depth1["perceiver_core"]


# ------------------------------------------------------------------------------ K4's fold


@pytest.mark.parametrize("form", ["f64", "f32", "bf16"])
@pytest.mark.parametrize("with_lnk", [False, True], ids=["plain_k", "ln_k"])
@pytest.mark.parametrize("K,dh", [(13, 32), (3, 64)], ids=["agg", "de-agg"])
def test_mirror_with_biases_equals_the_plain_version(K, dh, with_lnk, form):
    """K4's kernels' arithmetic with the bias inputs (``perceiver_core_mirror``: ``bk`` folded
    into the logits' bias and, with ``ln_k``, centred into the sums of squares; ``bv`` and
    ``bout`` in the epilogues) against ``perceiver_core_plain`` with the biases: 1e-12 in
    float64, the branch error 1e-5 in f32 and 1e-2 with bf16 values, over chunks of columns."""
    from aurora_tpu_torch.ops import resampler
    from aurora_tpu_torch.tools import branch_err
    from tests.test_torch_resampler_redesign import _inputs as k4_inputs
    from tests.test_torch_resampler_redesign import perceiver_core_mirror

    dtype = torch.float64 if form == "f64" else torch.float32
    a, lnk = k4_inputs(K, dh, dtype)
    Q, h, _ = a["qh"].shape
    inner = h * dh
    rng = np.random.default_rng(9)
    b = {k: torch.from_numpy(rng.standard_normal(n)).to(dtype)
         for k, n in (("bk", inner), ("bv", inner), ("bout", inner))}
    kw = dict(scale=dh**-0.5, value_bf16=form == "bf16", lnk=lnk if with_lnk else None)
    cap = 130 * resampler.perceiver_column_bytes(K, inner, inner, Q, h, inner, with_lnk)
    want = resampler.perceiver_core_plain(**a, **kw, **b)
    got = perceiver_core_mirror(**a, **kw, cap=cap, **b)
    assert got.dtype == want.dtype and got.shape == want.shape
    if form == "f64":
        assert (got - want).abs().max().item() <= 1e-12 * want.abs().max().item()
    else:
        err = branch_err(got, want, a["queries"][None])[1]
        assert err <= (1e-5 if form == "f32" else 1e-2), err
    bare = perceiver_core_mirror(**a, **kw, cap=cap)
    assert branch_err(bare, want, a["queries"][None])[1] > 2e-2  # the biases are exercised


@pytest.mark.parametrize("depth", [1, 2])
def test_deaggregate_dtype_follows_jax_under_deagg_bf16(depth):
    """``Decoder._deaggregate`` under ``deagg_bf16`` hands the heads bf16 at depth 1 and the
    deeper layers' float32 at depth 2, as the JAX package's ``_deaggregate`` does."""
    import types

    from aurora_tpu.model.config import AuroraConfig as JaxConfig
    from aurora_tpu.model.decoder import _deaggregate as j_deaggregate
    from aurora_tpu_torch.model.config import AuroraConfig
    from aurora_tpu_torch.model.decoder import Decoder

    p = _tree(depth, dtype=jnp.float32)
    rng = np.random.default_rng(12)
    le = rng.standard_normal((13, D)).astype(np.float32)
    x = rng.standard_normal((1, 3, 20, D)).astype(np.float32)  # (B, C', L, D), level-major
    want = jax.jit(j_deaggregate, static_argnums=(3,))(
        p, jnp.asarray(le), jnp.asarray(x), JaxConfig(embed_dim=D // 2, num_heads=H,
                                                      deagg_bf16=True))
    dec = types.SimpleNamespace(cfg=AuroraConfig(embed_dim=D // 2, num_heads=H, deagg_bf16=True),
                                level_decoder=_port(p, depth, dtype=torch.float32))
    got = Decoder._deaggregate(dec, torch.from_numpy(le), torch.from_numpy(x))
    assert str(want.dtype) == ("bfloat16" if depth == 1 else "float32")
    assert got.dtype == (torch.bfloat16 if depth == 1 else torch.float32)
    assert got.shape == want.shape == (1, 20, 13, D)
    assert mean_rel(got, want) <= 1e-2
