"""The small model (``AuroraSmallPretrained``, D = 256) on the kernels' path, on the CPU.

Its forward with the production knobs at full width and depth, each kernel wrapper's call
counted and its shapes put through the shape rule the card's kernel checks: every call is a
shape the kernel takes, and the calls a step are the launches ``chip_smoke.py`` derives from
the code (``SMALL_RUN``; at D = 256, ``SMALL_D256``) and holds the card's roll-out to. A width
between those taken is still refused. The float64 forward against the JAX package is
``tests/test_torch_variants_wave.py::test_small_pretrained_forward_matches_f64_on_the_cpu``.
"""

import collections

import numpy as np
import pytest
import torch

import chip_smoke
from aurora_tpu_torch import AuroraSmallPretrained, cast_backbone_params
from aurora_tpu_torch.model import perceiver, swin3d
from aurora_tpu_torch.ops import mlp, resampler, window_attention
from aurora_tpu_torch.tools import variant_bench
from aurora_tpu_torch.tools.perf_breakdown import PRODUCTION


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, the caller's count restored after (the suite runs six workers
    at once; see ``tests/test_torch_training.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _checked(monkeypatch) -> tuple[collections.Counter, collections.Counter]:
    """Count each kernel wrapper's calls (all, and those with 256-wide output rows) and put
    every call's shapes through its kernel's shape rule (a ``ValueError`` fails the test)."""
    calls, wide = collections.Counter(), collections.Counter()

    def attn_rule(xp, wqkv, bqkv, groups, ws, heads, *a, **kw):
        window_attention.check_window_attention_shape(tuple(xp.shape), heads, ws)

    def mlp_rule(x, w1, *a, **kw):
        mlp.check_mlp_shape(x.numel() // x.shape[-1], x.shape[-1], w1.shape[1])

    def perceiver_rule(ctx, wk, wv, qh, wout, *a, **kw):
        K, M, D = ctx.shape
        Q, h, dh = qh.shape
        resampler.check_perceiver_shape(K, M, D, h, dh, Q, wout.shape[1],
                                        kw.get("value_bf16", False))

    for module, name, key, rule in [
        (swin3d, "roll3d", "roll3d", None),
        (swin3d, "window_attention_tail", "window_attention", attn_rule),
        (swin3d, "mlp_adaln_residual", "mlp_adaln_residual", mlp_rule),
        (perceiver, "mlp_adaln_residual", "mlp_adaln_residual", mlp_rule),
        (perceiver, "perceiver_core", "perceiver_core", perceiver_rule),
    ]:
        def counted(*a, _f=getattr(module, name), _k=key, _rule=rule, **kw):
            if _rule is not None:
                _rule(*a, **kw)
            out = _f(*a, **kw)
            calls[_k] += 1
            wide[_k] += out.shape[-1] == 256 and _k != "roll3d"
            return out

        monkeypatch.setattr(module, name, counted)
    return calls, wide


def test_small_model_launches_are_the_derived_counts(monkeypatch):
    """One step of ``AuroraSmallPretrained`` with the production knobs (seeded, gates open, the
    backbone in bf16) on a 97 x 192 grid (the window fits every stage): K1 20, K2 20, K3 22,
    K4 2 calls, of which K2 4, K3 5 and K4 1 at D = 256, every one a shape its kernel
    takes."""
    model = variant_bench.build_variant(AuroraSmallPretrained, "cpu")
    assert model.cfg.embed_dim == 256 and all(
        getattr(model.cfg, k) == v for k, v in PRODUCTION.items())
    assert next(model.backbone.parameters()).dtype == torch.bfloat16
    calls, wide = _checked(monkeypatch)
    pred = model(variant_bench.raw_batch(model.cfg, 97, 192))
    assert dict(calls) == chip_smoke.SMALL_RUN
    assert {k: v for k, v in wide.items() if v} == chip_smoke.SMALL_D256
    assert chip_smoke.SMALL_RUN == {"roll3d": 20, "window_attention": 20,
                                    "mlp_adaln_residual": 22, "perceiver_core": 2}
    assert chip_smoke.SMALL_D256 == {"window_attention": 4, "mlp_adaln_residual": 5,
                                     "perceiver_core": 1}
    assert all(np.isfinite(v.float().numpy()).all() for v in pred.surf_vars.values())


def test_a_width_between_the_taken_ones_is_refused(monkeypatch):
    """The small model's config at D = 384: its first kernel call (the level aggregation's K4)
    is refused by the shape rule, as the card's wrapper would refuse it before any launch."""
    cfg = AuroraSmallPretrained.default_config().replace(
        embed_dim=384, num_heads=12, encoder_num_heads=(6, 12, 24),
        decoder_num_heads=(24, 12, 6), **PRODUCTION)
    # No init: the rule refuses the shapes before any value is used.
    model = cast_backbone_params(AuroraSmallPretrained(cfg, device="cpu", seed=None))
    _checked(monkeypatch)
    with pytest.raises(ValueError, match="D=384"):
        model(variant_bench.raw_batch(cfg, 97, 192))
