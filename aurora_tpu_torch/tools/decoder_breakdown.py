"""Decoder timing at the main path's width: where does the decoder's time go on the card?

Counterpart of ``tools/decoder_breakdown.py``, with its labels. Times the parts of the
production model's :class:`~aurora_tpu_torch.model.decoder.Decoder` (as
:mod:`~aurora_tpu_torch.tools.perf_breakdown` builds it) on seeded random inputs of the
shapes the step gives them:

  deaggregate FULL                the latent levels to the 13 pressure levels in the
                                  production bf16 form (``deagg_bf16``): K4, then K3
    K4 perceiver_core             the cross-attention core alone (K4's launches)
    K4 [only_logits] ... [only_tail]   on the card, K4's launches one by one: ablated
                                  builds of ``csrc/resampler.cu`` (as
                                  :mod:`~aurora_tpu_torch.tools.kernel_ablate` makes them),
                                  each on what the scratch holds
    K3 MLP half                   the MLP, LayerNorm and residual on K4's result
  fused atmos head GEMM           the stacked heads of the 5 variables as the decoder runs
                                  them on the de-aggregation's output
  unpatchify (13 levels)          patch pixels to fields
  input rearrange (C,L)->(L,C)    the level-major tokens made token-major: the relayout the
                                  de-aggregation avoids by reading level-major

The JAX tool splits its plain de-aggregation into ``kv GEMM only``, ``attention core`` and
``out-proj + LN + MLP chain``. The port runs it as K4 + K3, so its rows split K4 into its
launches by name instead: ``only_logits`` (the fold and the f32 logits pass: k's half of the
kv product, with the logits) and ``only_v`` (v's half) for the kv GEMM, ``only_mix`` (the
softmax and the level-order sum) for the attention core, ``only_tail`` (the out-projection
and the LayerNorm row kernel) and the K3 row for the chain. Dropped: the JAX tool's
``deaggregate FULL bf16`` (an all-bf16 form the port does not run), ``unpatchify bf16
shuffle`` and ``unpatchify C-in-lanes`` (TPU layouts with no counterpart here), and its note
that part of each time is the round trip to a remote TPU. Every row carries the kernel
launches of one call of its part. Times: ``tools.time_ms`` (CUDA events on the card, the host
clock on the CPU), medians of ``--steps`` runs after warm-up.

Usage: ``python -m aurora_tpu_torch.tools.decoder_breakdown [--device cpu] [--steps N]
[--H 720 --W 1440]``. The JAX tool fixes the grid at 720 x 1440; here it is a flag, so a
test can run the tool small. ``main(argv, cfg=...)`` takes another config,
``main(argv, model=...)`` a model already built.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from aurora_tpu_torch.model.aurora import Aurora
from aurora_tpu_torch.model.config import AuroraConfig
from aurora_tpu_torch.model.decoder import _head_linear, _stack_heads, unpatchify
from aurora_tpu_torch.model.perceiver import shared_query_core_args, shared_query_mlp
from aurora_tpu_torch.ops import resampler
from aurora_tpu_torch.tools import card_line, report
from aurora_tpu_torch.tools.perf_breakdown import LEVELS, time_parts, tool_args, tool_model

# K4's launches one by one: the ablated builds of csrc/resampler.cu (tools/kernel_ablate.py).
K4_PARTS = {"only_logits": ("ABLATE_ONLY_LOGITS",), "only_v": ("ABLATE_ONLY_V",),
            "only_mix": ("ABLATE_ONLY_MIX",), "only_tail": ("ABLATE_ONLY_TAIL",)}


def decoder_inputs(model: Aurora, H: int, W: int, gen: torch.Generator,
                   C_A: int = len(LEVELS)) -> dict:
    """Random float32 inputs of every part on the model's device, batch 1: the backbone's
    level-major latent levels ``ctx (1, C_l - 1, L, D)``, the level embeddings ``le (C_A, D)``
    (the de-aggregation's queries), the de-aggregated tokens ``lat (1, L, C_A, D)`` in the
    dtype the de-aggregation returns, the heads' output ``xa (1, L, C_A, P P V)`` and the
    backbone's tokens ``x (1, C_l L, D)``."""
    cfg = model.cfg
    P, D, V = cfg.patch_size, cfg.decoder_embed_dim, len(cfg.atmos_vars)
    L = (H // P) * (W // P)
    dev, f32 = model.device, torch.float32

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=f32)

    return dict(
        ctx=rn(1, cfg.latent_levels - 1, L, D),
        le=rn(C_A, D),
        lat=rn(1, L, C_A, D).to(torch.bfloat16 if cfg.deagg_bf16 else f32),
        xa=rn(1, L, C_A, P * P * V),
        x=rn(1, cfg.latent_levels * L, D),
        HW=(H, W),
    )


def decoder_parts(model: Aurora, inputs: dict,
                  k4_libs: Optional[dict] = None) -> dict[str, Callable[[], object]]:
    """The decoder's parts on ``inputs`` (the keys of :func:`decoder_inputs`), each a callable
    of no arguments that runs the model's own modules and kernels; with ``k4_libs`` (the
    ablated builds of :data:`K4_PARTS`) also K4's launches one by one."""
    dec, cfg = model.decoder, model.cfg
    i = inputs
    H, W = i["HW"]
    P, C_l = cfg.patch_size, cfg.latent_levels
    Cp, L, D = i["ctx"].shape[1:]
    atmos = tuple(cfg.atmos_vars)
    # The de-aggregation's K4 call on the k-major context, as Decoder._deaggregate makes it.
    value_bf16 = bool(cfg.deagg_bf16) and i["ctx"].dtype == torch.float32
    with torch.no_grad():
        args, kw = shared_query_core_args(dec.level_decoder, i["le"], i["ctx"].reshape(Cp, L, D),
                                          cfg.perceiver_ln_eps, value_bf16)
        lat = resampler.perceiver_core(*args, **kw)
    parts = {
        "deaggregate FULL": lambda: dec._deaggregate(i["le"], i["ctx"]),
        "  K4 perceiver_core": lambda: resampler.perceiver_core(*args, **kw),
    }
    for tag, lib in (k4_libs or {}).items():
        fn = lib.perceiver_core
        fn.argtypes, fn.restype = resampler._PERCEIVER_CORE_ARGS, ctypes.c_int
        parts[f"  K4 [{tag}]"] = lambda fn=fn: resampler._perceiver_core_call(
            fn, *args, kw["scale"], kw["ln_eps"], kw["value_bf16"], kw["lnk"])
    parts.update({
        "  K3 MLP half": lambda: shared_query_mlp(dec.level_decoder, lat, cfg.perceiver_ln_eps),
        "fused atmos head GEMM": lambda: _head_linear(i["lat"], *_stack_heads(dec.atmos_heads,
                                                                              atmos)),
        "unpatchify (13 levels)": lambda: unpatchify(i["xa"], len(atmos), H, W, P),
        "input rearrange (C,L)->(L,C)":
            lambda: i["x"].reshape(1, C_l, L, D).transpose(1, 2).contiguous(),
    })
    return {k: torch.no_grad()(f) for k, f in parts.items()}


def main(argv=None, *, cfg: Optional[AuroraConfig] = None,
         model: Optional[Aurora] = None) -> list[dict]:
    args = tool_args(argv, __doc__, steps=3, H=720)
    dev, model = tool_model(args.device, cfg, model)
    P = model.cfg.patch_size
    L = (args.H // P) * (args.W // P)
    print(f"device {card_line(dev)}; L={L}, D={model.cfg.decoder_embed_dim}, C_A={len(LEVELS)}",
          flush=True)
    k4_libs = None
    if dev.type == "cuda":  # K4's launches one by one need the ablated builds
        from aurora_tpu_torch.tools.kernel_ablate import build_variants

        k4_libs = build_variants("resampler", K4_PARTS)
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = decoder_inputs(model, args.H, args.W, gen)
    rows = time_parts(decoder_parts(model, inputs, k4_libs), dev, args.steps)
    del inputs
    for r in rows:
        report(r)
    return rows


if __name__ == "__main__":
    main()
