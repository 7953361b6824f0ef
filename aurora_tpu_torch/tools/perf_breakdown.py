"""Per-part timing of the main step: where do the time of one forward step and of its
encoder, backbone and decoder go on the card?

Counterpart of ``tools/perf_breakdown.py``, with its labels. Builds the production model
(``LARGE_CONFIG`` with LoRA, the backbone in bf16 under ``autocast`` with bf16-stored
weights, bf16 values in the level aggregation and de-aggregation; seeded random weights with
the FiLM modulations and LoRA ``B`` opened) and a seeded batch of 13 levels, history 2, then
times each part on its inputs as the step hands them over:

  prepare_encodings               ``Aurora.prepare_encodings`` as every step runs it: the
                                  grid's constants from the model's device copy, the step's
                                  absolute time (host float64, rounded to float32) uploaded
  batch upload                    ``Batch.to`` of the batch as a steady roll-out step gets
                                  it: every field on the card, uploaded once by ``rollout``
  batch upload (host arrays, first step)   the same of the caller's host arrays
  Aurora.forward (whole step)     what a steady roll-out step runs: prepare_encodings, the
                                  batch upload, forward_core and the returned batch
  forward_core (device-resident)  ``Aurora.forward_core`` on uploaded inputs and encodings,
                                  with grid points per second
  encoder                         ``Encoder`` alone (on the un-normalised inputs, as the JAX
                                  tool feeds it)
  backbone (bf16)                 ``Backbone`` alone on the encoder's tokens
  decoder                         ``Decoder`` alone on the backbone's tokens
  sum enc+bb+dec                  the three above against forward_core

The JAX tool prepares the encodings and uploads the inputs outside its timed region; here
they are two rows, so a step less forward_core is measured, not derived. Every row carries
the kernel launches of one call of its part (``ops._lib.LAUNCHES``). Times: ``tools.time_ms``
(CUDA events on the card, the host clock on the CPU), medians of ``--steps`` runs after
warm-up.

Usage: ``python -m aurora_tpu_torch.tools.perf_breakdown [--device cpu] [--steps N]
[--H 721 --W 1440]``. ``main(argv, cfg=...)`` takes another
:class:`~aurora_tpu_torch.model.config.AuroraConfig` (the production knobs are set on it),
``main(argv, model=...)`` a model already built.
"""

from __future__ import annotations

import argparse
from datetime import datetime
from typing import Callable, Optional

import numpy as np
import torch

from aurora_tpu_torch.batch import Batch, Metadata
from aurora_tpu_torch.model.aurora import Aurora, cast_backbone_params, full_f32_products
from aurora_tpu_torch.model.config import LARGE_CONFIG, AuroraConfig
from aurora_tpu_torch.ops import _lib
from aurora_tpu_torch.tools import card_line, report, resolve_device, result, time_ms

LEVELS = (50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000)
PRODUCTION = dict(autocast=True, agg_bf16=True, deagg_bf16=True)


def production_config(cfg: Optional[AuroraConfig] = None) -> AuroraConfig:
    """``cfg`` (the 1.3 B model with LoRA by default) with the production knobs set."""
    return (cfg or LARGE_CONFIG.replace(use_lora=True)).replace(**PRODUCTION)


def config_form(cfg: AuroraConfig) -> str:
    """"production" (bf16 under ``autocast``) or "default" (float32 all through)."""
    return "production" if cfg.autocast or cfg.agg_bf16 or cfg.deagg_bf16 else "default"


def open_gates(model: Aurora, seed: int = 1, std: float = 0.05) -> None:
    """Seeded noise in every FiLM modulation weight and LoRA ``B``: at fresh init both are
    zero and every Swin block is an identity."""
    g = torch.Generator(device=model.device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ("modulation" in name and name.endswith("weight")) or name.endswith(".B"):
                p.copy_(torch.randn(p.shape, generator=g, device=p.device) * std)


def build_model(cfg: AuroraConfig, device, seed: int = 0) -> Aurora:
    """The model as the main path runs it: seeded weights, gates opened, the backbone stored
    in bf16 under ``autocast``."""
    model = Aurora(cfg, device=device, seed=seed)
    open_gates(model)
    if cfg.autocast:
        cast_backbone_params(model)
    return model


def numpy_batch(cfg: AuroraConfig, H: int, W: int, seed: int = 0, levels=LEVELS) -> Batch:
    """A seeded batch of host arrays: batch 1, history 2, ``len(levels)`` levels."""
    rng = np.random.default_rng(seed)
    return Batch(
        surf_vars={k: rng.standard_normal((1, 2, H, W)).astype(np.float32)
                   for k in cfg.surf_vars},
        static_vars={k: np.abs(rng.standard_normal((H, W))).astype(np.float32)
                     for k in cfg.static_vars},
        atmos_vars={k: rng.standard_normal((1, 2, len(levels), H, W)).astype(np.float32)
                    for k in cfg.atmos_vars},
        metadata=Metadata(
            lat=np.linspace(90, -90, H), lon=np.linspace(0, 360, W, endpoint=False),
            time=(datetime(2020, 6, 1, 12),), atmos_levels=tuple(levels),
        ),
    )


def step_parts(model: Aurora, batch: Batch) -> dict[str, Callable[[], object]]:
    """The parts of one step of ``model`` on ``batch``, each a callable of no arguments that
    runs the model's own code on the inputs the step hands it. The encoder's and the
    backbone's outputs, the backbone's and the decoder's inputs, are computed once here."""
    cfg = model.cfg
    P = cfg.patch_size
    dtype = model.compute_dtype
    enc_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
    crop = batch.crop(P)
    H, W = crop.spatial_shape
    patch_res = (cfg.latent_levels, H // P, W // P)
    levels = tuple(crop.metadata.atmos_levels)
    # A steady roll-out step's batch: every field on the card, as ``rollout`` uploads it once
    # and feeds the predictions back.
    steady = crop.to(model.device, dtype)
    with torch.no_grad():
        enc = model.prepare_encodings(steady, enc_dtype)
        b = steady.to(model.device, dtype)
        B, T = next(iter(b.surf_vars.values())).shape[:2]
        static = {k: v[None, None].expand(B, T, H, W) for k, v in b.static_vars.items()}
        surf_names, atmos_names = tuple(b.surf_vars), tuple(b.atmos_vars)

        def encoder():
            return model.encoder(b.surf_vars, static, b.atmos_vars, enc, levels)

        x = encoder()

        def backbone():
            if cfg.autocast:
                y = model.backbone(x.to(torch.bfloat16), enc.lead_time, 0, patch_res)
                return y.to(torch.float32)
            return model.backbone(x, enc.lead_time, 0, patch_res)

        y = backbone()
    parts = {
        "prepare_encodings": lambda: model.prepare_encodings(steady, enc_dtype),
        "batch upload": lambda: steady.to(model.device, dtype),
        "batch upload (host arrays, first step)": lambda: crop.to(model.device, dtype),
        "Aurora.forward (whole step)": lambda: model(steady),
        "forward_core (device-resident)": lambda: model.forward_core(
            b.surf_vars, b.static_vars, b.atmos_vars, enc, 0, levels),
        "encoder": encoder,
        "backbone (bf16)" if cfg.autocast else "backbone": backbone,
        "decoder": lambda: model.decoder(y, surf_names, atmos_names, enc.levels_dec, patch_res,
                                         H, W, levels),
    }
    return {k: torch.no_grad()(f) for k, f in parts.items()}


def time_parts(parts: dict, dev: torch.device, steps: int) -> list[dict]:
    """One printed row per part: its median time and the kernel launches of one call. The
    parts run with TF32 off, as inside the model's step (``full_f32_products``)."""
    with full_f32_products():
        return _time_parts(parts, dev, steps)


def _time_parts(parts: dict, dev: torch.device, steps: int) -> list[dict]:
    rows = []
    for label, fn in parts.items():
        before = dict(_lib.LAUNCHES)
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        launches = {k: n - before[k] for k, n in _lib.LAUNCHES.items() if n != before[k]}
        rows.append(result(label, time_ms(fn, dev, steps), dev, launches=launches))
    return rows


def tool_args(argv, doc: str, steps: int, H: int):
    """The flags the three breakdown tools share: ``--device``, ``--steps``, ``--H``/``--W``."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="the card unless 'cpu' is given")
    ap.add_argument("--steps", type=int, default=steps)
    ap.add_argument("--H", type=int, default=H)
    ap.add_argument("--W", type=int, default=1440)
    return ap.parse_args(argv)


def tool_model(device, cfg: Optional[AuroraConfig], model: Optional[Aurora]):
    """``(device, model)`` of a breakdown tool: ``model`` as given, which must lie on the
    device, else the production model built there."""
    dev = resolve_device(device)
    if model is None:
        return dev, build_model(production_config(cfg), dev)
    if model.device.type != dev.type:
        raise ValueError(f"the model is on {model.device}, the tool runs on {dev}")
    return dev, model


def main(argv=None, *, cfg: Optional[AuroraConfig] = None,
         model: Optional[Aurora] = None) -> list[dict]:
    args = tool_args(argv, __doc__, steps=5, H=721)
    dev, model = tool_model(args.device, cfg, model)
    cfg = model.cfg
    batch = numpy_batch(cfg, args.H, args.W)
    Hc, Wc = batch.crop(cfg.patch_size).spatial_shape
    print(f"device {card_line(dev)}; grid {args.H}x{args.W} ({Hc}x{Wc} after crop), "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B parameters", flush=True)
    rows = time_parts(step_parts(model, batch), dev, args.steps)
    ms = {r["label"]: r["ms"] for r in rows}
    full = ms["forward_core (device-resident)"]
    for r in rows:
        if r["label"] == "forward_core (device-resident)":
            r["grid_points_per_s"] = Hc * Wc / (1e-3 * full)
        elif r["label"] == "Aurora.forward (whole step)":
            r["minus_forward_core_ms"] = r["ms"] - full
            r["prepare_and_upload_ms"] = ms["prepare_encodings"] + ms["batch upload"]
    total = sum(ms[k] for k in ms if k in ("encoder", "backbone (bf16)", "backbone", "decoder"))
    rows.append(result("sum enc+bb+dec", total, dev, forward_core_ms=full,
                       share_of_forward_core=total / full))
    for r in rows:
        report(r)
    return rows


if __name__ == "__main__":
    main()
