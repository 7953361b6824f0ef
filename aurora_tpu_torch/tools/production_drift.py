"""How far the production stack drifts from the float32 default config over a roll-out.

Counterpart of ``tools/production_drift.py``. The production stack (``autocast`` with the
backbone in bf16, bf16-stored backbone weights by ``cast_backbone_params``, bf16 values in
the level aggregation and de-aggregation, LoRA folded into the weights the kernels read) is
what the benchmark entry runs; the float32 default config is what the registry and the
command-line interface build. This tool rolls the 1.3 B model (``LARGE_CONFIG`` with LoRA) out
``--steps`` steps three times from one seeded 721 x 1440 batch, every prediction shipped to
the host as the roll-out runs (``rollout_scan(host_offload=True)``):

* the float32 default config, the reference;
* the production stack with the same weights;
* the chaos control: the float32 config from inputs perturbed by ``--perturb`` relative
  noise (numpy ``default_rng(1234)``): how fast the model itself amplifies an infinitesimal
  difference, the yardstick for the production stack's drift.

Both comparisons go through :func:`curve` (per step: the largest max-relative error of any
variable against the reference, the largest and the median latitude-weighted relative RMSE,
the worst variables) and :func:`growth` (the step-to-step factor of the weighted RMSE). The
JSON has the JAX record's keys (``PRODUCTION_DRIFT.json``), with the card's name and power
limit and the roll-outs' seconds beside them. It is written to ``--out``,
``PRODUCTION_DRIFT_torch.json`` at the root of the repository by default; the tool refuses
to write the JAX package's record.

Weights: the port's seeded init (seed 0), with the FiLM modulations at N(0, 0.05) and LoRA
``B`` at N(0, 0.02) (:func:`open_gates_and_lora`): at fresh init both are zero, every Swin
block is an identity and the LoRA fold is exact, which would hide the bf16 backbone. The
JAX tool's ``agg_chunk_size=8192`` has no counterpart: the port's K4 cuts its columns into
chunks itself.

Usage: ``python -m aurora_tpu_torch.tools.production_drift [--steps 10] [--H 721 --W 1440]
[--small] [--out PATH]``. ``--small`` runs the JAX tool's small config (D = 64) on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import zlib
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from aurora_tpu_torch.model.aurora import Aurora, cast_backbone_params
from aurora_tpu_torch.model.config import LARGE_CONFIG, AuroraConfig
from aurora_tpu_torch.rollout import rollout_scan
from aurora_tpu_torch.tools import card_line, resolve_device
from aurora_tpu_torch.tools.perf_breakdown import LEVELS, PRODUCTION, numpy_batch

OUT = Path(__file__).resolve().parents[2] / "PRODUCTION_DRIFT_torch.json"
JAX_RECORD = "PRODUCTION_DRIFT.json"
PRODUCTION_STACK = "autocast + agg_bf16 + deagg_bf16 + cast_backbone_params + LoRA fold"
# The JAX tool's CPU-sized config.
SMALL = dict(embed_dim=64, encoder_depths=(2, 2, 2), encoder_num_heads=(2, 4, 8),
             decoder_depths=(2, 2, 2), decoder_num_heads=(8, 4, 2), latent_levels=2,
             patch_size=2, window_size=(1, 4, 4), num_heads=4, perceiver_ln_eps=1e-4)


def config(small: bool, production: bool) -> AuroraConfig:
    """The float32 default config with LoRA (``small``: the JAX tool's small one), or with the
    production knobs."""
    cfg = (AuroraConfig(**SMALL) if small else LARGE_CONFIG).replace(use_lora=True)
    return cfg.replace(**PRODUCTION) if production else cfg


def open_gates_and_lora(model: Aurora, scale_mod: float = 0.05, scale_b: float = 0.02,
                        seed: int = 0) -> Aurora:
    """Every FiLM modulation weight at N(0, ``scale_mod``) and every LoRA ``B`` at
    N(0, ``scale_b``), each from a generator seeded by ``seed`` and a CRC of its name."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "modulation" in name and name.endswith("weight"):
                scale = scale_mod
            elif "lora" in name and name.endswith(".B"):
                scale = scale_b
            else:
                continue
            g = torch.Generator(device=p.device).manual_seed(zlib.crc32(name.encode()) + seed)
            p.copy_(scale * torch.randn(p.shape, generator=g, device=p.device, dtype=p.dtype))
    return model


def initial_batch(H: int, W: int, small: bool, perturb: float = 0.0):
    """The JAX tool's batch (``bench.make_numpy_batch``: numpy ``default_rng(0)``, history 2,
    13 levels; ``small``: the first 4 levels), cropped to the patch size; ``perturb``:
    every surface and atmospheric field times ``1 + perturb * N(0, 1)`` (``default_rng(1234)``,
    the chaos control)."""
    import dataclasses

    cfg = config(small, False)
    batch = numpy_batch(cfg, H, W, seed=0)
    if small:
        md = dataclasses.replace(batch.metadata, atmos_levels=LEVELS[:4])
        batch = dataclasses.replace(
            batch, atmos_vars={k: np.ascontiguousarray(v[:, :, :4])
                               for k, v in batch.atmos_vars.items()}, metadata=md)
    batch = batch.crop(cfg.patch_size)
    if perturb:
        rng = np.random.default_rng(1234)

        def noisy(fields):
            return {k: v * (1.0 + perturb * rng.standard_normal(v.shape).astype(v.dtype))
                    for k, v in fields.items()}

        surf = noisy(batch.surf_vars)
        batch = dataclasses.replace(batch, surf_vars=surf, atmos_vars=noisy(batch.atmos_vars))
    return batch


def run_rollout(model: Aurora, batch, steps: int) -> tuple[list[dict], float]:
    """``steps`` predictions of ``model`` from ``batch``, each as
    ``{"surf:<name>": (B, H, W), "atmos:<name>": (B, C, H, W)}`` host arrays (the JAX tool's
    layout), and the roll-out's seconds."""
    t0 = time.perf_counter()
    preds = rollout_scan(model, batch, steps, host_offload=True)
    seconds = time.perf_counter() - t0
    out = []
    for p in preds:
        step = {f"surf:{k}": np.asarray(v)[:, 0] for k, v in p.surf_vars.items()}
        step.update({f"atmos:{k}": np.asarray(v)[:, 0] for k, v in p.atmos_vars.items()})
        out.append(step)
    return out, seconds


def latitude_weights(H: int, H_pred: int) -> np.ndarray:
    """cos(latitude) over the predictions' rows (the grid cropped at its southern edge),
    normalised to mean 1, as an (H_pred, 1) column."""
    lat = np.linspace(90, -90, H)[:H_pred]
    w = np.cos(np.deg2rad(lat))
    return (w / w.mean())[:, None]


def curve(ref_steps: list[dict], other_steps: list[dict], w_lat: np.ndarray) -> list[dict]:
    """Per step, ``other`` against ``ref``: the largest max-relative error of a variable
    (max |d| over max |ref|), the largest and the median latitude-weighted relative RMSE
    (sqrt(mean(w d^2)) over sqrt(mean(w ref^2)), in float64), and the worst variables."""
    rows = []
    for i, (r, p) in enumerate(zip(ref_steps, other_steps)):
        max_errs, wrmse_errs = {}, {}
        for k in r:
            d = p[k] - r[k]
            max_errs[k] = float(np.abs(d).max()) / (float(np.abs(r[k]).max()) + 1e-30)
            num = float(np.sqrt(np.mean(w_lat * d.astype(np.float64) ** 2)))
            den = float(np.sqrt(np.mean(w_lat * r[k].astype(np.float64) ** 2))) + 1e-30
            wrmse_errs[k] = num / den
        rows.append(dict(
            step=i + 1, max_rel_err=max(max_errs.values()), wrmse_rel=max(wrmse_errs.values()),
            wrmse_median=float(np.median(list(wrmse_errs.values()))),
            worst_var_max=max(max_errs, key=max_errs.get),
            worst_var_wrmse=max(wrmse_errs, key=wrmse_errs.get)))
    return rows


def growth(rows: list[dict], key: str = "wrmse_rel") -> list[float]:
    """The step-to-step factors of ``key``, rounded to two decimals."""
    vals = [r[key] for r in rows]
    return [round(b / max(a, 1e-30), 2) for a, b in zip(vals, vals[1:])]


def error_budget(prod: list[dict], chaos: list[dict], perturb: float) -> str:
    """The record's reading, in one paragraph, from its numbers."""
    return (
        f"The production stack injects {prod[0]['max_rel_err']:.2e} max-rel at step 1 "
        f"({prod[0]['wrmse_rel']:.2e} weighted RMSE). Its weighted RMSE grows by "
        f"{growth(prod)} a step; the chaos control (the float32 config from inputs perturbed "
        f"by {perturb:g} relative) by {growth(chaos)}. At step {len(prod)} production sits at "
        f"{prod[-1]['max_rel_err']:.2e} max-rel and {prod[-1]['wrmse_rel']:.2e} weighted RMSE "
        f"against the float32 roll-out, the chaos control at {chaos[-1]['max_rel_err']:.2e} "
        f"and {chaos[-1]['wrmse_rel']:.2e}.")


def rollouts(ref_model: Aurora, steps: int, H: int, W: int, small: bool,
             perturb: float) -> tuple[list[dict], list[dict], list[dict], dict]:
    """The three roll-outs from ``ref_model`` (the float32 config with LoRA): the float32
    reference, the production stack with the same weights (made on ``ref_model``'s device
    and freed after), the chaos control; and each one's seconds."""
    seconds = {}
    ref, seconds["f32"] = run_rollout(ref_model, initial_batch(H, W, small), steps)
    log(f"[f32] {steps} steps in {seconds['f32']:.1f} s")
    dev = next(ref_model.parameters()).device
    prod_model = Aurora(config(small, True), device=dev, seed=None)
    prod_model.load_state_dict(ref_model.state_dict())
    cast_backbone_params(prod_model)
    prod, seconds["production"] = run_rollout(prod_model, initial_batch(H, W, small), steps)
    log(f"[production] {steps} steps in {seconds['production']:.1f} s")
    del prod_model
    chaos, seconds["chaos"] = run_rollout(ref_model, initial_batch(H, W, small, perturb), steps)
    log(f"[chaos] {steps} steps in {seconds['chaos']:.1f} s")
    return ref, prod, chaos, seconds


def measure(steps: int, H: int, W: int, small: bool, perturb: float, device) -> dict:
    """The three roll-outs and the record (every key of the JAX tool's)."""
    dev = resolve_device(device)
    ref_model = open_gates_and_lora(Aurora(config(small, False), device=dev, seed=0))
    ref, prod, chaos, seconds = rollouts(ref_model, steps, H, W, small, perturb)
    del ref_model
    w_lat = latitude_weights(H, next(iter(ref[0].values())).shape[-2])
    prod_curve, chaos_curve = curve(ref, prod, w_lat), curve(ref, chaos, w_lat)
    return {
        "config": "small" if small else "LARGE 1.3B",
        "grid": [H, W],
        "steps": steps,
        "production_stack": PRODUCTION_STACK,
        "max_rel_err": max(s["max_rel_err"] for s in prod_curve),
        "final_step_rel_err": prod_curve[-1]["max_rel_err"],
        "final_step_wrmse_rel": prod_curve[-1]["wrmse_rel"],
        "chaos_perturbation": perturb,
        "chaos_final_step_rel_err": chaos_curve[-1]["max_rel_err"],
        "chaos_final_step_wrmse_rel": chaos_curve[-1]["wrmse_rel"],
        "prod_step_growth_wrmse": growth(prod_curve),
        "chaos_step_growth_wrmse": growth(chaos_curve),
        "per_step": prod_curve,
        "chaos_per_step": chaos_curve,
        "error_budget": error_budget(prod_curve, chaos_curve, perturb),
        "device": dev.type,
        "card": card_line(dev),
        "rollout_seconds": seconds,
    }


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--H", type=int, default=721)
    ap.add_argument("--W", type=int, default=1440)
    ap.add_argument("--small", action="store_true",
                    help="the JAX tool's small config, on the CPU")
    ap.add_argument("--perturb", type=float, default=1e-6,
                    help="relative input perturbation of the chaos control")
    ap.add_argument("--device", default=None, help="the card unless 'cpu' is given")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    out = Path(args.out)
    if out.name == JAX_RECORD:
        raise SystemExit(f"{JAX_RECORD} is the JAX package's record; write elsewhere")
    device: Optional[str] = "cpu" if args.small else args.device
    result = measure(args.steps, args.H, args.W, args.small, args.perturb, device)
    out.write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps({k: v for k, v in result.items()
                      if k not in ("per_step", "chaos_per_step")}), flush=True)
    return result


if __name__ == "__main__":
    main()
