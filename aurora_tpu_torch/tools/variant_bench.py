"""Variant throughput on the card: the air-pollution model at CAMS 0.4 degrees (451 x 900,
patch 3) and the ocean-wave model at 0.25 degrees (721 x 1440).

Counterpart of ``tools/variant_bench.py``. Both variants carry machinery the base model
lacks: level-conditioned patch embeddings and heads, the dynamic time features, a second
de-aggregation for the chemistry variables and the modulation heads (air pollution); ~50
supplemented surface channels with the density and angle splits (wave). Each is rolled out
over the raw (pre-hook) batch a user passes, as the JAX tool builds it
(``tools/variant_bench.py:35-60``: |N(0, 1)| fields, the wave model's raw set with
``dwi``), with the production knobs of ``tools/variant_bench.py:34``: the backbone in bf16
under ``autocast`` with bf16-stored weights, bf16 values in the level aggregation and
de-aggregation. Weights: seeded, the FiLM modulations and LoRA ``B`` opened
(``perf_breakdown.build_model``), unless ``main(argv, models=...)`` is given models (e.g.
with a checkpoint loaded).

Each variant's row: the roll-out's step times (host clock around ``torch.cuda.synchronize``;
the 3rd step is the first steady one), grid points per second of the last step, peak device
memory, the kernel launches of each step (``ops._lib.LAUNCHES``), and the last prediction's
variables with their shapes and NaN / inf counts (the wave model writes NaN where no waves
are predicted).

Usage: ``python -m aurora_tpu_torch.tools.variant_bench [--variants pollution,wave]
[--steps 3] [--device cpu] [--H H --W W]`` (``--H``/``--W`` replace every variant's grid).
"""

from __future__ import annotations

import argparse
import time
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from aurora_tpu_torch.batch import Batch, Metadata
from aurora_tpu_torch.model.aurora import (
    Aurora,
    AuroraAirPollution,
    AuroraWave,
    cast_backbone_params,
)
from aurora_tpu_torch.ops import _lib
from aurora_tpu_torch.rollout import rollout
from aurora_tpu_torch.tools import card_line, report, resolve_device, result
from aurora_tpu_torch.tools.perf_breakdown import LEVELS, open_gates, production_config

# name: (label, facade, H, W)
VARIANTS = {
    "pollution": ("air_pollution_0.4deg", AuroraAirPollution, 451, 900),
    "wave": ("wave_0.25deg", AuroraWave, 721, 1440),
}
# The raw wave fields a user passes: ``batch_transform_hook`` turns ``wind`` and ``dwi``
# into ``10u_wave`` / ``10v_wave``.
WAVE_RAW = ("swh", "mwd", "mwp", "pp1d", "shww", "mdww", "mpww", "shts", "mdts", "mpts",
            "swh1", "mwd1", "mwp1", "swh2", "mwd2", "mwp2", "wind", "dwi")


def build_variant(cls: type[Aurora], device, seed: int = 0, cfg=None) -> Aurora:
    """``cls`` with its default config (or ``cfg``) and the production knobs, seeded
    weights, gates opened, the backbone stored in bf16."""
    model = cls(production_config(cfg or cls.default_config()), device=device, seed=seed)
    open_gates(model)
    return cast_backbone_params(model)


def raw_batch(cfg, H: int, W: int, seed: int = 0, device=None, absolute: bool = True,
              when: datetime = datetime(2022, 6, 1, 0)) -> Batch:
    """The batch a user passes the model of ``cfg``, before its hook: batch 1, history 2,
    13 levels, seeded N(0, 1) fields (``absolute``: |N(0, 1)|, as the JAX variant tool; the
    static fields always), made on ``device``. A wave model gets the raw wave set."""
    dev = torch.device(device or "cpu")
    g = torch.Generator(device=dev).manual_seed(seed)

    def field(*shape, positive=absolute):
        x = torch.randn(shape, generator=g, device=dev)
        return x.abs() if positive else x

    surf = cfg.surf_vars if cfg.variant != "wave" else ("2t", "10u", "10v", "msl") + WAVE_RAW
    return Batch(
        surf_vars={k: field(1, 2, H, W) for k in surf},
        static_vars={k: field(H, W, positive=True) for k in cfg.static_vars},
        atmos_vars={k: field(1, 2, len(LEVELS), H, W) for k in cfg.atmos_vars},
        metadata=Metadata(
            lat=np.linspace(90, -90, H), lon=np.linspace(0, 360, W, endpoint=False),
            time=(when,), atmos_levels=LEVELS,
        ),
    )


def run_rollout(model: Aurora, batch: Batch, steps: int) -> dict:
    """Roll ``model`` out over ``batch`` for ``steps`` steps; the step times, peak memory,
    launches per step and the last prediction's variables (shape, NaN and inf points)."""
    dev = model.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    step_s, launches, pred = [], [], None
    before = dict(_lib.LAUNCHES)
    t = time.perf_counter()
    for pred in rollout(model, batch, steps=steps):
        sync()
        now = time.perf_counter()
        step_s.append(now - t)
        launches.append({k: n - before[k] for k, n in _lib.LAUNCHES.items() if n != before[k]})
        before, t = dict(_lib.LAUNCHES), now
    fields = {**pred.surf_vars, **pred.atmos_vars}
    Hc, Wc = pred.spatial_shape
    return dict(
        step_s=step_s, launches_per_step=launches, grid=f"{Hc}x{Wc}",
        grid_points_per_s=Hc * Wc / step_s[-1], rollout_step=pred.metadata.rollout_step,
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda"
        else None,
        outputs={k: list(v.shape) for k, v in fields.items()},
        nan_points={k: int(torch.isnan(v).sum()) for k, v in fields.items()},
        inf_points={k: int(torch.isinf(v).sum()) for k, v in fields.items()},
    )


def main(argv=None, *, models: Optional[dict[str, Aurora]] = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="pollution,wave")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default=None, help="the card unless 'cpu' is given")
    ap.add_argument("--H", type=int, default=None)
    ap.add_argument("--W", type=int, default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = []
    for name in args.variants.split(","):
        label, cls, H, W = VARIANTS[name]
        model = models[name] if models and name in models else build_variant(cls, dev)
        if model.device.type != dev.type:
            raise ValueError(f"the {name} model is on {model.device}, the tool runs on {dev}")
        batch = raw_batch(model.cfg, args.H or H, args.W or W, device=dev)
        r = run_rollout(model, batch, args.steps)
        rows.append(report(result(label, 1e3 * r["step_s"][-1], dev, card=card_line(dev),
                                  params=sum(p.numel() for p in model.parameters()), **r)))
    return rows


if __name__ == "__main__":
    main()
