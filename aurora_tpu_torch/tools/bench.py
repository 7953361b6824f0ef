"""A roll-out timing tool: one roll-out of one configuration, step by step, on the card. (The
port's benchmark is ``python3 -m benchmark.run``.)

Counterpart of ``bench.py:77-234`` (the production model's roll-out: grid points per second
and roll-out steps per second) and ``tools/rollout_scan_bench.py`` (``rollout_scan`` with
and without host offload). One configuration and one kind of roll-out per run:

``--config``
    ``main``: ``perf_breakdown.production_config()`` (the 1.3 B model with LoRA, the backbone
    in bf16 under ``autocast`` with bf16-stored weights, bf16 values in the level aggregation
    and de-aggregation) at 721 x 1440, over a seeded batch of host arrays (13 levels,
    history 2, batch 1) as a user passes it. ``12h``, ``wave``, ``air_pollution`` and
    ``highres``: the released facades with the same knobs at their own grids (721 x 1440,
    721 x 1440, 451 x 900, 1801 x 3600), built and fed as ``tools/variant_bench.py`` and
    ``tools/highres_bench.py`` do (their batches are made on the card). Seeded weights,
    the FiLM modulations and LoRA ``B`` opened.
``--rollout``
    ``loop`` (``rollout``: one ``Aurora.forward`` a step, every prediction kept), ``scan``
    (``rollout_scan``: the same loop, the predictions kept on the card) or ``scan_offload``
    (``rollout_scan(host_offload=True)``: each prediction shipped to pinned host memory).
``--steps`` (default 6), ``--device cpu`` (else the card), ``--H``/``--W`` (the grid).

Two roll-outs of ``--steps`` steps from the same batch, after the kernels are built:

1. timed: a ``torch.cuda.synchronize()`` ends every step; each step's host-clock time and
   kernel launches (``ops._lib.LAUNCHES``), and the peak device memory
   (``max_memory_allocated`` after ``reset_peak_memory_stats``). The steady steps are the
   2nd onward (the 1st holds the first use of every shape); their median is the steady
   step;
2. free-running: one synchronise after the 1st step and one at the end; roll-out steps
   per second and grid points per second (``bench.py``'s metric: grid points of the
   cropped grid times steps, over the window) over the steps between, so a stall in the
   window counts.

The last line is one JSON object with every number, the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit``) and ``"device"``. On the CPU (``--device
cpu``: every kernel's plain version) the step times are host times of the CPU run, labelled
``"device": "cpu"``, and the peak device memory is null. Nothing is written to disk.

Usage: ``python -m aurora_tpu_torch.tools.bench [--config main] [--rollout loop]
[--steps 6] [--device cpu] [--H 721 --W 1440]``. ``main(argv, model=...)`` takes a model
already built (it must lie on the device); :func:`measure` is the same measurement for a
model and batch a caller holds.
"""

from __future__ import annotations

import argparse
import json
import time
from datetime import datetime
from typing import Callable, Optional

import numpy as np
import torch

from aurora_tpu_torch.batch import Batch
from aurora_tpu_torch.model.aurora import (
    Aurora,
    Aurora12hPretrained,
    AuroraAirPollution,
    AuroraHighRes,
    AuroraWave,
)
from aurora_tpu_torch.ops import _lib
from aurora_tpu_torch.rollout import rollout, ship_to_host
from aurora_tpu_torch.tools import card_line, resolve_device
from aurora_tpu_torch.tools.perf_breakdown import build_model, numpy_batch, production_config
from aurora_tpu_torch.tools.variant_bench import build_variant, raw_batch

CONFIGS = {  # name: (facade, H, W); main is the production config's plain model
    "main": (None, 721, 1440),
    "12h": (Aurora12hPretrained, 721, 1440),
    "wave": (AuroraWave, 721, 1440),
    "air_pollution": (AuroraAirPollution, 451, 900),
    "highres": (AuroraHighRes, 1801, 3600),
}
ROLLOUTS = ("loop", "scan", "scan_offload")
STEADY_FROM = 2  # the first steady step (1-based)


def build(config: str, device: torch.device, H: Optional[int] = None, W: Optional[int] = None,
          model: Optional[Aurora] = None) -> tuple[Aurora, Batch]:
    """The model and batch of ``config`` (``model`` as given, if given) at its grid or
    ``H`` x ``W``."""
    cls, H0, W0 = CONFIGS[config]
    H, W = H or H0, W or W0
    if model is None:
        model = (build_model(production_config(), device) if cls is None
                 else build_variant(cls, device))
    if model.device.type != device.type:
        raise ValueError(f"the model is on {model.device}, the bench runs on {device}")
    if cls is None:
        return model, numpy_batch(model.cfg, H, W)
    if cls is AuroraHighRes:
        return model, raw_batch(model.cfg, H, W, device=device, absolute=False,
                                when=datetime(2020, 6, 1, 12))
    return model, raw_batch(model.cfg, H, W, device=device)


def run_rollout(model: Aurora, batch: Batch, kind: str, steps: int,
                after_step: Callable[[int], None]) -> list[Batch]:
    """The roll-out of ``kind``; ``after_step(i)`` is called once step ``i``'s work is
    queued (with ``scan_offload``, its copy to the host too). Returns every prediction."""
    if kind not in ROLLOUTS:
        raise ValueError(f"--rollout {kind!r}: one of {ROLLOUTS}")

    def observed():
        for i, pred in enumerate(rollout(model, batch, steps)):
            yield pred
            after_step(i)

    if kind == "scan_offload":  # rollout_scan(host_offload=True)
        return ship_to_host(observed(), steps, model.device)
    return list(observed())  # loop and scan: rollout_scan(host_offload=False)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(model: Aurora, batch: Batch, kind: str, steps: int) -> tuple[dict, list[Batch]]:
    """Roll-out 1: every step's host-clock time, ended by a synchronise, its launches, and
    the peak device memory. Returns the row and the predictions."""
    dev = model.device
    step_s, launches = [], []
    mark = [time.perf_counter(), dict(_lib.LAUNCHES)]

    def after_step(i):
        _sync(dev)
        now = time.perf_counter()
        step_s.append(now - mark[0])
        launches.append({k: n - mark[1][k] for k, n in _lib.LAUNCHES.items() if n != mark[1][k]})
        mark[:] = [now, dict(_lib.LAUNCHES)]

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mark[:] = [time.perf_counter(), dict(_lib.LAUNCHES)]
    preds = run_rollout(model, batch, kind, steps, after_step)
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None
    return dict(step_s=step_s, launches_per_step=launches, peak_mem_gib=peak), preds


def free_running(model: Aurora, batch: Batch, kind: str, steps: int) -> Optional[float]:
    """Roll-out 2: steps per second over steps 2 to ``steps``, with no synchronise between
    them (None for fewer than 2 steps)."""
    if steps < 2:
        return None
    dev = model.device
    start = []

    def after_step(i):
        if i == 0:
            _sync(dev)
            start.append(time.perf_counter())

    run_rollout(model, batch, kind, steps, after_step)
    _sync(dev)
    return (steps - 1) / (time.perf_counter() - start[0])


def measure(model: Aurora, batch: Batch, kind: str, steps: int,
            config: str = "main") -> tuple[dict, list[Batch]]:
    """The two roll-outs of ``kind`` over ``batch``; returns the result row and the timed
    roll-out's predictions. On the CPU the peak device memory is None."""
    dev = model.device
    row, preds = timed(model, batch, kind, steps)
    steady = row["step_s"][STEADY_FROM - 1:]
    median = float(np.median(steady)) if steady else None
    Hc, Wc = preds[-1].spatial_shape
    per_s = free_running(model, batch, kind, steps)
    out = dict(
        metric="aurora_rollout", config=config, rollout=kind, device=dev.type,
        card=card_line(dev), kind=torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu", grid=f"{Hc}x{Wc}", steps=steps,
        params=sum(p.numel() for p in model.parameters()),
        step_s=row["step_s"], steady_from_step=STEADY_FROM, steady_step_s=median,
        grid_points_per_s=Hc * Wc * per_s if per_s else None, unit="grid_points/s",
        rollout_steps_per_s=per_s,
        peak_mem_gib=row["peak_mem_gib"],
        launches_per_step=row["launches_per_step"],
    )
    return out, preds


def main(argv=None, *, model: Optional[Aurora] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="main", choices=tuple(CONFIGS))
    ap.add_argument("--rollout", default="loop", choices=ROLLOUTS)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--device", default=None, help="the card unless 'cpu' is given")
    ap.add_argument("--H", type=int, default=None)
    ap.add_argument("--W", type=int, default=None)
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be at least 1")
    dev = resolve_device(args.device)
    build_s = _lib.build() if dev.type == "cuda" else None
    model, batch = build(args.config, dev, args.H, args.W, model)
    row, preds = measure(model, batch, args.rollout, args.steps, args.config)
    del preds
    row["build_s"] = build_s
    for i, (s, n) in enumerate(zip(row["step_s"], row["launches_per_step"]), 1):
        print(f"step {i}: {s:.4f} s (host clock, {row['device']}), launches {n}", flush=True)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
