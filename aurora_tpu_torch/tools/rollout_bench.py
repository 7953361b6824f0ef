"""Roll-out throughput of the 1.3 B 0.25 degree model with the cyclone tracker on every
prediction: the post-processing path of an operational forecast, on the card.

Counterpart of ``tools/rollout_bench.py``: the production model (seeded weights, gates
opened), a seeded batch of host arrays, :func:`aurora_tpu_torch.rollout` for ``--steps``
steps and :class:`aurora_tpu_torch.tracker.Tracker` stepping through the predictions from
the JAX tool's first fix (25.3 N, 129.2 E). Each step is ended by a synchronise and timed on the host
clock, the tracker apart; steps/s is of the fastest step after the first, as the JAX tool
reports it.

Usage: ``python -m aurora_tpu_torch.tools.rollout_bench [--steps 6] [--H 721 --W 1440]
[--device cpu]``; ``main(argv, model=...)`` takes a model already built. The last line
printed is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch

from aurora_tpu_torch.model.aurora import Aurora
from aurora_tpu_torch.ops import _lib
from aurora_tpu_torch.rollout import rollout
from aurora_tpu_torch.tools import card_line, resolve_device
from aurora_tpu_torch.tools.perf_breakdown import build_model, numpy_batch, production_config
from aurora_tpu_torch.tracker import Tracker

__all__ = ["INIT_FIX", "main"]

INIT_FIX = (25.3, 129.2)  # the tracker's first fix, (lat, lon), as the JAX tool's


def main(argv=None, *, model: Optional[Aurora] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--H", type=int, default=721)
    ap.add_argument("--W", type=int, default=1440)
    ap.add_argument("--device", default=None, help="the card unless 'cpu' is given")
    args = ap.parse_args(argv)
    if args.steps < 2:
        ap.error("--steps must be at least 2 (the first step is not counted)")
    dev = resolve_device(args.device)
    if model is None:
        if dev.type == "cuda":
            _lib.build()
        model = build_model(production_config(), dev)
    dev = model.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    batch = numpy_batch(model.cfg, args.H, args.W)
    tracker = Tracker(*INIT_FIX, batch.metadata.time[0])
    step_s, tracker_s = [], []
    t0 = time.perf_counter()
    for i, pred in enumerate(rollout(model, batch, args.steps)):
        sync()
        step_s.append(time.perf_counter() - t0)
        t1 = time.perf_counter()
        tracker.step(pred)
        tracker_s.append(time.perf_counter() - t1)
        print(f"step {i}: {step_s[-1]:.4f} s, tracker {tracker_s[-1]:.4f} s (host clock, "
              f"{dev.type})", flush=True)
        del pred
        t0 = time.perf_counter()
    dt = min(step_s[1:])
    track = tracker.results()
    out = dict(metric="rollout_tracker", device=dev.type, card=card_line(dev),
               grid=[args.H, args.W], steps=args.steps, step_s=step_s, tracker_s=tracker_s,
               steps_per_s=1 / dt, ms_per_step=1e3 * dt, track_len=len(track["time"]),
               fails=tracker.fails, track={k: [str(v) for v in vs] for k, vs in track.items()})
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
