"""Command-line driver: forecasts and their scores from the shell (port of
``aurora_tpu/cli.py``).

    python -m aurora_tpu_torch forecast --model Aurora --checkpoint aurora-0.25-finetuned.ckpt \\
        --input 2023-01-01T00.nc --steps 40 --output-dir preds/ \\
        [--track --init-lat 25.3 --init-lon 129.2]

    python -m aurora_tpu_torch evaluate --pred preds/prediction-003.nc \\
        --target analysis_t3.nc [--climatology clim.nc]

``forecast`` reads the initial condition as a netCDF :class:`Batch` (the JAX package's
format), loads the weights (a reference ``.ckpt``, a file of the port's ``save_params``, the
Hugging Face hub, or seeded random ones), runs :func:`aurora_tpu_torch.rollout` and writes
each step as ``prediction-{i:03d}.nc`` (the serving channel's naming); with ``--track`` it
runs the cyclone tracker on every prediction and writes ``track.csv``. Its last line on
stderr is a JSON object of its host-clock seconds: reading the input, and for each step the
step (the card synchronised), the file's writing and bytes, and the tracker. ``evaluate`` prints
one JSON line of latitude-weighted scores per variable (:mod:`aurora_tpu_torch.metrics`).

Both run on the card unless ``--device cpu`` is given; without a card and without it they
exit with code 2 and a message. The model is the facade with its default config, as the JAX
package's CLI builds it (``aurora_tpu/cli.py:47-68``): float32 all through for every
released facade, on the card's float32 kernels. ``--no-bf16-backbone`` matters only for a
config under ``autocast``, whose backbone is otherwise stored in bf16. Exit codes as the JAX
package's: 0 done, 2 a user error (a bad path, an unknown model, a bad flag combination).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

__all__ = ["CLIError", "build_parser", "main"]

MODELS = ("Aurora", "AuroraPretrained", "AuroraSmallPretrained", "AuroraSmall",
          "Aurora12hPretrained", "AuroraHighRes", "AuroraAirPollution", "AuroraWave")


class CLIError(Exception):
    """A user-facing failure (a bad path, a bad flag combination, no card); exit code 2."""


def _device(args):
    from aurora_tpu_torch.model.aurora import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        raise CLIError(str(e)) from None


def _load_model(args, device):
    """The model of ``--model`` with its default config on ``device`` with the weights of
    ``--random-init``, ``--checkpoint`` or the hub (the default); under ``autocast`` the
    backbone stored in bf16 unless ``--no-bf16-backbone``."""
    import torch

    import aurora_tpu_torch as port
    from aurora_tpu_torch.checkpoint import convert_reference_checkpoint
    from aurora_tpu_torch.convert import load_numpy_params

    cls = getattr(port, args.model)
    if args.random_init:
        model = cls(device=device, seed=args.seed)
    else:
        model = cls(device=device, seed=None)
        if args.checkpoint:
            if not os.path.exists(args.checkpoint):
                raise CLIError(f"checkpoint not found: {args.checkpoint}")
            state = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
            if set(state) == set(model.state_dict()):  # the port's own save_params file
                model.load_state_dict(state)
            else:  # a reference checkpoint
                raw = {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
                       for k, v in state.items()}
                load_numpy_params(model, convert_reference_checkpoint(raw, model.cfg, dtype=None),
                                  strict=False)
        else:  # --hf, or no source given: the variant's pinned checkpoint on the hub
            model.load_checkpoint()
    if model.cfg.autocast and not args.no_bf16_backbone:
        port.cast_backbone_params(model)
    return model


def cmd_forecast(args, model=None) -> int:
    import torch

    from aurora_tpu_torch import Batch, rollout
    from aurora_tpu_torch.foundry.channel import iterate_prediction_files
    from aurora_tpu_torch.tracker import Tracker

    if model is None and args.model not in MODELS:
        print(f"unknown model {args.model!r}; choose from {sorted(MODELS)}", file=sys.stderr)
        return 2
    if args.track and (args.init_lat is None or args.init_lon is None):
        print("--track requires --init-lat and --init-lon", file=sys.stderr)
        return 2
    device = _device(args) if model is None else None
    t0 = time.perf_counter()
    batch = Batch.from_netcdf(args.input)
    timings = dict(read_s=time.perf_counter() - t0, input_bytes=os.path.getsize(args.input),
                   steps=[])
    if model is None:
        model = _load_model(args, device)
    os.makedirs(args.output_dir, exist_ok=True)
    tracker = Tracker(args.init_lat, args.init_lon, batch.metadata.time[0]) if args.track \
        else None
    sync = torch.cuda.synchronize if model.device.type == "cuda" else (lambda: None)

    preds = rollout(model, batch, args.steps)
    for i, fname in enumerate(iterate_prediction_files("prediction.nc", args.steps)):
        t0 = time.perf_counter()
        pred = next(preds)
        sync()
        t1 = time.perf_counter()
        path = os.path.join(args.output_dir, fname)
        pred.to_netcdf(path)
        t2 = time.perf_counter()
        if tracker is not None:
            tracker.step(pred)
        t3 = time.perf_counter()
        row = dict(step_s=t1 - t0, write_s=t2 - t1, bytes=os.path.getsize(path),
                   tracker_s=t3 - t2 if tracker is not None else None)
        timings["steps"].append(row)
        print(f"step {i + 1}/{args.steps}: wrote {path} ({row['bytes']} bytes; step "
              f"{row['step_s']:.3f} s, write {row['write_s']:.3f} s)", file=sys.stderr,
              flush=True)
        del pred

    if tracker is not None:
        track_path = os.path.join(args.output_dir, "track.csv")
        tracker.write_csv(track_path)
        print(f"wrote {track_path}", file=sys.stderr)
    # Host-clock seconds, the card synchronised after each step; the last line on stderr.
    print(json.dumps({"forecast_timings": timings}), file=sys.stderr, flush=True)
    return 0


def cmd_evaluate(args, model=None) -> int:
    import numpy as np

    from aurora_tpu_torch import Batch, metrics

    if len(args.pred) != len(args.target):
        print("--pred and --target need the same number of files", file=sys.stderr)
        return 2
    device = _device(args)

    def read(path):
        return Batch.from_netcdf(path).to(device)

    clim = read(args.climatology) if args.climatology else None
    out = []
    for pred_path, target_path in zip(args.pred, args.target):
        scores = metrics.evaluate(read(pred_path), read(target_path), climatology=clim)
        # Keyed by group, so that a name in both groups cannot overwrite the other: a scalar
        # (the mean over batch and time) a surface variable, a list over the levels an
        # atmospheric one.
        nested = {}
        for group in ("surf_vars", "atmos_vars"):
            nested[group] = {}
            for var, ms in scores[group].items():
                row = {}
                for k, v in ms.items():
                    v = v.cpu().numpy()
                    row[k] = (v.mean(axis=tuple(range(v.ndim - 1))).round(6).tolist()
                              if group == "atmos_vars" else round(float(v.mean()), 6))
                nested[group][var] = row
        out.append({"pred": pred_path, "target": target_path, "scores": nested})
    print(json.dumps(out if len(out) > 1 else out[0]))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="aurora_tpu_torch", description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="command", required=True)

    f = sub.add_parser("forecast", help="autoregressive roll-out from a netCDF initial condition")
    f.add_argument("--model", default="AuroraPretrained", help="variant class name")
    f.add_argument("--input", required=True, help="initial-condition netCDF (Batch format)")
    f.add_argument("--steps", type=int, default=4)
    f.add_argument("--output-dir", required=True)
    src = f.add_mutually_exclusive_group()
    src.add_argument("--checkpoint",
                     help="a reference .ckpt file or a file of the port's save_params")
    src.add_argument("--hf", action="store_true",
                     help="download the variant's checkpoint from the hub (the default)")
    src.add_argument("--random-init", action="store_true", help="seeded random weights")
    f.add_argument("--seed", type=int, default=0)
    f.add_argument("--no-bf16-backbone", action="store_true",
                   help="keep the backbone's weights in f32 (by default they are stored in "
                        "bf16 under autocast: the same computation, half the memory)")
    f.add_argument("--track", action="store_true", help="run the tropical-cyclone tracker")
    f.add_argument("--init-lat", type=float, help="tracker initial latitude")
    f.add_argument("--init-lon", type=float, help="tracker initial longitude")
    f.add_argument("--device", default=None, help="the card unless 'cpu' is given")
    f.set_defaults(fn=cmd_forecast)

    e = sub.add_parser("evaluate", help="latitude-weighted scores of prediction vs target netCDFs")
    e.add_argument("--pred", nargs="+", required=True)
    e.add_argument("--target", nargs="+", required=True)
    e.add_argument("--climatology", help="optional climatology netCDF (adds ACC)")
    e.add_argument("--device", default=None, help="the card unless 'cpu' is given")
    e.set_defaults(fn=cmd_evaluate)
    return ap


def main(argv: Optional[list[str]] = None, model=None) -> int:
    """Run the command of ``argv``; returns the exit code. ``model``: a model already built
    and loaded, which ``forecast`` then runs in place of ``--model`` and its weights."""
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args, model=model)
    except CLIError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
