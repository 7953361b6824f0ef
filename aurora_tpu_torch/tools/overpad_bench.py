"""What a mesh's over-padding costs, measured in one process (counterpart of
``tools/overpad_bench.py``).

Under a ``(lat, lon)`` mesh a Swin block over-pads the token grid by whole pad-only windows
to window x mesh multiples, so that every rank's block holds whole windows and the window
kernels run on it (``aurora_tpu_torch/parallel/halo.py::window_geometry``). With one card the
geometry's cost can be measured on its own: ``swin3d.overpadded(lat, lon)`` makes every block
of a one-process forward pad as a rank's block of that factorisation pads, so the pad tokens
flow through every kernel as they would per rank. The tool times the 1.3 B production
forward at 721 x 1440 without and with each ``--geom``'s over-pad (a warm-up call, then
``--steps`` calls ended by a synchronise, host clock) and checks that the over-padded
forward gives the baseline's predictions (the pad-only windows are cropped; on the card the
kernels' bits may differ by the window count a launch takes, within ``TOL`` mean-rel).

The JAX tool takes the geometry from an environment variable; here it is an argument.

Usage: ``python -m aurora_tpu_torch.tools.overpad_bench [--steps 3] [--geom 1,8 --geom 2,4]
[--H 721 --W 1440] [--device cpu]`` (the card by default); ``main(argv, model=...)`` takes a
model already built. The last line printed is one JSON object.
"""

from __future__ import annotations

import argparse
import json

import torch

from aurora_tpu_torch.tools import card_line, resolve_device

__all__ = ["TOL", "main"]

TOL = 1e-2  # mean relative error per variable against the baseline (the bf16 bar)


def _mean_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().mean() / (b.abs().mean() + 1e-30))


def main(argv=None, *, model=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--H", type=int, default=721)
    ap.add_argument("--W", type=int, default=1440)
    ap.add_argument("--geom", action="append", default=None,
                    help="lat,lon of a mesh whose over-pad to apply (repeatable; default 1,8 "
                         "and 2,4)")
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"])
    args = ap.parse_args(argv)
    from aurora_tpu_torch.model.swin3d import (
        get_encoder_specs,
        maybe_adjust_windows,
        overpadded,
    )
    from aurora_tpu_torch.parallel import halo
    from aurora_tpu_torch.tools.mesh_kernel_bench import time_forward
    from aurora_tpu_torch.tools.perf_breakdown import build_model, numpy_batch, production_config
    from aurora_tpu_torch.tools.scaling_bytes import At

    device = resolve_device(args.device)
    if model is None:
        model = build_model(production_config(), device)
    cfg = model.cfg
    batch = numpy_batch(cfg, args.H, args.W).crop(cfg.patch_size)
    base, want = time_forward(model, batch, args.steps, device)
    H, W = batch.spatial_shape
    res_all, _ = get_encoder_specs(cfg.backbone, (cfg.latent_levels, H // cfg.patch_size,
                                                  W // cfg.patch_size))
    out = dict(metric="overpad_cost", device=device.type, card=card_line(device),
               grid=[args.H, args.W], base_s=base, base_s_per_step=min(base), geoms={})
    ok = True
    for geom in args.geom or ["1,8", "2,4"]:
        la, lo = (int(v) for v in geom.split(","))
        with overpadded(la, lo):
            times, got = time_forward(model, batch, args.steps, device)
        first = At({"data": 1, "lat": la, "lon": lo}, {"data": 0, "lat": 0, "lon": 0})
        windows = [maybe_adjust_windows(cfg.window_size, (0, 0, 0), res)[0] for res in res_all]
        padded = [halo.window_geometry(res, ws, (0, 0, 0), first).padded
                  for res, ws in zip(res_all, windows)]
        err = max(_mean_rel(got[k], want[k]) for k in want)
        tokens = sum(p[0] * p[1] * p[2] for p in padded)
        real = sum(r[0] * (r[1] + (-r[1]) % ws[1]) * (r[2] + (-r[2]) % ws[2])
                   for r, ws in zip(res_all, windows))
        out["geoms"][f"{la}x{lo}"] = dict(
            s=times, s_per_step=min(times), overhead=min(times) / min(base) - 1,
            padded_grids=padded, extra_token_share=tokens / real - 1, mean_rel=err)
        ok = ok and err <= TOL
    out.update(tol=TOL, ok=ok)
    print(json.dumps(out), flush=True)
    if not ok:
        raise SystemExit("overpad_bench: an over-padded forward differs from the baseline")
    return out


if __name__ == "__main__":
    main()
