"""The 1.3 B production forward under a ``make_mesh(1, 1, 1)`` mesh against no mesh
(counterpart of ``tools/mesh_kernel_bench.py``): what the mesh machinery costs at degree 1.

Under the JAX package a mesh at degree 1 still routes the kernels through ``shard_map`` and
GSPMD; the port's mesh at degree 1 splits nothing, so ``forward_core`` takes the one-device
path and the two times should agree within the run's spread. The tool times
``forward_core`` on the main path's seeded model and 721 x 1440 batch without a mesh and
inside ``with make_mesh(1, 1, 1):``, each a warm-up call then ``--steps`` calls ended by a
synchronise (host clock), and checks that the two forwards give the same bits.

Usage: ``python -m aurora_tpu_torch.tools.mesh_kernel_bench [--steps 3] [--H 721 --W 1440]
[--device cpu]`` (the card by default); ``main(argv, model=...)`` takes a model already
built. The last line printed is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from aurora_tpu_torch.tools import card_line, resolve_device

__all__ = ["main", "time_forward"]


def time_forward(model, batch, steps: int, device) -> tuple[list[float], dict]:
    """A warm-up ``forward_core`` on ``batch`` (cropped, host), then ``steps`` timed ones;
    the seconds of each and the last call's predictions on the host."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    dtype = model.compute_dtype
    enc = model.prepare_encodings(batch, torch.float32 if dtype == torch.bfloat16 else dtype)
    b = batch.to(device, dtype)
    levels = tuple(float(x) for x in batch.metadata.atmos_levels)

    def call(i):
        with torch.no_grad():
            return model.forward_core(b.surf_vars, b.static_vars, b.atmos_vars, enc, i % 3,
                                      levels)

    call(0)
    sync()
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        out = call(i)
        sync()
        times.append(time.perf_counter() - t0)
    surf, atmos = out
    return times, {k: v.cpu() for k, v in {**surf, **atmos}.items()}


def main(argv=None, *, model=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--H", type=int, default=721)
    ap.add_argument("--W", type=int, default=1440)
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"])
    args = ap.parse_args(argv)
    from aurora_tpu_torch.parallel import make_mesh
    from aurora_tpu_torch.tools.perf_breakdown import build_model, numpy_batch, production_config

    device = resolve_device(args.device)
    if model is None:
        model = build_model(production_config(), device)
    batch = numpy_batch(model.cfg, args.H, args.W).crop(model.cfg.patch_size)
    plain, want = time_forward(model, batch, args.steps, device)
    with make_mesh(1, 1, 1, device=device.type):
        mesh, got = time_forward(model, batch, args.steps, device)
    same = sorted(want) == sorted(got) and all(torch.equal(want[k], got[k]) for k in want)
    H, W = batch.spatial_shape
    out = dict(metric="mesh_mode_per_device", device=device.type, card=card_line(device),
               grid=[args.H, args.W], no_mesh_s=plain, mesh_s=mesh,
               no_mesh_s_per_step=min(plain), mesh_s_per_step=min(mesh),
               mesh_overhead=min(mesh) / min(plain) - 1,
               mesh_grid_points_per_s=H * W / min(mesh), same_bits=same, ok=same)
    print(json.dumps(out), flush=True)
    if not same:
        raise SystemExit("mesh_kernel_bench: the forward under make_mesh(1, 1, 1) differs")
    return out


if __name__ == "__main__":
    main()
