"""Grid points per second a rank from 1 to N ranks (counterpart of ``tools/scaling_bench.py``).

For each ``n`` of ``--ranks`` the tool starts ``n`` processes, one a rank, whose process
group meets in a ``FileStore`` in a temporary folder; each builds the same seeded model,
takes its part of the same cropped batch under ``auto_mesh(n)`` (the JAX package's
factorisation: ``lon`` first, then ``lat``), and times ``forward_core`` (a warm-up call, then
``--steps`` calls ended by a synchronise and a barrier). The step is the slowest rank's
fastest step; grid points/s is the whole grid over it, and the efficiency that rate over
``n`` times the one-rank rate (the JAX tool's measure).

Ranks on one card time-slice it and move every halo through host memory (gloo): on one card
the figures say what the split costs there, not how it scales over cards. On the CPU
(``--device cpu``) they check the program, not its speed.

Usage: ``python -m aurora_tpu_torch.tools.scaling_bench [--ranks 1,2,4] [--small] [--steps 3]
[--H 721 --W 1440] [--device cpu]`` (the card by default; the 1.3 B production model unless
``--small``, the small model with the production knobs). The last line printed is one JSON
object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from aurora_tpu_torch.tools import card_line, resolve_device

__all__ = ["main", "worker"]

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _model(args, device):
    from aurora_tpu_torch.model.aurora import AuroraSmallPretrained
    from aurora_tpu_torch.tools.perf_breakdown import build_model, production_config

    cfg = production_config(AuroraSmallPretrained.default_config() if args.small else None)
    return build_model(cfg, device)


def worker(args) -> None:
    """One rank: its forward steps under ``auto_mesh(n)``; writes ``rank<i>.json``."""
    import torch.distributed as dist

    from aurora_tpu_torch.parallel import auto_mesh, initialize, shard_batch
    from aurora_tpu_torch.tools.perf_breakdown import numpy_batch

    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "2")))
    initialize(coordinator_address=f"file://{args.store}", num_processes=args.n,
               process_id=args.rank)
    mesh = auto_mesh(args.n, device=args.device)
    device = mesh.device
    model = _model(args, device)
    cfg = model.cfg
    batch = numpy_batch(cfg, args.H, args.W).crop(cfg.patch_size)
    part = shard_batch(batch, mesh) if mesh.size > 1 else batch
    dtype = model.compute_dtype
    enc = model.prepare_encodings(batch, torch.float32 if dtype == torch.bfloat16 else dtype)
    b = part.to(device, dtype)
    levels = tuple(float(x) for x in batch.metadata.atmos_levels)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()
        if mesh.size > 1:
            dist.barrier()

    times = []
    with mesh, torch.no_grad():
        for i in range(args.steps + 1):
            sync()
            t0 = time.perf_counter()
            model.forward_core(b.surf_vars, b.static_vars, b.atmos_vars, enc, i % 3, levels)
            sync()
            times.append(time.perf_counter() - t0)
    with open(os.path.join(os.path.dirname(args.store), f"rank{args.rank}.json"), "w") as f:
        json.dump(dict(mesh=mesh.shape, times=times[1:], warmup_s=times[0]), f)
    if mesh.size > 1:
        dist.destroy_process_group()


def _run(n: int, args, folder: str) -> dict:
    store = os.path.join(folder, f"store{n}")
    env = dict(os.environ, OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "2"))
    cmd = [sys.executable, "-m", "aurora_tpu_torch.tools.scaling_bench", "--role", "worker",
           "--n", str(n), "--store", store, "--device", args.device, "--steps", str(args.steps),
           "--H", str(args.H), "--W", str(args.W)] + (["--small"] if args.small else [])
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=ROOT, env=env) for r in range(n)]
    try:
        rcs = [p.wait(timeout=1800) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(rcs):
        raise RuntimeError(f"scaling_bench: worker exit codes {rcs} at {n} ranks")
    ranks = []
    for r in range(n):
        with open(os.path.join(folder, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
        os.remove(os.path.join(folder, f"rank{r}.json"))
    return dict(mesh=ranks[0]["mesh"], step_s=max(min(r["times"]) for r in ranks),
                step_s_per_rank=[r["times"] for r in ranks])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--role", default="launcher", choices=["launcher", "worker"])
    ap.add_argument("--ranks", default="1,2,4", help="the rank counts, in order")
    ap.add_argument("--small", action="store_true", help="the small model (D = 256)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--H", type=int, default=721)
    ap.add_argument("--W", type=int, default=1440)
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"])
    ap.add_argument("--n", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--store", default="")
    args = ap.parse_args(argv)
    if args.role == "worker":
        worker(args)
        return {}
    device = resolve_device(args.device)
    args.device = device.type
    if device.type == "cuda":
        from aurora_tpu_torch.ops import _lib

        _lib.build()  # once, before the workers load the libraries
    rows = []
    with tempfile.TemporaryDirectory(prefix="scaling_bench_") as folder:
        for n in (int(v) for v in args.ranks.split(",")):
            rows.append(dict(ranks=n, **_run(n, args, folder)))
    P = 4
    H, W = args.H // P * P, args.W // P * P
    base = H * W / rows[0]["step_s"] / rows[0]["ranks"]
    for row in rows:
        gps = H * W / row["step_s"]
        row.update(grid_points_per_s=gps, grid_points_per_s_per_rank=gps / row["ranks"],
                   efficiency=gps / (base * row["ranks"]))
        print(f"n={row['ranks']} {row['mesh']}: {row['step_s'] * 1e3:.0f} ms/step, "
              f"{gps / 1e3:.0f}k grid points/s, efficiency {row['efficiency'] * 100:.0f}%",
              file=sys.stderr)
    out = dict(metric="scaling_bench", device=device.type, card=card_line(device),
               model="small" if args.small else "production", grid=[H, W], rows=rows,
               note="ranks on one card time-slice it, halos through host memory (gloo)")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
