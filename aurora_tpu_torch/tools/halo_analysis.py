"""The collectives of the model under a ``(data, lat, lon)`` mesh, measured on a real run
(counterpart of ``tools/halo_analysis.py``): each collective of the forward and of the
train steps by kind, with its count and the bytes a rank puts in.

The JAX tool compiles the backbone over virtual devices and reads the collectives XLA
emitted from the HLO. The port's collectives are its own calls, which count themselves in
:data:`~aurora_tpu_torch.parallel.halo.STATS` (``halo.report()["by_kind"]``: the halo moves
and their transposes, the whole-grid gathers, the gradient buckets, the ZeRO gather); this
tool runs ``tools.multihost_sim``'s ranks (``AuroraSmallPretrained(use_lora=True)``, the
train half: the forward, the LoRA step and the full step) and reads each rank's report of
each step. It prints, for each step, each kind's count and bytes on the rank that moved the
most, the halo moves' bytes against the first stage's token tensor (the JAX tool's
measure: the shifted windows must move thin strips, not the grid), and the largest single
collective of the forward.

Usage: ``python -m aurora_tpu_torch.tools.halo_analysis [--lat 2 --lon 4] [--data 1]
[--H 48 --W 192] [--width 256] [--depths 2] [--device cpu]`` (the card by default). The
last line printed is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from aurora_tpu_torch.tools import multihost_sim

__all__ = ["collectives", "main"]


def collectives(ranks: list[dict], config: str, key: str, step: str) -> dict:
    """``{kind: {"count", "bytes"}}`` of one step of one grid, the most over ``ranks`` (the
    ranks of the plane that ran it), and each rank's total bytes."""
    reports = []
    for r in ranks:
        res = r["train"][config]
        got = res["full"] if step == "full" else res["grids"].get(key)
        if got is not None and step in got:
            reports.append(got[step]["halo"])
    kinds = sorted({k for rep in reports for k in rep["by_kind"]})
    most = {k: dict(count=max(rep["by_kind"].get(k, {}).get("count", 0) for rep in reports),
                    bytes=max(rep["by_kind"].get(k, {}).get("bytes", 0) for rep in reports))
            for k in kinds}
    return dict(by_kind=most, total_bytes=[sum(v["bytes"] for v in rep["by_kind"].values())
                                           for rep in reports],
                largest_halo_collective=max(rep["largest_sent"] for rep in reports))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--lat", type=int, default=2)
    ap.add_argument("--lon", type=int, default=4)
    ap.add_argument("--H", type=int, default=48, help="pixel rows")
    ap.add_argument("--W", type=int, default=192, help="pixel columns")
    ap.add_argument("--width", type=int, default=None, help="the small model's embed_dim")
    ap.add_argument("--depths", type=int, default=2, help="blocks in every stage")
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"])
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="halo_analysis_") as folder:
        out = os.path.join(folder, "out.pt")
        argv_sim = ["--data", str(args.data), "--lat", str(args.lat), "--lon", str(args.lon),
                    "--depths", str(args.depths), "--grids", f"{args.H}x{args.W}",
                    "--no-serve", "--train", "forward,lora,full", "--save", out]
        argv_sim += ["--width", str(args.width)] if args.width else []
        argv_sim += ["--device", args.device] if args.device else []
        multihost_sim.main(argv_sim)
        res = torch.load(out, weights_only=False)
    ranks = res["ranks"]
    key = next(iter(res["reference"]["train"]["small"]["grids"]))
    per = args.lat * args.lon
    cfg = multihost_sim.spatial_config(argparse.Namespace(depths=args.depths,
                                                          width=args.width, config="small"))
    P = cfg.patch_size
    D = cfg.embed_dim
    tokens = cfg.latent_levels * (args.H // P) * (args.W // P) * D
    token_bytes = tokens * (2 if cfg.autocast else 4)
    steps = {}
    for step in ("forward", "lora", "full"):
        steps[step] = collectives(ranks if step == "full" else ranks[:per], "small", key, step)
        halo_bytes = sum(v["bytes"] for k, v in steps[step]["by_kind"].items()
                         if k.startswith("fetch"))
        steps[step]["halo_bytes_over_stage0_tokens"] = halo_bytes / token_bytes
    summary = dict(metric="halo_analysis", mesh=dict(data=args.data, lat=args.lat,
                                                     lon=args.lon),
                   grid=[args.H, args.W], token_grid=[cfg.latent_levels, args.H // P,
                                                     args.W // P],
                   embed_dim=D, stage0_token_bytes=token_bytes, device=res["result"]["device"],
                   steps=steps,
                   largest_forward_collective_over_stage0_tokens=steps["forward"][
                       "largest_halo_collective"] / token_bytes,
                   ok=res["result"]["ok"])
    for step, row in steps.items():
        print(f"{step}:")
        for kind, v in row["by_kind"].items():
            print(f"  {kind:22s} {v['count']:5d} collectives  {v['bytes'] / 2**20:10.3f} MiB")
        print(f"  halo = {row['halo_bytes_over_stage0_tokens']:.2f} x the stage-0 token bytes")
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
