"""The readings that the limits of ``benchmark/checks/<workload>.json`` are set from: for each
seed, the program's compared numbers and those of the control, the reference put in the
program's place in the precision below the configuration's (``control`` in its file: float8
e4m3 products for a bfloat16 configuration, TF32 for a float32 one).

Usage (on the card; the benchmark's own runs never run it)::

    python3 -m benchmark.control --workload <name> --seeds 11,12,13 [--seconds 0]

One process reads every seed in turn: set-up, a window of ``--seconds`` (0: the traffic's
shortest, one forecast or no step beyond the checked ones), the program freed, then the
reference and the control. One JSON line a seed, then one with the largest program reading
and the smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from benchmark import run


def readings(name: str, seeds, seconds: float, device, *, cfg_update=None,
             traffic_update=None):
    """``[(seed, program numbers, control numbers)]`` of ``seeds``."""
    sp = run.spec()
    wl = run.workload(sp, name)
    cfg = dict(run.config(sp, wl["config"]), **(cfg_update or {}))
    tf = dict(run.traffic(wl["traffic"]), **(traffic_update or {}))
    out = []
    for seed in seeds:
        drv = run.driver(tf["kind"])(cfg, tf, seed, device)
        drv.window(seconds, torch.cuda.synchronize if device.type == "cuda" else (lambda: None))
        drv.release()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        got = drv.check(control=cfg["control"])
        out.append((seed, got["program"], got["control"]))
        del drv
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = readings(args.workload, seeds, args.seconds, torch.device("cuda"))
    for seed, prog, ctrl in rows:
        print(json.dumps({"seed": seed, "program": prog, "control": ctrl}), flush=True)
    keys = [k for k, v in rows[0][1].items() if isinstance(v, float)]
    print(json.dumps({"workload": args.workload, "card": run.card_line(),
                      "program_max": {k: max(r[1][k] for r in rows) for k in keys},
                      "control_min": {k: min(r[2][k] for r in rows) for k in keys}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
