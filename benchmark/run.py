"""The benchmark of the PyTorch and CUDA port (``aurora_tpu_torch``) on the card.

Usage, from the root of a checkout::

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The harness is driven by data. ``BENCHMARK.json`` names each workload's configuration and
traffic; the configuration is ``benchmark/configs/<file>``, the traffic
``benchmark/traffic/<traffic>.json`` (its ``kind`` names the driver in
``benchmark/drivers/<kind>.py``, which holds the entry, the warm-up and the step), the
limits of the correctness comparison ``benchmark/checks/<workload>.json``, each per-layer
metric a reader ``benchmark/metrics/<metric>.py`` and the products and bytes
``benchmark/count/<count>.py`` as the configuration names it; the peaks of the card are
``benchmark/peaks.json``.

A run: set-up (the kernels built into the checkout's ``build/kernels``, the model and its
weights from the seed, the inputs, the warm-up) on the host clock from process start to the
first timed step (``setup_s``); the window of at least ``--seconds`` seconds; the peak device
memory over the window; a check that no JAX module was loaded; the program freed; the
comparison with the plain reference (``correct``); one JSON line. With ``--trace 1`` a
``torch.profiler`` trace of the window gives the per-layer metrics in place of the
end-to-end ones.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # the process's start, as near as Python lets us read it

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "aurora_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(sp: dict, name: str) -> dict:
    for w in sp["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(sp: dict, name: str) -> dict:
    for c in sp["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(name: str) -> dict:
    return load_json(HERE / "checks" / f"{name}.json")["limits"]


def driver(kind: str):
    """The driver class of a traffic ``kind``: ``DRIVER`` of ``drivers/<kind>.py``."""
    mod = importlib.import_module(f"benchmark.drivers.{kind}")
    return getattr(mod, "DRIVER")


def reader(metric: str):
    """``read(reading)`` of ``metrics/<metric>.py`` (metric names hold dots, so the file is
    loaded by its path)."""
    path = HERE / "metrics" / f"{metric}.py"
    sp = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}",
                                                path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def applies(entry: dict, name: str) -> bool:
    return "workloads" not in entry or name in entry["workloads"]


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is one of :data:`FORBIDDEN`, whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


def counts(cfg: dict, kind: str) -> dict:
    """The products and bytes of the configuration's step on its cropped grid: the forward
    by part, the backbone's bytes and, for a ``train`` traffic, the backward."""
    from benchmark.data import Grid

    count = importlib.import_module(f"benchmark.count.{cfg['count']}")
    g = Grid.of(cfg)
    H = g.H - g.H % cfg["patch_size"]
    out = dict(forward=count.forward(cfg, H, g.W, len(g.levels), g.batch, g.history))
    if kind == "train":
        out["backward"] = count.train_backward(cfg, H, g.W, len(g.levels), g.batch)
    act = 2 if cfg.get("autocast") else 4
    out["backbone_bytes"] = count.backbone_bytes(cfg, H, g.W, g.batch, act, act)
    return out


def run(name: str, seed: int, seconds: float, trace: bool, device, *, cfg_update=None,
        traffic_update=None, sp=None) -> tuple[dict, list[str]]:
    """One run of workload ``name``: the result line's object and the compared numbers'
    lines. ``device`` a ``torch.device``; ``cfg_update`` / ``traffic_update`` are for the
    harness's own tests on the CPU at a small size."""
    import torch

    from benchmark import trace as tr

    sp = sp or spec()
    wl = workload(sp, name)
    cfg = dict(config(sp, wl["config"]), **(cfg_update or {}))
    tf = dict(traffic(wl["traffic"]), **(traffic_update or {}))
    lim = limits(name)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cls = driver(tf["kind"])
    imports_s = time.perf_counter() - T0
    drv = cls(cfg, tf, seed, device)
    spans = tr.Spans()
    if trace:
        drv.hook(spans)
    sync()
    setup_s = time.perf_counter() - T0
    pre_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    prof = tr.profiler() if trace else None
    if prof is not None:
        prof.start()
        with tr.span("window"):
            res = drv.window(seconds, sync)
        prof.stop()
    else:
        res = drv.window(seconds, sync)
    win_peak = torch.cuda.max_memory_allocated() if cuda else 0
    spans.remove()
    bad = forbidden_modules()
    if bad:
        raise ImportError(f"modules of JAX or the JAX package are loaded: {bad}")

    metrics, dev = {}, {}
    kind = torch.cuda.get_device_name() if cuda else "cpu"
    dev.update(platform="gpu" if cuda else "cpu", kind=kind,
               count=1, memory_peak_bytes=int(max(pre_peak, win_peak)), card=card_line()
               if cuda else "cpu")
    breakdown = None
    if trace:
        events = tr.events_of(prof)
        del prof
        reading = tr.read(events, sys.modules[type(drv).__module__].PARTS)
        del events
        peaks = load_json(HERE / "peaks.json")[kind]
        reading.counts = dict(counts(cfg, tf["kind"]), peak_flops=peaks[cfg["peak"]],
                              hbm=peaks["hbm_bytes_per_s"])
        for m in sp["per_layer"]:
            if applies(m, name):
                v = reader(m["name"])(reading)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=reading.busy_s, window_s=reading.window_s)
        breakdown = {"device_ops": reading.device_ops, "idle_gaps": reading.idle_gaps}
    else:
        values = dict(res, setup_s=setup_s, peak_mem_gib=win_peak / 2**30)
        for m in sp["end_to_end"]:
            if applies(m, name):
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    drv.release()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t_check = time.perf_counter()
    compared = drv.check()["program"]
    ref_peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    parts = ", ".join(f"{k} {v:.3f}" for k, v in drv.phases.parts.items())
    print(f"set-up parts (s, host clock): imports {imports_s:.3f}, {parts}", file=sys.stderr)
    print(f"set-up {setup_s:.3f} s, window {res['window_s']:.3f} s, reference check "
          f"{time.perf_counter() - t_check:.3f} s (host clock), its peak {ref_peak:.2f} GiB",
          file=sys.stderr, flush=True)
    print(f"readings {json.dumps(compared)}", file=sys.stderr, flush=True)
    checks, lines, correct = {}, [], True
    for key, limit in lim.items():
        v = compared[key]
        ok = math.isfinite(v) and v <= limit
        correct &= ok
        checks[key] = {"value": v, "limit": limit}
        lines.append(f"check {key} = {v!r} (limit {limit!r}){'' if ok else ' FAILED'}")
    bad = forbidden_modules()
    if bad:
        raise ImportError(f"modules of JAX or the JAX package are loaded: {bad}")
    out = {"correct": bool(correct), "attempted": int(res["steps"]), "failed": 0,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's benchmark: one run of one workload")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sp = spec()
    wl = workload(sp, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the workload needs {wl['chips']} CUDA device(s); {n} available",
              file=sys.stderr)
        return 3
    out, lines = run(args.workload, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda"), sp=sp)
    print(json.dumps(out), flush=True)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
