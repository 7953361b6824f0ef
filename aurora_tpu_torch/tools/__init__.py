"""The tools of the port, run as ``python -m aurora_tpu_torch.tools.<name>``:

* :mod:`~aurora_tpu_torch.tools.backbone_ablate` (counterpart of ``tools/backbone_ablate.py``),
* :mod:`~aurora_tpu_torch.tools.gemm_probe` (``tools/gemm_probe.py``),
* :mod:`~aurora_tpu_torch.tools.smem_probe` (``tools/vmem_probe.py``),
* :mod:`~aurora_tpu_torch.tools.perf_breakdown`, :mod:`~aurora_tpu_torch.tools.encoder_breakdown`
  and :mod:`~aurora_tpu_torch.tools.decoder_breakdown` (``tools/{perf,encoder,decoder}_
  breakdown.py``): the main step part by part;
* :mod:`~aurora_tpu_torch.tools.kernel_ablate` (the card only): the redesigned kernels
  against ablated builds of themselves;
* :mod:`~aurora_tpu_torch.tools.variant_bench` and :mod:`~aurora_tpu_torch.tools.highres_bench`
  (``tools/variant_bench.py``, ``tools/highres_bench.py``): roll-outs of the air-pollution,
  wave and 0.1 degree models at their own grids;
* :mod:`~aurora_tpu_torch.tools.bench` (``bench.py``, ``tools/rollout_scan_bench.py``): the
  benchmark entry, one configuration's ``rollout`` or ``rollout_scan`` step by step, with
  peak memory and the device's idle share;
* :mod:`~aurora_tpu_torch.tools.train_bench`, :mod:`~aurora_tpu_torch.tools.rollout_train_bench`
  and :mod:`~aurora_tpu_torch.tools.train_speed_probe` (``tools/train_bench.py``,
  ``tools/rollout_train_bench.py``, ``tools/train_speed_probe.py``): the train steps;
* :mod:`~aurora_tpu_torch.tools.rollout_bench` (``tools/rollout_bench.py``): a roll-out with
  the cyclone tracker on every prediction.

Each has a ``main(argv=None)`` that prints one line per result and returns the results (a
list of dicts; ``bench`` and the train and roll-out tools: one dict, their last line). They
run on the card unless ``--device cpu`` is given; on the CPU every kernel wrapper takes its
plain version and the times are host times of those, good for rehearsing the control flow
and nothing else. Every result names its device.

This module holds what they share: the card's published peaks, timing, the error
measures and the result line.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Optional

import numpy as np
import torch

from aurora_tpu_torch.model.aurora import resolve_device

__all__ = [
    "HBM", "PEAK_BF16", "PEAK_F32", "bound_ms", "branch_err", "card_line", "rel_err", "report",
    "resolve_device", "result", "time_ms",
]

PEAK_BF16 = 989e12  # dense bf16 tensor-core FLOP/s, H100 SXM
PEAK_F32 = 67e12  # f32 FLOP/s outside the tensor cores
HBM = 3.35e12  # bytes/s


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


_PAD_BYTES = 256 << 20


def time_ms(fn: Callable[[], object], device: torch.device, steps: int, warmup: int = 2) -> float:
    """Median time of ``steps`` runs of ``fn`` after ``warmup`` runs: CUDA events on the
    card, the host clock on the CPU.

    On the card a 256 MB memset goes ahead of every run. It takes longer than a wrapper's
    host work, so the launch is already queued when the device reaches the first event and
    the host's time between the event and the launch is not counted; and it leaves the
    50 MB L2 cold, as a caller in the model finds it. The buffer lives for the call only,
    so it counts in no peak-memory reading taken around other work.
    """
    pad = torch.empty(_PAD_BYTES, dtype=torch.uint8, device=device) if device.type == "cuda" else None
    times = []
    for i in range(warmup + steps):
        if device.type == "cuda":
            pad.zero_()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            t = s.elapsed_time(e)
        else:
            t0 = time.perf_counter()
            fn()
            t = 1e3 * (time.perf_counter() - t0)
        if i >= warmup:
            times.append(t)
    return float(np.median(times))


def bound_ms(flops_bf16: float = 0.0, flops_f32: float = 0.0, nbytes: float = 0.0):
    """``(ms, "operations" | "bytes")``: the least time the card could take for the work."""
    ops = flops_bf16 / PEAK_BF16 + flops_f32 / PEAK_F32
    mem = nbytes / HBM
    return 1e3 * max(ops, mem), "operations" if ops >= mem else "bytes"


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max ``|got - want|`` over max ``|want|``: the measure of outputs with no residual."""
    g, w = got.float(), want.float()
    return ((g - w).abs().max() / (w.abs().max() + 1e-30)).item()


def branch_err(got, want, residual) -> tuple[float, float]:
    """``(max |got - want|, branch error)`` of bf16 outputs ``residual + branch``.

    The branch error is the largest ``|got - want|`` less one bf16 ulp of the larger of
    the two (both round an f32 sum, and two sums an f32 hair apart can round one ulp
    apart), over the largest ``|want - residual|``.
    """
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    mant, exp = torch.frexp(torch.maximum(g.abs(), w.abs()))
    ulp = torch.where(mant > 0, torch.ldexp(torch.ones_like(g), exp - 8), 0.0)
    del g, mant, exp
    excess = (diff - ulp).clamp_min(0).max().item()
    size = (w - residual.float()).abs().max().item()
    return diff.max().item(), excess / (size + 1e-30)


def result(label: str, ms: float, device: torch.device, *, flops: float = 0.0,
           nbytes: float = 0.0, f32: bool = False, err: Optional[float] = None, **extra) -> dict:
    """One result: the time, the rate and its share of the card's peak (bf16 tensor-core
    peak, or the f32 peak with ``f32``; of the memory rate when only bytes are given), the
    bound for the work and the error against the plain version where a kernel ran."""
    r = dict(label=label, ms=ms, device=device.type)
    s = 1e-3 * ms
    if flops:
        peak = PEAK_F32 if f32 else PEAK_BF16
        r.update(tflops=flops / s / 1e12, share_of_peak=flops / s / peak)
    elif nbytes:
        r.update(gbps=nbytes / s / 1e9, share_of_peak=nbytes / s / HBM)
    if flops or nbytes:
        b, by = bound_ms(**{"flops_f32" if f32 else "flops_bf16": flops}, nbytes=nbytes)
        r.update(bound_ms=b, bound_by=by)
    if err is not None:
        r["err"] = err
    r.update(extra)
    return r


def report(r: dict) -> dict:
    """Print one result as one line; returns it."""
    parts = [f"{r['label']}: {r['ms']:8.3f} ms"]
    if "tflops" in r:
        parts.append(f"= {r['tflops']:6.1f} TF/s ({100 * r['share_of_peak']:4.1f}% of peak)")
    elif "gbps" in r:
        parts.append(f"= {r['gbps']:7.1f} GB/s ({100 * r['share_of_peak']:4.1f}% of 3.35 TB/s)")
    if "bound_ms" in r:
        parts.append(f"bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
    skip = {"label", "ms", "tflops", "gbps", "share_of_peak", "bound_ms", "bound_by"}
    parts += [f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
              for k, v in r.items() if k not in skip]
    print("  ".join(parts), flush=True)
    return r
