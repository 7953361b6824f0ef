"""Profiling and roofline utilities (port of ``aurora_tpu/utils/profiling.py``).

* :func:`trace`: ``torch.profiler`` around a block, the card's kernels and copies included
  where there is one, written as a Chrome trace.
* :func:`timed`: the host clock around a block, the card synchronised before each reading.
* :func:`roofline`: the least time an operation's work could take on the card, from the
  published figures of the H100 SXM (989 TF/s dense bf16, 3.35 TB/s). Another device's name
  raises: no other card's figures are in the table.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

__all__ = ["CHIP_SPECS", "roofline", "timed", "trace"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU and, with a card, CUDA activity) and
    write ``log_dir/trace.json``, a Chrome trace (chrome://tracing, Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(label: str, result_holder: Optional[list] = None):
    """Host-clock seconds of the block, the card synchronised before the clock is read at
    each end, so that the work the block queued is inside; appended to ``result_holder``
    when given, and printed in ms."""
    _sync()
    t0 = time.perf_counter()
    yield
    _sync()
    dt = time.perf_counter() - t0
    if result_holder is not None:
        result_holder.append(dt)
    print(f"[{label}] {dt * 1e3:.1f} ms")


# Published figures per card, by ``torch.cuda.get_device_name``: dense bf16 tensor-core
# FLOP/s and memory bytes/s.
CHIP_SPECS = {
    "NVIDIA H100 80GB HBM3": {"bf16_tflops": 989.0, "hbm_gbps": 3350.0},
}


def roofline(flops: float, bytes_moved: float, device=None) -> dict:
    """The compute and memory floors of an operation of ``flops`` bf16 operations moving
    ``bytes_moved`` bytes on ``device`` (a device name, an index or a ``torch.device``; the
    current card by default). Raises for a device not in :data:`CHIP_SPECS`."""
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        name = device
    elif device is not None and torch.device(device).type != "cuda":
        name = str(device)
    elif torch.cuda.is_available():
        name = torch.cuda.get_device_name(device)
    else:
        raise RuntimeError("roofline needs a card, or the name of one in CHIP_SPECS")
    if name not in CHIP_SPECS:
        raise ValueError(f"no published figures for {name!r}; known: {sorted(CHIP_SPECS)}")
    spec = CHIP_SPECS[name]
    t_compute = flops / (spec["bf16_tflops"] * 1e12)
    t_memory = bytes_moved / (spec["hbm_gbps"] * 1e9)
    return {
        "device": name,
        "compute_s": t_compute,
        "memory_s": t_memory,
        "bound": "compute" if t_compute > t_memory else "memory",
        "floor_s": max(t_compute, t_memory),
    }
