"""The traced run: spans opened by the benchmark's own hooks, a ``torch.profiler`` trace of
the window, and the arithmetic that turns the trace into per-layer readings.

Spans are ``record_function`` ranges named ``bench:<name>``: one around the window, one
around each step, and one around each call of the model parts that :meth:`Spans.hook`
hooks (forward pre- and post-hooks). A device operation (kernel, memcpy, memset) belongs to
a span when its launch (the CUDA runtime call with the same correlation id) was made on the
span's thread inside the span. Launches made on another thread than the window's are the
autograd engine's (the backward). The device's busy time is the union of its operations'
intervals inside the window; the idle share is one minus busy time over the window.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile
import time
from typing import Callable, Iterable, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PREFIX = "bench:"


class Spans:
    """``record_function`` ranges around the forward calls of named modules."""

    def __init__(self):
        self.handles = []

    def hook(self, name: str, module: torch.nn.Module) -> None:
        stack = []

        def pre(mod, args):
            rf = torch.autograd.profiler.record_function(PREFIX + name)
            rf.__enter__()
            stack.append(rf)

        def post(mod, args, out):
            stack.pop().__exit__(None, None, None)

        self.handles += [module.register_forward_pre_hook(pre),
                         module.register_forward_hook(post)]

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []


class Phases:
    """Host-clock seconds of the parts of set-up, each part ended by ``sync``."""

    def __init__(self, sync: Callable[[], None]):
        self.sync, self.at, self.parts = sync, time.perf_counter(), {}

    def mark(self, name: str) -> None:
        self.sync()
        now = time.perf_counter()
        self.parts[name] = now - self.at
        self.at = now


def span(name: str):
    return torch.autograd.profiler.record_function(PREFIX + name)


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def events_of(prof) -> list[dict]:
    """The Chrome trace's events, written under ``TMPDIR`` and deleted."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def union(intervals: Iterable[tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to ``[lo, hi]``."""
    covered, reach = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, reach), min(e, hi)
        if e > s:
            covered += e - s
            reach = e
    return covered


def gaps(intervals: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle intervals of ``[lo, hi]`` outside ``intervals``."""
    out, reach = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > reach:
            out.append((reach, s))
        reach = max(reach, e)
    if hi > reach:
        out.append((reach, hi))
    return out


@dataclasses.dataclass
class Reading:
    """What the readers of :mod:`benchmark.metrics` read from one traced window. Times in
    seconds."""

    window_s: float
    busy_s: float
    steps: int
    span_s: dict  # span name -> device seconds launched inside it
    outside_s: float  # device seconds launched on the window's thread outside every part span
    other_thread_s: float  # device seconds launched on other threads (the autograd engine)
    device_ops: list  # [[name, seconds], ...] the ten longest operations by total time
    idle_gaps: list  # [[what the host was doing, seconds], ...] the ten longest gaps
    counts: dict = dataclasses.field(default_factory=dict)  # set by the harness

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def read(events: list[dict], parts: tuple[str, ...]) -> Reading:
    """Reduce a trace of one window (span ``bench:window``) to a :class:`Reading`; ``parts``
    are the names of the hooked spans."""
    us = 1e-6
    annotations = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and str(e.get("name", "")).startswith(PREFIX)]
    windows = [e for e in annotations if e["name"] == PREFIX + "window"]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} window spans, not one")
    win = windows[0]
    lo, hi, main = win["ts"], win["ts"] + win["dur"], win["tid"]
    steps = sum(1 for e in annotations if e["name"] == PREFIX + "step")

    launches = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e["tid"], e["ts"])
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    inside = [e for e in device if e["ts"] < hi and e["ts"] + e["dur"] > lo]
    if not inside:
        raise RuntimeError("the profiler recorded no device operation in the window: "
                           "the per-layer metrics are not measured")

    by_part = {p: sorted((e["ts"], e["ts"] + e["dur"]) for e in annotations
                         if e["name"] == PREFIX + p and e["tid"] == main) for p in parts}
    starts = {p: [s for s, _ in v] for p, v in by_part.items()}

    def part_of(ts: float) -> Optional[str]:
        for p, v in by_part.items():
            i = bisect.bisect_right(starts[p], ts) - 1
            if i >= 0 and v[i][0] <= ts <= v[i][1]:
                return p
        return None

    span_s = dict.fromkeys(parts, 0.0)
    outside = other = 0.0
    by_name = collections.Counter()
    for e in inside:
        d = e["dur"] * us
        by_name[e["name"]] += d
        tid, ts = launches.get(e.get("args", {}).get("correlation"), (main, e["ts"]))
        if tid != main:
            other += d
            continue
        p = part_of(ts)
        if p is None:
            outside += d
        else:
            span_s[p] += d

    busy = [(e["ts"], e["ts"] + e["dur"]) for e in inside]
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("tid") == main
                  and e.get("cat") in ("cpu_op", "user_annotation") + LAUNCH_CATS)

    def doing(t: float) -> str:
        best = None
        for s, e, name in host:
            if s > t:
                break
            if e >= t and (best is None or e - s < best[0]):
                best = (e - s, name)
        return best[1] if best else "host idle"

    idle = sorted(gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:10]
    return Reading(
        window_s=(hi - lo) * us, busy_s=union(busy, lo, hi) * us, steps=steps, span_s=span_s,
        outside_s=outside, other_thread_s=other,
        device_ops=[[n[:200], s] for n, s in by_name.most_common(10)],
        idle_gaps=[[doing((a + b) / 2)[:200], (b - a) * us] for a, b in idle],
    )
