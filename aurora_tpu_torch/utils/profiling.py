"""Profiling and roofline utilities (port of ``aurora_tpu/utils/profiling.py``).

* :func:`span`: a named range of the program (every name begins with ``aurora:``), recorded
  only while a ``torch.profiler`` session runs; :func:`recorded` gives the last session's
  totals per name.
* :func:`trace`: ``torch.profiler`` around a block, the card's kernels and copies included
  where there is one, written as a Chrome trace; the program's spans are in it.
* :func:`timed`: the host clock around a block, the card synchronised before each reading.
* :func:`roofline`: the least time an operation's work could take on the card, from the
  published figures of the H100 SXM (989 TF/s dense bf16, 3.35 TB/s). Another device's name
  raises: no other card's figures are in the table.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import NamedTuple, Optional

import torch

__all__ = ["CHIP_SPECS", "PREFIX", "Recorded", "SpanRecord", "SpanTotal", "recorded",
           "roofline", "span", "timed", "trace"]

PREFIX = "aurora:"  # the first characters of every span's name

_profiling = torch.autograd._profiler_enabled  # the one check a span makes without a session
_NULL = contextlib.nullcontext()
_sessions = 0  # profiler sessions started in this process (:func:`_count_sessions`)
_store: Optional["_Store"] = None  # the records of the latest session that opened a span
_store_lock = threading.Lock()


def _count_sessions() -> None:
    """Count the profiler sessions started in this process. Every session of
    ``torch.profiler`` and of ``torch.autograd.profiler`` starts by calling
    ``torch.autograd.profiler._run_on_profiler_start``; it is wrapped once, so that the first
    span of a new session can tell that it is new."""
    from torch.autograd import profiler as autograd_profiler

    start = autograd_profiler._run_on_profiler_start
    if getattr(start, "counts_sessions", False):
        return

    def on_start():
        global _sessions
        _sessions += 1
        start()

    on_start.counts_sessions = True
    autograd_profiler._run_on_profiler_start = on_start


_count_sessions()


class _Store:
    """The spans of one profiler session, one entry a span in each list: name, the index of
    its parent (-1 for none), the host clock at entry and at exit (None while open), with a
    card its two timing events until :func:`recorded` turns them into its device seconds.
    Only values that the garbage collector does not track are kept (strings, numbers,
    ``torch._C._CudaEventBase``; a pair of them is untracked at the collector's first look):
    the thousands of spans of a session, kept as objects, bring on full collections of the
    process's objects, each of which stops the host for a tenth of a second or more. Per
    thread, the stack of its open spans' indices."""

    def __init__(self, session: int):
        self.session = session
        self.names: list[str] = []
        self.parents: list[int] = []
        self.starts: list[float] = []
        self.ends: list[Optional[float]] = []
        self.events: list[Optional[tuple]] = []
        self.device_s: list[Optional[float]] = []
        self.open: dict[int, list[int]] = {}

    def open_span(self, name: str) -> tuple[list[int], int]:
        """Append a span opened now on this thread; its parent is the thread's innermost open
        span, or on a thread with none (the autograd engine's, running a backward), the span
        opened last of those still open on other threads. Returns the thread's stack and the
        span's index."""
        stack = self.open.setdefault(threading.get_ident(), [])
        if stack:
            parent = stack[-1]
        else:
            parent = max((s[-1] for s in list(self.open.values()) if s), default=-1)
        with _store_lock:
            i = len(self.names)
            self.names.append(name)
            self.parents.append(parent)
            self.starts.append(time.perf_counter())
            self.ends.append(None)
            self.events.append(_events())
            self.device_s.append(None)
        stack.append(i)
        return stack, i


def _session_store() -> _Store:
    global _store
    store = _store
    if store is None or store.session != _sessions:
        with _store_lock:
            if _store is None or _store.session != _sessions:
                _store = _Store(_sessions)
            store = _store
    return store


def _events() -> Optional[tuple]:
    """Two timing events, the first recorded now on the current stream; None without a
    card. ``torch.cuda.Event`` is a Python subclass, whose instances the garbage collector
    tracks; its base is not."""
    if not torch.cuda.is_initialized():
        return None
    a = torch._C._CudaEventBase(enable_timing=True)
    a.record(torch.cuda.current_stream())
    return a, torch._C._CudaEventBase(enable_timing=True)


class _Span:
    __slots__ = ("name", "range", "store", "stack", "index")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = torch.autograd.profiler.record_function(self.name)
        self.range.__enter__()
        self.store = _session_store()
        self.stack, self.index = self.store.open_span(self.name)
        return self

    def __exit__(self, *exc):
        store, i = self.store, self.index
        events = store.events[i]
        if events is not None:
            events[1].record(torch.cuda.current_stream())
        store.ends[i] = time.perf_counter()
        if self.stack and self.stack[-1] == i:
            self.stack.pop()
        self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that names a range of the program.

    While no ``torch.profiler`` (or ``torch.autograd.profiler``) session records, it does
    nothing beyond one check of ``torch.autograd._profiler_enabled()``. While one records, it
    opens ``record_function(name)``, a user annotation in the session's trace beside the
    device's operations, and keeps a record of the range: its name, its parent (the
    innermost span open on its thread), the host clock at entry and exit, and with a card a
    pair of timing events recorded on the current stream at entry and exit (never a
    synchronise). The records hold one session: the first span of a new session starts
    them anew. Read them with :func:`recorded`."""
    if not _profiling():
        return _NULL
    return _Span(name)


class SpanRecord(NamedTuple):
    """One span: ``parent`` the index of its parent in the same list (None for none),
    ``host_s`` None while it is open, ``device_s`` None without a card."""

    name: str
    parent: Optional[int]
    host_s: Optional[float]
    device_s: Optional[float]


class SpanTotal(NamedTuple):
    """The closed spans of one name: how many, their host seconds, and their device seconds
    (None without a card). A span's device time is the current stream's time between its
    two events: the device's idle inside the span counts."""

    calls: int
    host_s: float
    device_s: Optional[float]


class Recorded(dict):
    """Per span name a :class:`SpanTotal`, over the closed spans of ``records`` (a list of
    :class:`SpanRecord`, kept as ``records``)."""

    def __init__(self, records: list[SpanRecord]):
        super().__init__()
        self.records = records
        for r in records:
            if r.host_s is None:
                continue
            calls, host, dev = self.get(r.name, (0, 0.0, 0.0))
            dev = None if dev is None or r.device_s is None else dev + r.device_s
            self[r.name] = SpanTotal(calls + 1, host + r.host_s, dev)

    def inside(self, name: str, ancestor: str) -> Optional[float]:
        """Device seconds of the closed spans called ``name`` that have a span called
        ``ancestor`` among their ancestors; a ``name`` ending in ``*`` takes every name that
        begins with what precedes it, and of such spans nested in one another only the
        outermost count. None where one of them has no device time."""
        prefix = name[:-1] if name.endswith("*") else None

        def match(n):
            return n.startswith(prefix) if prefix is not None else n == name

        records, total = self.records, 0.0
        for r in records:
            if r.host_s is None or not match(r.name):
                continue
            up = r.parent
            while up is not None and records[up].name != ancestor and not match(records[up].name):
                up = records[up].parent
            if up is None or records[up].name != ancestor:
                continue
            if r.device_s is None:
                return None
            total += r.device_s
        return total


def recorded() -> Recorded:
    """The spans of the latest profiler session that opened one (they stay until the next
    session opens one), totalled per name. On a card, the first call after the session waits
    for the device and turns each closed span's events into its device seconds."""
    store = _store
    if store is None:
        return Recorded([])
    done = [i for i, (e, ev) in enumerate(zip(store.ends, store.events))
            if e is not None and ev is not None]
    if done:
        torch.cuda.synchronize()
        for i in done:
            a, b = store.events[i]
            store.device_s[i], store.events[i] = a.elapsed_time(b) * 1e-3, None
    records = [SpanRecord(name, None if parent < 0 else parent,
                          None if end is None else end - start, dev)
               for name, parent, start, end, dev in zip(store.names, store.parents,
                                                          store.starts, store.ends,
                                                          store.device_s)]
    return Recorded(records)


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
