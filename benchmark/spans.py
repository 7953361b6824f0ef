"""Readings of the program's own spans: the ranges named ``aurora:...`` that the port opens
while a ``torch.profiler`` session records (``aurora_tpu_torch.utils.profiling``), which the
traced run's session holds after the window. Each is device time (the stream's time between
a span's two events) in milliseconds per step of the window.

A program without the spans (an older checkout) and a run without device times (the CPU)
read nothing: every function returns None, and a CPU time is never given under a device
metric's name."""

from __future__ import annotations

from typing import Optional


def recorded():
    """The program's records of the latest session, or None where the program has none."""
    try:
        from aurora_tpu_torch.utils.profiling import recorded as program_recorded
    except ImportError:
        return None
    return program_recorded()


def _per_step(r, seconds: Optional[float]) -> Optional[float]:
    if seconds is None or not r.steps:
        return None
    return 1e3 * seconds / r.steps


def ms(r, name: str, ancestor: Optional[str] = None) -> Optional[float]:
    """Device ms per step of the spans called ``name`` (with ``ancestor``: of those nested
    in a span called ``ancestor``); None where there is none or it has no device time."""
    rec = recorded()
    if rec is None or name not in rec:
        return None
    if ancestor is None:
        return _per_step(r, rec[name].device_s)
    return _per_step(r, rec.inside(name, ancestor))


def ms_without(r, outer: str, inner: str) -> Optional[float]:
    """Device ms per step of the spans called ``outer`` less that of the spans matching
    ``inner`` (a name, or a prefix ending in ``*``) nested in them, the outermost of those
    only; None where ``outer`` has no device time."""
    rec = recorded()
    if rec is None or outer not in rec or rec[outer].device_s is None:
        return None
    nested = rec.inside(inner, outer)
    if nested is None:
        return None
    return _per_step(r, rec[outer].device_s - nested)
