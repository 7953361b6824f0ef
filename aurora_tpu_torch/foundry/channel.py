"""The naming of prediction files that the serving stack's channel exchanges (port of
``aurora_tpu/foundry/channel.py:210-214``; the channels themselves are not ported yet)."""

from __future__ import annotations

import os
from typing import Generator

__all__ = ["iterate_prediction_files"]


def iterate_prediction_files(name: str, num_steps: int) -> Generator[str, None, None]:
    """Per-step prediction file names: ``prediction-000.nc``, ``prediction-001.nc``, ..."""
    base, ext = os.path.splitext(name)
    for i in range(num_steps):
        yield f"{base}-{i:03d}{ext}"
