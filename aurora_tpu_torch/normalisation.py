"""Per-variable normalisation (z-scoring) of weather fields, on torch tensors.

Port of ``aurora_tpu/normalisation.py`` (reference: aurora/normalisation.py:17-74). The
statistics are the same constants (:mod:`aurora_tpu_torch._stats_data`).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from aurora_tpu_torch._stats_data import NORMALISATION_STATS

__all__ = [
    "NORMALISATION_STATS",
    "level_to_str",
    "surf_stat",
    "atmos_stats",
    "normalise_surf_var",
    "unnormalise_surf_var",
    "normalise_atmos_var",
    "unnormalise_atmos_var",
]


def level_to_str(level: float) -> str:
    """Canonical string form of a pressure level: ``850.0 -> "850"``, ``0.5 -> "0_5"``."""
    level = round(float(level), 3)
    if level % 1 == 0:
        level = int(level)
    return str(level).replace(".", "_")


def surf_stat(
    name: str, stats: Optional[Mapping[str, tuple[float, float]]] = None
) -> tuple[float, float]:
    """Location and scale for a surface-level or static variable."""
    if stats and name in stats:
        return tuple(stats[name])  # type: ignore[return-value]
    return NORMALISATION_STATS[name]


def atmos_stats(name: str, atmos_levels: Sequence[float]) -> tuple[np.ndarray, np.ndarray]:
    """Per-level location and scale vectors for an atmospheric variable."""
    pairs = [NORMALISATION_STATS[f"{name}_{level_to_str(lvl)}"] for lvl in atmos_levels]
    return np.array([p[0] for p in pairs]), np.array([p[1] for p in pairs])


def normalise_surf_var(x: torch.Tensor, name, stats=None, unnormalise: bool = False):
    """Normalise (or unnormalise) a surface-level variable of shape ``(..., h, w)``."""
    location, scale = surf_stat(name, stats)
    if unnormalise:
        return x * scale + location
    return (x - location) / scale


def normalise_atmos_var(x: torch.Tensor, name, atmos_levels, unnormalise: bool = False):
    """Normalise (or unnormalise) an atmospheric variable of shape ``(..., c, h, w)``."""
    locs, scales = atmos_stats(name, atmos_levels)
    locs = torch.as_tensor(locs, dtype=x.dtype, device=x.device)[:, None, None]
    scales = torch.as_tensor(scales, dtype=x.dtype, device=x.device)[:, None, None]
    if unnormalise:
        return x * scales + locs
    return (x - locs) / scales


def unnormalise_surf_var(x, name, stats=None):
    return normalise_surf_var(x, name, stats=stats, unnormalise=True)


def unnormalise_atmos_var(x, name, atmos_levels):
    return normalise_atmos_var(x, name, atmos_levels, unnormalise=True)
