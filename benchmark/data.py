"""Seeded inputs: weather fields made on the device from the seed, normal in normalised units
and put into physical units by the climatological statistics
(:data:`benchmark.reference.stats.NORMALISATION_STATS`), then copied to the host.

Every seed gives the same sizes; only the values and the start times change.
"""

from __future__ import annotations

import dataclasses
from datetime import datetime, timedelta

import numpy as np
import torch

from benchmark.reference.aurora import stats

EPOCH = datetime(2018, 1, 1)


def derive(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of draws (splitmix64 of ``seed`` and ``stream``)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) >> 1


def start_time(seed: int) -> datetime:
    """A 00, 06, 12 or 18 UTC start within four years, drawn from the seed."""
    return EPOCH + timedelta(hours=6 * (derive(seed, 7) % (4 * 365 * 4)))


@dataclasses.dataclass
class Grid:
    H: int
    W: int
    levels: tuple
    history: int
    batch: int

    @classmethod
    def of(cls, cfg: dict) -> "Grid":
        g = cfg["grid"]
        return cls(g["H"], g["W"], tuple(g["levels"]), g["history"], g["batch"])

    @property
    def lat(self) -> np.ndarray:
        return np.linspace(90, -90, self.H)

    @property
    def lon(self) -> np.ndarray:
        return np.linspace(0, 360, self.W, endpoint=False)


def _physical(z: torch.Tensor, name: str, levels=None) -> torch.Tensor:
    loc, scale = stats(name, levels)
    if levels is None:
        return z * float(scale) + float(loc)
    dev = z.device
    loc = torch.as_tensor(loc, dtype=z.dtype, device=dev)[:, None, None]
    scale = torch.as_tensor(scale, dtype=z.dtype, device=dev)[:, None, None]
    return z * scale + loc


def fields(cfg: dict, grid: Grid, gen: torch.Generator, device, T: int, static: bool = True,
           H: int | None = None):
    """``(surf, static, atmos)`` on ``device``, float32: ``surf {name: (B, T, H, W)}``,
    ``static {name: (H, W)}`` (None without ``static``), ``atmos {name: (B, T, C, H, W)}``;
    ``T = 0`` drops the time axis (targets)."""
    H = H or grid.H
    B, C = grid.batch, len(grid.levels)
    lead = (B, T) if T else (B,)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    surf = {k: _physical(randn(*lead, H, grid.W), k) for k in cfg["surf_vars"]}
    atmos = {k: _physical(randn(*lead, C, H, grid.W), k, grid.levels) for k in cfg["atmos_vars"]}
    st = ({k: _physical(randn(H, grid.W), k) for k in cfg["static_vars"]} if static else None)
    return surf, st, atmos
