"""The batch data model: surface / static / atmospheric variables as torch tensors.

Port of ``aurora_tpu/batch.py`` (reference: aurora/batch.py:23-292) without the regrid and
netCDF helpers. Variables are tensors (numpy arrays are accepted and converted by
:meth:`Batch.to`); ``lat``/``lon`` stay host-side numpy, because they only feed the
float64 host encodings.
"""

from __future__ import annotations

import dataclasses
from datetime import datetime
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from aurora_tpu_torch.normalisation import (
    normalise_atmos_var,
    normalise_surf_var,
    unnormalise_atmos_var,
    unnormalise_surf_var,
)

__all__ = ["Metadata", "Batch"]


@dataclasses.dataclass
class Metadata:
    """Metadata carried with every batch.

    Args:
        lat: Latitudes, decreasing, in ``[-90, 90]``. Vector or matrix.
        lon: Longitudes, increasing, in ``[0, 360)``. Vector or matrix.
        time: Per-batch-element time of the *most recent* history entry.
        atmos_levels: Pressure levels of the atmospheric variables in hPa.
        rollout_step: Number of autoregressive steps used to produce this data.
    """

    lat: np.ndarray
    lon: np.ndarray
    time: tuple[datetime, ...]
    atmos_levels: tuple[int | float, ...]
    rollout_step: int = 0

    def __post_init__(self):
        lat, lon = _host(self.lat), _host(self.lon)
        if not (np.all(lat <= 90) and np.all(lat >= -90)):
            raise ValueError("Latitudes must be in the range [-90, 90].")
        if not (np.all(lon >= 0) and np.all(lon < 360)):
            raise ValueError("Longitudes must be in the range [0, 360).")
        if lat.ndim == lon.ndim == 1:
            if not np.all(np.diff(lat) < 0):
                raise ValueError("Latitudes must be strictly decreasing.")
            if not np.all(np.diff(lon) > 0):
                raise ValueError("Longitudes must be strictly increasing.")
        elif lat.ndim == lon.ndim == 2:
            if not np.all(lat[1:, :] - lat[:-1, :] <= 0):
                raise ValueError("Latitudes must be decreasing along every column.")
            if not np.all(lon[:, 1:] - lon[:, :-1] > 0):
                raise ValueError("Longitudes must be strictly increasing along every row.")
        else:
            raise ValueError(
                "The latitudes and longitudes must either both be vectors or both be matrices."
            )


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass
class Batch:
    """A batch: ``surf_vars`` ``(b, t, h, w)``, ``static_vars`` ``(h, w)``,
    ``atmos_vars`` ``(b, t, c, h, w)``, plus :class:`Metadata`."""

    surf_vars: dict[str, torch.Tensor]
    static_vars: dict[str, torch.Tensor]
    atmos_vars: dict[str, torch.Tensor]
    metadata: Metadata

    @property
    def spatial_shape(self) -> tuple[int, int]:
        return tuple(next(iter(self.surf_vars.values())).shape[-2:])

    def normalise(self, surf_stats: Optional[Mapping[str, tuple[float, float]]] = None) -> "Batch":
        """Normalise all variables (z-scoring with climatological statistics)."""
        levels = self.metadata.atmos_levels
        return Batch(
            surf_vars={k: normalise_surf_var(v, k, surf_stats) for k, v in self.surf_vars.items()},
            static_vars={
                k: normalise_surf_var(v, k, surf_stats) for k, v in self.static_vars.items()
            },
            atmos_vars={k: normalise_atmos_var(v, k, levels) for k, v in self.atmos_vars.items()},
            metadata=self.metadata,
        )

    def unnormalise(
        self, surf_stats: Optional[Mapping[str, tuple[float, float]]] = None
    ) -> "Batch":
        """Undo :meth:`normalise`."""
        levels = self.metadata.atmos_levels
        return Batch(
            surf_vars={
                k: unnormalise_surf_var(v, k, surf_stats) for k, v in self.surf_vars.items()
            },
            static_vars={
                k: unnormalise_surf_var(v, k, surf_stats) for k, v in self.static_vars.items()
            },
            atmos_vars={
                k: unnormalise_atmos_var(v, k, levels) for k, v in self.atmos_vars.items()
            },
            metadata=self.metadata,
        )

    def crop(self, patch_size: int) -> "Batch":
        """Crop to a multiple of the patch size (drops at most one extra latitude row)."""
        h, w = self.spatial_shape
        if w % patch_size != 0:
            raise ValueError("Width of the data must be a multiple of the patch size.")
        if h % patch_size == 0:
            return self
        if h % patch_size != 1:
            raise ValueError(
                f"There can at most be one latitude too many, but there are "
                f"{h % patch_size} too many."
            )
        lat, lon = _host(self.metadata.lat), _host(self.metadata.lon)
        return Batch(
            surf_vars={k: v[..., :-1, :] for k, v in self.surf_vars.items()},
            static_vars={k: v[..., :-1, :] for k, v in self.static_vars.items()},
            atmos_vars={k: v[..., :-1, :] for k, v in self.atmos_vars.items()},
            metadata=Metadata(
                lat=lat[:-1],
                lon=lon if lon.ndim == 1 else lon[:-1, :],
                time=self.metadata.time,
                atmos_levels=self.metadata.atmos_levels,
                rollout_step=self.metadata.rollout_step,
            ),
        )

    def _fmap(self, f: Callable) -> "Batch":
        return Batch(
            surf_vars={k: f(v) for k, v in self.surf_vars.items()},
            static_vars={k: f(v) for k, v in self.static_vars.items()},
            atmos_vars={k: f(v) for k, v in self.atmos_vars.items()},
            metadata=self.metadata,
        )

    def to(self, device=None, dtype: Optional[torch.dtype] = None) -> "Batch":
        """Every variable as a tensor on ``device`` (and of ``dtype``, if given)."""
        return self._fmap(lambda v: torch.as_tensor(v).to(device=device, dtype=dtype))

    def astype(self, dtype: torch.dtype) -> "Batch":
        """Every variable as ``dtype``, on the device it lies on; ``lat``/``lon`` stay host
        arrays of at least float32 (float64 for a float64 batch)."""
        lat_lon = np.float64 if dtype == torch.float64 else np.float32
        md = self.metadata
        return Batch(
            surf_vars={k: torch.as_tensor(v).to(dtype) for k, v in self.surf_vars.items()},
            static_vars={k: torch.as_tensor(v).to(dtype) for k, v in self.static_vars.items()},
            atmos_vars={k: torch.as_tensor(v).to(dtype) for k, v in self.atmos_vars.items()},
            metadata=Metadata(
                lat=_host(md.lat).astype(lat_lon),
                lon=_host(md.lon).astype(lat_lon),
                time=md.time,
                atmos_levels=md.atmos_levels,
                rollout_step=md.rollout_step,
            ),
        )

    def to_numpy(self) -> "Batch":
        """Every variable as a host NumPy array (``.cpu()`` waits for the device)."""
        return self._fmap(_host)

    def replace(self, **kwargs) -> "Batch":
        return dataclasses.replace(self, **kwargs)
