"""The batch data model: surface / static / atmospheric variables as torch tensors.

Port of ``aurora_tpu/batch.py`` (reference: aurora/batch.py:23-292). Variables are tensors
(numpy arrays are accepted and converted by :meth:`Batch.to`); ``lat``/``lon`` stay
host-side numpy, because they only feed the float64 host encodings.

Regridding and netCDF I/O are host work in NumPy, as in the JAX package: :meth:`Batch.regrid`
interpolates in float64 through the native C++ kernel (:mod:`aurora_tpu_torch.native`), or
scipy where it cannot be built, and returns float32 tensors on the device each field came
from; :meth:`Batch.to_netcdf` / :meth:`Batch.from_netcdf` write and read the JAX package's
file format, through xarray where it imports and scipy's netCDF3 form otherwise
(``aurora_tpu/batch.py:268-289``, ``:417-486``).
"""

from __future__ import annotations

import dataclasses
from datetime import datetime, timezone
from pathlib import Path
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from aurora_tpu_torch.normalisation import (
    normalise_atmos_var,
    normalise_surf_var,
    unnormalise_atmos_var,
    unnormalise_surf_var,
)

__all__ = ["Metadata", "Batch", "interpolate_numpy", "interpolate_scipy"]


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

    def regrid(self, res: float) -> "Batch":
        """Bilinearly regrid to a regular global grid of ``res`` degrees
        (``aurora_tpu/batch.py:235-266``): on the host in float64, each field returned as a
        float32 tensor on the device it was on (host arrays come back on the CPU)."""
        shape = (round(180 / res) + 1, round(360 / res))
        lat_new = np.linspace(90, -90, shape[0])
        lon_new = np.linspace(0, 360, shape[1], endpoint=False)
        lat = _host(self.metadata.lat).astype(np.float64)
        lon = _host(self.metadata.lon).astype(np.float64)

        def interp(v):
            device = v.device if isinstance(v, torch.Tensor) else "cpu"
            out = interpolate_numpy(_host(v).astype(np.float64), lat, lon, lat_new, lon_new)
            return torch.from_numpy(out.astype(np.float32)).to(device)

        md = self.metadata
        return Batch(
            surf_vars={k: interp(v) for k, v in self.surf_vars.items()},
            static_vars={k: interp(v) for k, v in self.static_vars.items()},
            atmos_vars={k: interp(v) for k, v in self.atmos_vars.items()},
            metadata=Metadata(
                lat=lat_new.astype(np.float32),
                lon=lon_new.astype(np.float32),
                atmos_levels=md.atmos_levels,
                time=md.time,
                rollout_step=md.rollout_step,
            ),
        )

    def to_netcdf(self, path: str | Path) -> None:
        """Write the batch to a netCDF file in the JAX package's format: through xarray where
        it imports, else scipy's netCDF3 writer."""
        try:
            import xarray  # noqa: F401
        except ImportError:
            _to_netcdf_scipy(self, path)
        else:
            _to_netcdf_xarray(self, path)

    @classmethod
    def from_netcdf(cls, path: str | Path) -> "Batch":
        """Read a batch written by :meth:`to_netcdf` (or by the JAX package's); the
        variables are host NumPy arrays."""
        try:
            import xarray  # noqa: F401
        except ImportError:
            return _from_netcdf_scipy(cls, path)
        return _from_netcdf_xarray(cls, path)


def interpolate_numpy(v: np.ndarray, lat: np.ndarray, lon: np.ndarray, lat_new: np.ndarray,
                      lon_new: np.ndarray) -> np.ndarray:
    """Bilinear interpolation on the sphere of ``(..., H, W)`` fields, the longitude periodic
    and out-of-range latitudes extrapolated linearly (``aurora_tpu/batch.py:319-363``;
    reference: aurora/batch.py:320-362), in float64: the native kernel where it is built,
    else :func:`interpolate_scipy`."""
    from aurora_tpu_torch.native import regrid_bilinear

    args = [np.asarray(a, dtype=np.float64) for a in (v, lat, lon, lat_new, lon_new)]
    out = regrid_bilinear(*args)
    return interpolate_scipy(*args) if out is None else out


def interpolate_scipy(v: np.ndarray, lat: np.ndarray, lon: np.ndarray, lat_new: np.ndarray,
                      lon_new: np.ndarray) -> np.ndarray:
    """:func:`interpolate_numpy` through scipy's ``RegularGridInterpolator`` over the
    longitudes extended by one column on each side."""
    from scipy.interpolate import RegularGridInterpolator

    assert (np.diff(lon) > 0).all()
    lon_ext = np.concatenate((lon[-1:] - 360, lon, lon[:1] + 360))
    batch_shape = v.shape[:-2]
    v = v.reshape(-1, *v.shape[-2:])
    grid = np.meshgrid(lat_new, lon_new, indexing="ij", sparse=True)
    out = []
    for vi in v:
        vi = np.concatenate((vi[:, -1:], vi, vi[:, :1]), axis=1)
        rgi = RegularGridInterpolator((lat, lon_ext), vi, method="linear", bounds_error=False,
                                      fill_value=None)
        out.append(rgi(tuple(grid)))
    return np.stack(out, axis=0).reshape(*batch_shape, lat_new.shape[0], lon_new.shape[0])


# ---------------------------------------------------------------------- netCDF helpers
# The file format of ``aurora_tpu/batch.py:417-486``: dimensions batch, history, level,
# latitude, longitude; variables ``surf_*``, ``static_*``, ``atmos_*`` (float32, float64
# where the array is), ``latitude``, ``longitude``, ``level`` (float64) and ``time`` (UTC
# seconds); the roll-out step a global attribute.


def _to_netcdf_scipy(batch: Batch, path) -> None:
    from scipy.io import netcdf_file

    b = batch.to_numpy()
    md = b.metadata
    lat, lon = _host(md.lat), _host(md.lon)
    some = next(iter(b.surf_vars.values()))
    B, T = some.shape[:2]
    with netcdf_file(str(path), "w") as f:
        f.createDimension("batch", B)
        f.createDimension("history", T)
        f.createDimension("level", len(md.atmos_levels))
        f.createDimension("latitude", lat.shape[0])
        f.createDimension("longitude", lon.shape[-1])

        def mkvar(name, dims, data):
            var = f.createVariable(name, np.float64 if data.dtype == np.float64 else "f", dims)
            var[:] = np.asarray(data, dtype=var.data.dtype)

        mkvar("latitude", ("latitude",) if lat.ndim == 1 else ("latitude", "longitude"), lat)
        mkvar("longitude", ("longitude",) if lon.ndim == 1 else ("latitude", "longitude"), lon)
        mkvar("level", ("level",), np.asarray(md.atmos_levels, dtype=np.float64))
        times = np.asarray([t.replace(tzinfo=timezone.utc).timestamp() for t in md.time],
                           dtype=np.float64)
        mkvar("time", ("batch",), times)
        # scipy's scalar variables do not write with current NumPy: a global attribute.
        f.rollout_step = int(md.rollout_step)
        for k, v in b.surf_vars.items():
            mkvar(f"surf_{k}", ("batch", "history", "latitude", "longitude"), v)
        for k, v in b.static_vars.items():
            mkvar(f"static_{k}", ("latitude", "longitude"), v)
        for k, v in b.atmos_vars.items():
            mkvar(f"atmos_{k}", ("batch", "history", "level", "latitude", "longitude"), v)


def _from_netcdf_scipy(cls, path) -> Batch:
    from scipy.io import netcdf_file

    with netcdf_file(str(path), "r") as f:
        names = list(f.variables)
        surf = [k[len("surf_"):] for k in names if k.startswith("surf_")]
        static = [k[len("static_"):] for k in names if k.startswith("static_")]
        atmos = [k[len("atmos_"):] for k in names if k.startswith("atmos_")]

        def get(name):
            arr = np.array(f.variables[name][:])
            if arr.dtype.byteorder == ">":  # netCDF3 is big-endian: to the native order
                arr = arr.astype(arr.dtype.newbyteorder("="))
            return arr

        times = tuple(datetime.fromtimestamp(t, tz=timezone.utc).replace(tzinfo=None)
                      for t in get("time"))
        return cls(
            surf_vars={k: get(f"surf_{k}") for k in surf},
            static_vars={k: get(f"static_{k}") for k in static},
            atmos_vars={k: get(f"atmos_{k}") for k in atmos},
            metadata=Metadata(
                lat=get("latitude"),
                lon=get("longitude"),
                time=times,
                atmos_levels=tuple(float(x) for x in get("level")),
                rollout_step=int(f.rollout_step),
            ),
        )


def _to_netcdf_xarray(batch: Batch, path) -> None:
    import xarray as xr

    b = batch.to_numpy()
    md = b.metadata
    ds = xr.Dataset(
        {
            **{f"surf_{k}": (("batch", "history", "latitude", "longitude"), v)
               for k, v in b.surf_vars.items()},
            **{f"static_{k}": (("latitude", "longitude"), v) for k, v in b.static_vars.items()},
            **{f"atmos_{k}": (("batch", "history", "level", "latitude", "longitude"), v)
               for k, v in b.atmos_vars.items()},
        },
        coords={
            "latitude": _host(md.lat),
            "longitude": _host(md.lon),
            "time": list(md.time),
            "level": list(md.atmos_levels),
            "rollout_step": md.rollout_step,
        },
    )
    ds.to_netcdf(path)


def _from_netcdf_xarray(cls, path) -> Batch:
    import xarray as xr

    ds = xr.load_dataset(path, engine="netcdf4")
    surf = [k.removeprefix("surf_") for k in ds if str(k).startswith("surf_")]
    static = [k.removeprefix("static_") for k in ds if str(k).startswith("static_")]
    atmos = [k.removeprefix("atmos_") for k in ds if str(k).startswith("atmos_")]
    return cls(
        surf_vars={k: np.asarray(ds[f"surf_{k}"].values) for k in surf},
        static_vars={k: np.asarray(ds[f"static_{k}"].values) for k in static},
        atmos_vars={k: np.asarray(ds[f"atmos_{k}"].values) for k in atmos},
        metadata=Metadata(
            lat=np.asarray(ds.latitude.values),
            lon=np.asarray(ds.longitude.values),
            time=tuple(ds.time.values.astype("datetime64[s]").tolist()),
            atmos_levels=tuple(ds.level.values),
            rollout_step=int(ds.rollout_step.values),
        ),
    )
