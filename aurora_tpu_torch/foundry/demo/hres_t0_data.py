"""WeatherBench2 HRES-T0 initial-condition loader (port of
``aurora_tpu/foundry/demo/hres_t0_data.py``; reference: aurora/foundry/demo/hres_t0_data.py).

Builds a :class:`aurora_tpu_torch.Batch` of host arrays from the public WeatherBench2 zarr
archive. Requires ``xarray``, ``zarr``, ``gcsfs`` and network access; they are imported when
:func:`load_batch` runs, so the rest of the package works without them.
"""

from __future__ import annotations

from datetime import datetime

import numpy as np

from aurora_tpu_torch.batch import Batch, Metadata

WB2_HRES_T0 = "gs://weatherbench2/datasets/hres_t0/2016-2022-6h-1440x721.zarr"

SURF_MAP = {
    "2t": "2m_temperature",
    "10u": "10m_u_component_of_wind",
    "10v": "10m_v_component_of_wind",
    "msl": "mean_sea_level_pressure",
}
ATMOS_MAP = {
    "z": "geopotential",
    "u": "u_component_of_wind",
    "v": "v_component_of_wind",
    "t": "temperature",
    "q": "specific_humidity",
}
STATIC_MAP = {"lsm": "land_sea_mask", "z": "geopotential_at_surface", "slt": "soil_type"}


def load_batch(
    time: datetime,
    levels: tuple[int, ...] = (50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000),
    url: str = WB2_HRES_T0,
) -> Batch:
    """Load the two initial-condition timesteps ending at ``time``."""
    import xarray as xr

    ds = xr.open_zarr(url, chunks=None)
    times = [np.datetime64(time) - np.timedelta64(6, "h"), np.datetime64(time)]
    sel = ds.sel(time=times)

    surf = {
        k: sel[v].transpose("time", "latitude", "longitude").values[None]
        for k, v in SURF_MAP.items()
    }
    atmos = {
        k: sel[v]
        .sel(level=list(levels))
        .transpose("time", "level", "latitude", "longitude")
        .values[None]
        for k, v in ATMOS_MAP.items()
    }
    static = {
        k: (ds[v].isel(time=0) if "time" in ds[v].dims else ds[v]).values
        for k, v in STATIC_MAP.items()
    }

    lat = sel.latitude.values
    lon = sel.longitude.values
    if lat[0] < lat[-1]:  # ensure decreasing latitudes
        lat = lat[::-1]
        surf = {k: v[..., ::-1, :] for k, v in surf.items()}
        atmos = {k: v[..., ::-1, :] for k, v in atmos.items()}
        static = {k: v[..., ::-1, :] if v.ndim >= 2 else v for k, v in static.items()}

    return Batch(
        surf_vars=surf,
        static_vars=static,
        atmos_vars=atmos,
        metadata=Metadata(
            lat=lat, lon=lon % 360.0, time=(time,), atmos_levels=tuple(levels)
        ),
    )
