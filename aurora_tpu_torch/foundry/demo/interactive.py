"""Interactive forecast map: field overlays + animated wind layer (port of
``aurora_tpu/foundry/demo/interactive.py``; reference: aurora/foundry/demo/interactive.py,
an ipyleaflet map with MSL/2t image overlays and a Velocity wind layer), around the port's
:class:`Batch`:

* overlays are configurable ``(var, cmap, vmin, vmax)`` tuples instead of a fixed
  pair, and any surface variable can be shown;
* the wind layer reads the batch arrays directly (no netCDF round-trip);
* cartopy is optional — without it the overlay is rendered without coastlines.

``matplotlib``, ``cartopy``, ``ipyleaflet``, ``ipywidgets`` and ``xarray`` are imported
inside the functions (the first two by :func:`field_data_url`, the rest by
:func:`interactive_plot`, with a clear error for the notebook extras), so importing this
module needs none of them.
"""

from __future__ import annotations

import base64
import io

import numpy as np

from aurora_tpu_torch.batch import Batch

__all__ = ["field_data_url", "interactive_plot", "DEFAULT_OVERLAYS"]

#: (variable, colormap, vmin, vmax) — the reference's two overlays as defaults.
DEFAULT_OVERLAYS = (
    ("msl", "viridis", 100 * (1000 - 20), 100 * (1000 + 20)),
    ("2t", "RdBu_r", 273.15 - 50, 273.15 + 50),
)


def field_data_url(
    field: np.ndarray, lon: np.ndarray, cmap: str, vmin: float, vmax: float, dpi: int = 300
) -> str:
    """Render a global ``(H, W)`` field to a ``data:image/png`` URL.

    The longitude axis is recentred from [0, 360) to [-180, 180) so the image
    aligns with the EPSG4326 leaflet projection.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    field = np.asarray(field)
    lon = np.asarray(lon)
    west = lon > 180
    field = np.concatenate((field[:, west], field[:, ~west]), axis=1)

    fig = plt.figure()
    try:
        import cartopy.crs as ccrs

        ax = fig.add_subplot(projection=ccrs.PlateCarree(), frameon=False)
        ax.set_global()
        ax.coastlines(lw=0.1)
        kw = {"transform": ccrs.PlateCarree()}
    except Exception:  # cartopy optional: plain image, no coastlines
        ax = fig.add_subplot(frameon=False)
        ax.set_axis_off()
        kw = {}
    ax.imshow(
        field, extent=(-180, 180, -90, 90), aspect=1, cmap=cmap, vmin=vmin, vmax=vmax, **kw
    )
    buf = io.BytesIO()
    fig.savefig(buf, format="png", bbox_inches="tight", pad_inches=0, dpi=dpi)
    plt.close(fig)
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode("utf-8")


def interactive_plot(
    prediction: Batch,
    overlays=DEFAULT_OVERLAYS,
    wind: bool = True,
    width: str = "1000px",
    height: str = "500px",
):
    """Build an ipyleaflet map of a prediction (surface overlays + wind animation).

    Returns the ``Map`` widget; display it as the last expression of a notebook
    cell. Requires the notebook extras ``ipyleaflet`` and ``ipywidgets``.
    """
    try:
        from ipyleaflet import ImageOverlay, LayersControl, Map, projections
        from ipyleaflet.velocity import Velocity
        from ipywidgets import Layout
    except ImportError as e:  # pragma: no cover - notebook extra
        raise ImportError(
            "interactive_plot needs the notebook extras: pip install ipyleaflet ipywidgets"
        ) from e
    import xarray as xr

    b = prediction.to_numpy()
    lat = np.asarray(b.metadata.lat, np.float64)
    lon = np.asarray(b.metadata.lon, np.float64)
    when = b.metadata.time[0]
    print(f"Prediction for {when:%Y-%m-%d %H:%M}")

    m = Map(
        layers=[],
        center=(20, 10),
        zoom=2,
        interpolation="nearest",
        crs=projections.EPSG4326,
        layout=Layout(width=width, height=height),
    )

    if wind and "10u" in b.surf_vars and "10v" in b.surf_vars:
        # leaflet-velocity wants an xarray dataset with 1D lat/lon coords.
        ds = xr.Dataset(
            {
                "u10": (("latitude", "longitude"), np.asarray(b.surf_vars["10u"])[0, -1]),
                "v10": (("latitude", "longitude"), np.asarray(b.surf_vars["10v"])[0, -1]),
            },
            coords={"latitude": lat, "longitude": lon},
        )
        m.add(
            Velocity(
                data=ds,
                name="Wind",
                zonal_speed="u10",
                meridional_speed="v10",
                latitude_dimension="latitude",
                longitude_dimension="longitude",
                velocity_scale=0.01,
                max_velocity=20,
                display_options={
                    "velocityType": "Global wind",
                    "displayPosition": "bottomleft",
                    "displayEmptyString": "No wind data",
                },
            )
        )

    for var, cmap, vmin, vmax in overlays:
        if var not in b.surf_vars:
            continue
        m.add_layer(
            ImageOverlay(
                name=var,
                url=field_data_url(np.asarray(b.surf_vars[var])[0, -1], lon, cmap, vmin, vmax),
                bounds=((-90, -180), (90, 180)),
            )
        )

    m.add_control(LayersControl())
    return m
