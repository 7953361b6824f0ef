"""Spherical geometry: areas of lat-lon polygons and grid patches.

Host-side NumPy in float64 — these quantities feed the Fourier scale encodings, which the
reference computes in double precision (reference: aurora/area.py, aurora/model/fourier.py:79).
They are evaluated once per grid on the host and cached, never on the device. A copy of
``aurora_tpu/area.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["area", "compute_patch_areas", "radius_earth"]

radius_earth: float = 6378137 / 1000
"""Radius of the earth in kilometres."""


def area(polygon: np.ndarray) -> np.ndarray:
    """Area (km^2) of polygons given as ``(..., n, 2)`` arrays of (lat, lon) in degrees.

    Uses the spherical excess line-integral formula (same algorithm family as the PyPI
    ``area`` package; reference behaviour: aurora/area.py:12-50). Vectorised over the
    point axis rather than looping.
    """
    polygon = np.asarray(polygon, dtype=np.float64)
    # Close the loop by repeating the last vertex (matches reference closure semantics).
    polygon = np.concatenate((polygon, polygon[..., -1:, :]), axis=-2)
    n = polygon.shape[-2]
    if n <= 2:
        return np.zeros(polygon.shape[:-2], dtype=np.float64)

    lon = np.deg2rad(polygon[..., 1])
    lat = np.deg2rad(polygon[..., 0])
    # Sum over i of (lon[i+2] - lon[i]) * sin(lat[i+1]), indices mod n.
    lon_lower = lon
    lat_middle = np.roll(lat, -1, axis=-1)
    lon_upper = np.roll(lon, -2, axis=-1)
    total = np.sum((lon_upper - lon_lower) * np.sin(lat_middle), axis=-1)
    return np.abs(total * radius_earth * radius_earth / 2)


def _expand_matrix(matrix: np.ndarray) -> np.ndarray:
    """Pad a matrix by one linearly-extrapolated row/column on every side."""
    matrix = np.concatenate(
        (2 * matrix[0:1] - matrix[1:2], matrix, 2 * matrix[-1:] - matrix[-2:-1]), axis=0
    )
    matrix = np.concatenate(
        (2 * matrix[:, 0:1] - matrix[:, 1:2], matrix, 2 * matrix[:, -1:] - matrix[:, -2:-1]),
        axis=1,
    )
    return matrix


def compute_patch_areas(lat: np.ndarray, lon: np.ndarray) -> np.ndarray:
    """Area (km^2) of the grid cell centred on every (lat, lon) grid point.

    Cell vertices are midpoints between neighbouring grid points; the grid is extended by
    linear extrapolation at the boundary (reference behaviour: aurora/area.py:86-144).
    """
    lat = np.asarray(lat, dtype=np.float64)
    lon = np.asarray(lon, dtype=np.float64)
    if lat.ndim != 2 or lon.ndim != 2:
        raise ValueError("`lat` and `lon` must both be matrices.")
    if lat.shape != lon.shape:
        raise ValueError("`lat` and `lon` must have the same shape.")
    if not np.all(lat[1:] - lat[:-1] <= 0):
        raise ValueError("`lat` must be decreasing along rows.")
    if not np.all(lon[:, 1:] - lon[:, :-1] >= 0):
        raise ValueError("`lon` must be increasing along columns.")

    lat = np.clip(_expand_matrix(lat), -90, 90)
    lon = _expand_matrix(lon)

    lat_mid = (lat[:-1, :-1] + lat[:-1, 1:] + lat[1:, :-1] + lat[1:, 1:]) / 4
    lon_mid = (lon[:-1, :-1] + lon[:-1, 1:] + lon[1:, :-1] + lon[1:, 1:]) / 4

    top_left = np.stack((lat_mid[1:, :-1], lon_mid[1:, :-1]), axis=-1)
    top_right = np.stack((lat_mid[1:, 1:], lon_mid[1:, 1:]), axis=-1)
    bottom_left = np.stack((lat_mid[:-1, :-1], lon_mid[:-1, :-1]), axis=-1)
    bottom_right = np.stack((lat_mid[:-1, 1:], lon_mid[:-1, 1:]), axis=-1)
    polygon = np.stack((top_left, top_right, bottom_right, bottom_left), axis=-2)
    return area(polygon)
