"""The Fourier encodings of the Aurora model, worked out on the host in float64 and rounded
to float32 (Bodnar et al., Nature 2025, supplementary B; ``aurora/model/fourier.py`` and
``aurora/model/posencoding.py`` of microsoft/aurora).

* position: the patch-mean latitude (first half of the channels) and longitude (second half),
  each over ``D / 4`` log-spaced wavelengths in [0.01, 720] degrees, sine then cosine;
* scale: the square root of each patch's area on the sphere (km), over wavelengths from the
  root of a 0.01 degree polar patch's area to the root of the Earth's area;
* lead time in hours over [1/60, 504]; pressure level in hPa over [0.01, 1e5]; absolute time
  in hours since the Unix epoch over [1, 8766].

Latitudes and longitudes are rounded to float32 first, as the released model reads them;
the pooling and the areas are then taken in float64.
"""

from __future__ import annotations

import math

import numpy as np

RADIUS_EARTH_KM = 6378137 / 1000
POS_RANGE = (0.01, 720.0)
LEAD_RANGE = (1 / 60, 24 * 7 * 3)
LEVEL_RANGE = (0.01, 1e5)
TIME_RANGE = (1.0, 24 * 365.25)


def expand(x, d: int, lower: float, upper: float) -> np.ndarray:
    """``x (..., n) -> (..., n, d)``: sines then cosines of ``2 pi x / wavelength`` over
    ``d / 2`` log-spaced wavelengths in ``[lower, upper]``, in float64, returned float32."""
    x = np.asarray(x, dtype=np.float64)
    wavelengths = np.logspace(math.log10(lower), math.log10(upper), d // 2, base=10,
                              dtype=np.float64)
    prod = x[..., None] * (2 * np.pi / wavelengths)
    return np.concatenate((np.sin(prod), np.cos(prod)), axis=-1).astype(np.float32)


def _polygon_area(lat_lon: np.ndarray) -> float:
    """Area (km^2) of a polygon of (lat, lon) vertices in degrees: the line integral of the
    spherical excess, the loop closed by repeating the last vertex."""
    p = np.concatenate((lat_lon, lat_lon[-1:]), axis=0)
    lon, lat = np.deg2rad(p[:, 1]), np.deg2rad(p[:, 0])
    total = np.sum((np.roll(lon, -2) - lon) * np.sin(np.roll(lat, -1)))
    return float(abs(total * RADIUS_EARTH_KM**2 / 2))


def scale_range() -> tuple[float, float]:
    delta = 0.01
    smallest = _polygon_area(np.array([[90.0, 0.0], [90.0, delta], [90.0 - delta, delta],
                                       [90.0 - delta, 0.0]]))
    return smallest, 4 * np.pi * RADIUS_EARTH_KM**2


def _pool(x: np.ndarray, p: int, op) -> np.ndarray:
    H, W = x.shape
    return op(x.reshape(H // p, p, W // p, p), axis=(1, 3))


def pos_scale(d: int, lat, lon, patch: int) -> tuple[np.ndarray, np.ndarray]:
    """Position and scale encodings ``(L, d)`` of the patches of a regular grid."""
    lat = np.asarray(lat, dtype=np.float32).astype(np.float64)
    lon = np.asarray(lon, dtype=np.float32).astype(np.float64)
    glat, glon = np.meshgrid(lat, lon, indexing="ij")
    lat_mean, lon_mean = _pool(glat, patch, np.mean), _pool(glon, patch, np.mean)
    lat_lo, lat_hi = _pool(glat, patch, np.min), _pool(glat, patch, np.max)
    lon_lo, lon_hi = _pool(glon, patch, np.min), _pool(glon, patch, np.max)
    area = (6371**2 * np.pi * (np.sin(np.deg2rad(lat_hi)) - np.sin(np.deg2rad(lat_lo)))
            * (np.deg2rad(lon_hi) - np.deg2rad(lon_lo)))
    pos = np.concatenate((expand(lat_mean.reshape(-1), d // 2, *POS_RANGE),
                          expand(lon_mean.reshape(-1), d // 2, *POS_RANGE)), axis=-1)
    return pos, expand(np.sqrt(area).reshape(-1), d, *scale_range())


def lead_time(hours: float, d: int) -> np.ndarray:
    return expand(np.array(hours, np.float64), d, *LEAD_RANGE)


def levels(atmos_levels, d: int) -> np.ndarray:
    return expand(np.asarray(atmos_levels, dtype=np.float64), d, *LEVEL_RANGE)


def absolute_time(times, d: int) -> np.ndarray:
    """``(B, d)`` of the batch's times (``datetime``), hours since the epoch."""
    hours = np.array([t.timestamp() / 3600 for t in times], dtype=np.float64)
    return expand(hours, d, *TIME_RANGE)
