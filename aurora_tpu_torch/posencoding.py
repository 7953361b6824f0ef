"""Position and scale encodings for the patch grid.

Host-side NumPy float64 (see the design note in :mod:`aurora_tpu_torch.fourier`). The encodings
depend only on (lat, lon, patch size, embed dim), so they are computed once per grid and
cached; the model consumes the cached float32 arrays. A copy of ``aurora_tpu/posencoding.py``.

Reference behaviour: aurora/model/posencoding.py (patch mean/extreme pooling and the
sphere-cap area formula at lines 17-58, 61-113).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from aurora_tpu_torch.fourier import FourierExpansion, pos_expansion, scale_expansion

__all__ = ["pos_scale_enc", "pos_scale_enc_cached", "patch_root_area", "lat_lon_meshgrid"]


def _pool2d(x: np.ndarray, patch: tuple[int, int], op) -> np.ndarray:
    """Non-overlapping 2D pooling of trailing two dims with reduction ``op``."""
    *lead, H, W = x.shape
    ph, pw = patch
    assert H % ph == 0 and W % pw == 0, f"({H},{W}) not divisible by patch ({ph},{pw})"
    x = x.reshape(*lead, H // ph, ph, W // pw, pw)
    return op(x, axis=(-3, -1))


def patch_root_area(
    lat_min: np.ndarray, lon_min: np.ndarray, lat_max: np.ndarray, lon_max: np.ndarray
) -> np.ndarray:
    """Square root of the area (km) of rectangular lat-lon patches on the sphere.

    Uses ``area = R^2 * (sin(lat1) - sin(lat2)) * (lon1 - lon2)`` for a spherical
    rectangle (reference: aurora/model/posencoding.py:36-58).
    """
    assert (lat_max > lat_min).all() and (lon_max > lon_min).all()
    assert (np.abs(lat_max) <= 90.0).all() and (np.abs(lat_min) <= 90.0).all()
    assert (lon_max <= 360.0).all() and (lon_min >= 0.0).all()
    patch_area = (
        6371**2
        * np.pi
        * (np.sin(np.deg2rad(lat_max)) - np.sin(np.deg2rad(lat_min)))
        * (np.deg2rad(lon_max) - np.deg2rad(lon_min))
    )
    assert (patch_area > 0.0).all()
    return np.sqrt(patch_area)


def lat_lon_meshgrid(lat: np.ndarray, lon: np.ndarray) -> np.ndarray:
    """Stack vector lat/lon into a ``(2, H, W)`` coordinate grid."""
    assert lat.ndim == 1 and lon.ndim == 1
    glat, glon = np.meshgrid(lat, lon, indexing="ij")
    return np.stack((glat, glon), axis=0)


def pos_scale_enc(
    encode_dim: int,
    lat: np.ndarray,
    lon: np.ndarray,
    patch_dims: int | tuple[int, int],
    pos_exp: FourierExpansion = pos_expansion,
    scale_exp: FourierExpansion = scale_expansion,
) -> tuple[np.ndarray, np.ndarray]:
    """Positional + scale encoding of the patch grid, each of shape ``(L, D)`` float32.

    ``lat``/``lon`` may be vectors (regular grid) or matrices (curvilinear grid). The
    positional encoding uses the patch-mean latitude for the first half of channels and
    the patch-mean longitude for the second half; the scale encoding expands the square
    root of each patch's spherical area.
    """
    assert encode_dim % 4 == 0
    if isinstance(patch_dims, int):
        patch_dims = (patch_dims, patch_dims)

    # The reference rounds lat/lon to float32 before pooling (aurora/model/encoder.py:283)
    # and then pools and computes patch areas *in float32* (posencoding.py:92-101). That
    # float32 arithmetic is numerically chaotic downstream: the scale expansion's smallest
    # wavelength is ~1.1e-4 while root areas are O(1e3), so a 1-ULP float32 difference in
    # the area flips the high-frequency sin/cos channels completely — the reference itself
    # produces different scale encodings on CPU vs CUDA for this reason. We keep the
    # reference's float32 *input* rounding (those are the values the expansion sees) but do
    # the pooling and area arithmetic in float64, which is the exact value any float32
    # implementation is a rounding of.
    lat = np.asarray(lat, dtype=np.float32).astype(np.float64)
    lon = np.asarray(lon, dtype=np.float32).astype(np.float64)
    if lat.ndim == 1 and lon.ndim == 1:
        grid = lat_lon_meshgrid(lat, lon)
    elif lat.ndim == 2 and lon.ndim == 2:
        grid = np.stack((lat, lon), axis=0)
    else:
        raise ValueError(
            "Latitudes and longitudes must either both be vectors or both be matrices."
        )

    grid_lat_mean = _pool2d(grid[0], patch_dims, np.mean)
    grid_lon_mean = _pool2d(grid[1], patch_dims, np.mean)
    grid_lat_max = _pool2d(grid[0], patch_dims, np.max)
    grid_lat_min = _pool2d(grid[0], patch_dims, np.min)
    grid_lon_max = _pool2d(grid[1], patch_dims, np.max)
    grid_lon_min = _pool2d(grid[1], patch_dims, np.min)
    root_area = patch_root_area(grid_lat_min, grid_lon_min, grid_lat_max, grid_lon_max)

    encode_h = pos_exp(grid_lat_mean.reshape(-1), encode_dim // 2)  # (L, D/2)
    encode_w = pos_exp(grid_lon_mean.reshape(-1), encode_dim // 2)  # (L, D/2)
    pos_encode = np.concatenate((encode_h, encode_w), axis=-1)  # (L, D)
    scale_encode = scale_exp(root_area.reshape(-1), encode_dim)  # (L, D)
    return pos_encode, scale_encode


@lru_cache(maxsize=32)
def _pos_scale_enc_hashed(
    encode_dim: int, lat_bytes: bytes, lon_bytes: bytes, lat_shape, lon_shape, patch: int
):
    lat = np.frombuffer(lat_bytes, dtype=np.float64).reshape(lat_shape)
    lon = np.frombuffer(lon_bytes, dtype=np.float64).reshape(lon_shape)
    return pos_scale_enc(encode_dim, lat, lon, patch)


def pos_scale_enc_cached(encode_dim: int, lat, lon, patch: int):
    """Cached variant keyed on the grid contents — one evaluation per distinct grid."""
    lat = np.asarray(lat, dtype=np.float64)
    lon = np.asarray(lon, dtype=np.float64)
    return _pos_scale_enc_hashed(
        encode_dim, lat.tobytes(), lon.tobytes(), lat.shape, lon.shape, patch
    )
