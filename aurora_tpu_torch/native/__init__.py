"""The host data plane's native kernel: bilinear regridding in C++ (``regrid.cpp``, the port's
own copy of ``aurora_tpu/native/regrid.cpp``).

It is built with ``g++ -O3 -fopenmp`` at its first use into ``build/native/`` under the
repository root and loaded with ``ctypes``; nothing is built at import. Where no ``g++`` is
found, or the build fails, :func:`regrid_bilinear` returns None and the caller takes the
scipy form (``aurora_tpu_torch.batch.interpolate_scipy``). :func:`available` says which one
runs.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

__all__ = ["available", "regrid_bilinear", "BUILD_DIR"]

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "regrid.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_LIB: list = []  # [None]: the build failed; [lib]: built and loaded


def _build() -> "ctypes.CDLL | None":
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / "libregrid.so"
        if not lib_path.exists() or lib_path.stat().st_mtime < _SRC.stat().st_mtime:
            # A sibling temporary file, renamed once built: a concurrent reader never sees a
            # half-written library.
            with tempfile.NamedTemporaryFile(dir=BUILD_DIR, suffix=".so", delete=False) as tf:
                tmp = Path(tf.name)
            try:
                subprocess.run(["g++", "-O3", "-fopenmp", "-shared", "-fPIC", str(_SRC), "-o",
                                str(tmp)], check=True, capture_output=True, timeout=120)
                os.replace(tmp, lib_path)
            finally:
                tmp.unlink(missing_ok=True)
        lib = ctypes.CDLL(str(lib_path))
        f64, i64 = ctypes.POINTER(ctypes.c_double), ctypes.c_int64
        lib.regrid_bilinear.argtypes = [f64, i64, i64, i64, f64, f64, f64, i64, f64, i64, f64]
        lib.regrid_bilinear.restype = None
        return lib
    except Exception as e:  # no toolchain, an unwritable build directory, a bad library
        logger.info("native regrid build failed (%s); using the scipy form", e)
        return None


def _lib():
    if not _LIB:
        _LIB.append(_build())
    return _LIB[0]


def available() -> bool:
    """Whether the native library is built and loaded (building it on the first call)."""
    return _lib() is not None


def regrid_bilinear(v: np.ndarray, lat: np.ndarray, lon: np.ndarray, lat_new: np.ndarray,
                    lon_new: np.ndarray) -> "np.ndarray | None":
    """Bilinear regrid of ``(..., H, W)`` float64 fields (periodic longitude, latitude
    extrapolated linearly); None when the native library is not available."""
    lib = _lib()
    if lib is None:
        return None
    batch_shape = v.shape[:-2]
    H, W = v.shape[-2:]
    v2 = np.ascontiguousarray(v.reshape(-1, H, W), dtype=np.float64)
    lat, lon, lat_new, lon_new = (np.ascontiguousarray(a, dtype=np.float64)
                                  for a in (lat, lon, lat_new, lon_new))
    if lat.shape != (H,) or lon.shape != (W,) or H < 2 or W < 1 or lat_new.ndim != 1 \
            or lon_new.ndim != 1:
        raise ValueError(f"fields (..., {H}, {W}) need vectors lat ({H},) and lon ({W},) and "
                         f"vector targets, got {lat.shape}, {lon.shape}, {lat_new.shape}, "
                         f"{lon_new.shape}")
    out = np.empty((v2.shape[0], lat_new.shape[0], lon_new.shape[0]), dtype=np.float64)
    ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
    lib.regrid_bilinear(ptr(v2), v2.shape[0], H, W, ptr(lat), ptr(lon), ptr(lat_new),
                        lat_new.shape[0], ptr(lon_new), lon_new.shape[0], ptr(out))
    return out.reshape(*batch_shape, lat_new.shape[0], lon_new.shape[0])
