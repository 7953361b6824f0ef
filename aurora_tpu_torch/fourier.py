"""Log-spaced Fourier feature expansions.

Design note: the reference evaluates these in float64 inside the model
(reference: aurora/model/fourier.py:79-92). Every Fourier expansion is evaluated
**host-side in NumPy float64** once per (grid, levels, timestep, batch-times) and the
resulting float32 encodings are fed to the device as ordinary inputs. The module is a copy
of ``aurora_tpu/fourier.py``: the port keeps its own so it never imports the JAX package.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "FourierExpansion",
    "pos_expansion",
    "scale_expansion",
    "lead_time_expansion",
    "levels_expansion",
    "absolute_time_expansion",
]


class FourierExpansion:
    """Sin/cos expansion over ``d // 2`` log-spaced wavelengths in ``[lower, upper]``.

    Mirrors the numerics of the reference expansion (aurora/model/fourier.py:45-92):
    float64 computation, half the channels sine and half cosine, result cast to float32.
    """

    def __init__(self, lower: float, upper: float, assert_range: bool = True) -> None:
        self.lower = lower
        self.upper = upper
        self.assert_range = assert_range

    def __call__(self, x: np.ndarray, d: int) -> np.ndarray:
        """Expand ``x`` of shape ``(..., n)`` to shape ``(..., n, d)`` (float32)."""
        x = np.asarray(x, dtype=np.float64)

        if self.assert_range:
            in_range = np.logical_and(self.lower <= np.abs(x), np.abs(x) <= self.upper)
            if not np.all(np.logical_or(in_range, x == 0)):
                raise AssertionError(
                    f"The input tensor is not within the configured range"
                    f" `[{self.lower}, {self.upper}]`."
                )
        if d % 2 != 0:
            raise ValueError("The dimensionality must be a multiple of two.")

        wavelengths = np.logspace(
            math.log10(self.lower), math.log10(self.upper), d // 2, base=10, dtype=np.float64
        )
        prod = x[..., None] * (2 * np.pi / wavelengths)
        encoding = np.concatenate((np.sin(prod), np.cos(prod)), axis=-1)
        return encoding.astype(np.float32)


def _min_patch_area() -> float:
    from aurora_tpu_torch.area import area

    delta = 0.01  # Smallest reasonable delta in latitude/longitude, degrees.
    poly = np.array(
        [[90.0, 0.0], [90.0, delta], [90.0 - delta, delta], [90.0 - delta, 0.0]],
        dtype=np.float64,
    )
    return float(area(poly))


def _area_earth() -> float:
    from aurora_tpu_torch.area import radius_earth

    return 4 * np.pi * radius_earth * radius_earth


pos_expansion = FourierExpansion(0.01, 720)
"""Expansion for latitudes/longitudes in degrees."""

scale_expansion = FourierExpansion(_min_patch_area(), _area_earth())
"""Expansion for patch areas in km^2."""

lead_time_expansion = FourierExpansion(1 / 60, 24 * 7 * 3)
"""Expansion for lead times in hours."""

levels_expansion = FourierExpansion(0.01, 1e5)
"""Expansion for pressure levels in hPa."""

absolute_time_expansion = FourierExpansion(1, 24 * 365.25, assert_range=False)
"""Expansion for absolute times in hours since the Unix epoch."""
