"""Tropical-cyclone tracker: a post-processor of predictions (port of ``aurora_tpu/tracker.py``;
reference: aurora/tracker.py:123-282).

Host NumPy/SciPy work, as in the JAX package: extrapolate the recent track, snap to the
nearest smoothed local minimum of mean sea-level pressure over shrinking boxes (with the
700 hPa geopotential as the fallback), and record the least MSL and the strongest wind in a
small box around the fix. :meth:`Tracker.step` takes the four 2D fields it needs out of a
prediction while they are still on the card and copies only those to the host.

pandas is not a dependency of the port: :meth:`Tracker.results` returns the JAX package's
DataFrame columns (``time``, ``lat``, ``lon``, ``msl``, ``wind``) as a dict of lists, and
:meth:`Tracker.write_csv` writes the text of the JAX package's
``results().to_csv(path, index=False)``.
"""

from __future__ import annotations

import csv
import logging
import math
import os
from datetime import datetime

import numpy as np
from scipy.ndimage import gaussian_filter, minimum_filter

from aurora_tpu_torch.batch import Batch, _host

__all__ = ["Tracker", "NoEyeException", "extrapolate_track", "haversine_km", "select_box"]

logger = logging.getLogger(__name__)

_SHRINKING_DELTAS = (5, 4, 3, 2, 1.5)
_EARTH_RADIUS_KM = 6371
COLUMNS = ("time", "lat", "lon", "msl", "wind")


class NoEyeException(Exception):
    """Raised when no storm eye can be found."""


def haversine_km(lat1, lon1, lat2, lon2):
    """Great-circle distance in km between (lat, lon) points in degrees."""
    lat1, lat2 = np.deg2rad(lat1), np.deg2rad(lat2)
    lon1, lon2 = np.deg2rad(lon1), np.deg2rad(lon2)
    inner = 1 - np.cos(lat2 - lat1) + np.cos(lat1) * np.cos(lat2) * (1 - np.cos(lon2 - lon1))
    return 2 * _EARTH_RADIUS_KM * np.arcsin(np.sqrt(0.5 * inner))


def select_box(field, lats, lons, lat_min, lat_max, lon_min, lon_max):
    """Crop ``field`` to a lat/lon box, across the periodic longitude seam where it wraps."""
    lat_mask = (lat_min <= lats) & (lats <= lat_max)
    box = field[..., lat_mask, :]
    box_lats = lats[lat_mask]
    lon_min, lon_max = lon_min % 360, lon_max % 360
    if lon_min <= lon_max:
        lon_mask = (lon_min <= lons) & (lons <= lon_max)
        box = box[..., lon_mask]
        box_lons = lons[lon_mask]
    else:  # the box wraps around the 0/360 seam
        m1, m2 = lon_min <= lons, lons <= lon_max
        box = np.concatenate((box[..., m1], box[..., m2]), axis=-1)
        box_lons = np.concatenate((lons[m1], lons[m2]))
    return box_lats, box_lons, box


def nearest_local_min(field, lats, lons, lat, lon, delta=5.0, min_filter_size=8):
    """The smoothed local minimum of ``field`` nearest to (lat, lon) within a ±``delta``
    box; raises :class:`NoEyeException` when there is none."""
    box_lats, box_lons, box = select_box(
        field, lats, lons, lat - delta, lat + delta, lon - delta, lon + delta
    )
    box = gaussian_filter(box, sigma=1)
    minima = minimum_filter(box, size=(min_filter_size, min_filter_size)) == box
    # Minima on the box's edge are artefacts of the crop.
    minima[0, :] = minima[-1, :] = False
    minima[:, 0] = minima[:, -1] = False
    if not minima.any():
        raise NoEyeException()
    idx = np.argwhere(minima)
    dists = haversine_km(box_lats[idx[:, 0]], box_lons[idx[:, 1]], lat, lon)
    best = idx[np.argmin(dists)]
    return float(box_lats[best[0]]), float(box_lons[best[1]])


def extrapolate_track(lats, lons):
    """Linear extrapolation from the last (up to eight) points of the track."""
    assert len(lats) == len(lons)
    if len(lats) == 0:
        raise ValueError("Cannot extrapolate from empty lists.")
    if len(lats) == 1:
        return lats[0], lons[0]
    recent_lats, recent_lons = lats[-8:], lons[-8:]
    n = len(recent_lats)
    fit = np.polyfit(np.arange(n), np.stack((recent_lats, recent_lons), axis=-1), 1)
    return tuple(np.polyval(fit, n))


def _csv_times(times) -> list[str]:
    """The times as pandas writes a datetime column: the date alone when every time is a
    midnight, microseconds when one has them, else to the second."""
    if all(t.hour == t.minute == t.second == t.microsecond == 0 for t in times):
        fmt = "%Y-%m-%d"
    elif any(t.microsecond for t in times):
        fmt = "%Y-%m-%d %H:%M:%S.%f"
    else:
        fmt = "%Y-%m-%d %H:%M:%S"
    return [t.strftime(fmt) for t in times]


def _csv_float(x) -> str:
    x = float(x)
    return "" if math.isnan(x) else repr(x)


class Tracker:
    """Track a tropical cyclone through a sequence of predictions: construct it with the
    storm's first fix, call :meth:`step` with every prediction in order, then read
    :meth:`results` or :meth:`write_csv`."""

    def __init__(self, init_lat: float, init_lon: float, init_time: datetime) -> None:
        self.tracked_times: list[datetime] = [init_time]
        self.tracked_lats: list[float] = [init_lat]
        self.tracked_lons: list[float] = [init_lon]
        self.tracked_msls: list[float] = [np.nan]
        self.tracked_winds: list[float] = [np.nan]
        self.fails: int = 0

    def results(self) -> dict[str, list]:
        """The track: the columns ``time``, ``lat``, ``lon``, ``msl``, ``wind`` as lists
        (the JAX package returns them as a DataFrame)."""
        return dict(zip(COLUMNS, (list(self.tracked_times), list(self.tracked_lats),
                                  list(self.tracked_lons), list(self.tracked_msls),
                                  list(self.tracked_winds))))

    def write_csv(self, path) -> None:
        """Write the track as CSV, the text ``results().to_csv(path, index=False)`` writes in
        the JAX package (empty fields for NaN)."""
        r = self.results()
        rows = zip(_csv_times(r["time"]), *([_csv_float(x) for x in r[c]] for c in COLUMNS[1:]))
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator=os.linesep)
            w.writerow(COLUMNS)
            w.writerows(rows)

    def step(self, batch: Batch) -> None:
        """Advance the track with the next prediction."""
        if len(batch.metadata.time) != 1:
            raise RuntimeError("Predictions don't have batch size one.")

        # Index where the prediction lies before the copy: the tracker needs four 2D fields,
        # not the whole prediction (~1 GB at 0.25 degrees).
        z700_index = list(batch.metadata.atmos_levels).index(700)
        z700 = _host(batch.atmos_vars["z"][0, 0, z700_index])
        msl = _host(batch.surf_vars["msl"][0, 0])
        u10 = _host(batch.surf_vars["10u"][0, 0])
        v10 = _host(batch.surf_vars["10v"][0, 0])
        wind = np.hypot(u10, v10)
        lsm = _host(batch.static_vars["lsm"])
        lats = _host(batch.metadata.lat)
        lons = _host(batch.metadata.lon)
        time = batch.metadata.time[0]

        lat, lon = extrapolate_track(self.tracked_lats, self.tracked_lons)
        lat = float(np.clip(lat, -90, 90))
        lon = float(lon) % 360

        def over_ocean(lat, lon, delta):
            _, _, lsm_box = select_box(
                lsm, lats, lons, lat - delta, lat + delta, lon - delta, lon + delta
            )
            return lsm_box.max() < 0.5

        def refine_with_msl(lat, lon):
            """Snap to an MSL minimum over shrinking boxes; None when nothing is found."""
            for delta in _SHRINKING_DELTAS:
                try:
                    if over_ocean(lat, lon, delta):
                        return nearest_local_min(msl, lats, lons, lat, lon, delta=delta)
                except NoEyeException:
                    continue
            return None

        snapped = refine_with_msl(lat, lon)
        if snapped is None:
            # MSL failed: the 700 hPa geopotential, then MSL again from there if possible.
            try:
                lat, lon = nearest_local_min(z700, lats, lons, lat, lon, delta=5)
                snapped = refine_with_msl(lat, lon) or (lat, lon)
            except NoEyeException:
                snapped = None

        if snapped is None:
            self.fails += 1
            if len(self.tracked_lats) > 1:
                logger.info(f"Failed at time {time}. Extrapolating in a silly way.")
            else:
                raise NoEyeException("Completely failed at the first step.")
        else:
            lat, lon = snapped

        self.tracked_times.append(time)
        self.tracked_lats.append(lat)
        self.tracked_lons.append(lon)
        _, _, msl_crop = select_box(msl, lats, lons, lat - 1.5, lat + 1.5, lon - 1.5, lon + 1.5)
        _, _, wind_crop = select_box(wind, lats, lons, lat - 1.5, lat + 1.5, lon - 1.5, lon + 1.5)
        self.tracked_msls.append(float(msl_crop.min()))
        self.tracked_winds.append(float(wind_crop.max()))
