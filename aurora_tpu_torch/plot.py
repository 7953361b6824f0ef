"""Quick-look maps of predictions (port of ``aurora_tpu/plot.py``). matplotlib is imported
when a map is drawn, never with the module: the card's machine does not have it."""

from __future__ import annotations

import numpy as np

from aurora_tpu_torch.batch import Batch, _host

__all__ = ["quicklook"]


def quicklook(batch: Batch, var: str, level: float | None = None, ax=None, **imshow_kw):
    """Plot one surface variable, or one pressure level of an atmospheric one, of the first
    batch element's last time; returns the matplotlib Axes. Needs matplotlib."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(10, 5))
    if var in batch.surf_vars:
        field = _host(batch.surf_vars[var][0, -1])
        title = var
    else:
        idx = list(batch.metadata.atmos_levels).index(level)
        field = _host(batch.atmos_vars[var][0, -1, idx])
        title = f"{var} @ {level} hPa"
    lat = _host(batch.metadata.lat).astype(np.float64)
    lon = _host(batch.metadata.lon).astype(np.float64)
    extent = None
    if lat.ndim == 1:
        extent = [lon.min(), lon.max(), lat.min(), lat.max()]
    im = ax.imshow(field, extent=extent, aspect="auto", **imshow_kw)
    ax.set_title(f"{title} — {batch.metadata.time[0]}")
    ax.set_xlabel("longitude")
    ax.set_ylabel("latitude")
    plt.colorbar(im, ax=ax, shrink=0.8)
    return ax
