"""Forecast-verification metrics: latitude-weighted RMSE, MAE, bias and ACC (port of
``aurora_tpu/metrics.py``).

WeatherBench 2 conventions (Rasp et al. 2023): grid cells are weighted by ``cos(lat)``
normalised to mean 1; the metrics reduce over the trailing ``(H, W)`` axes and keep every
leading (batch, time, level) axis; RMSE takes the square root after the spatial mean; ACC
correlates the anomalies from a climatology the caller gives. They compute on torch tensors,
on the prediction's device (a host array is taken as a CPU tensor), in the prediction's
dtype widened to at least float32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from aurora_tpu_torch.batch import Batch, _host

__all__ = ["latitude_weights", "rmse", "mae", "bias", "acc", "evaluate"]


def latitude_weights(lat, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Normalised ``cos(lat)`` area weights of a latitude vector ``(H,)`` or matrix ``(H, W)``
    in degrees: mean exactly 1, shaped ``(H, 1)`` (broadcast over longitude) or ``(H, W)``;
    the poles weigh 0."""
    lat = torch.as_tensor(_host(lat)).to(device=device, dtype=dtype)
    if lat.ndim not in (1, 2):
        raise ValueError(f"lat must be 1D or 2D, got shape {tuple(lat.shape)}")
    w = torch.cos(torch.deg2rad(lat)).clamp(min=0.0)  # cos rounds below 0 at a pole in f32
    w = w / w.mean()
    return w[:, None] if w.ndim == 1 else w


def _tensor(a, device=None) -> torch.Tensor:
    return a.to(device) if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a),
                                                                              device=device)


def _weights(pred: torch.Tensor, lat) -> torch.Tensor:
    return latitude_weights(lat, torch.promote_types(pred.dtype, torch.float32), pred.device)


def _weighted_spatial_mean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.ndim < 2:
        raise ValueError(f"expected trailing (H, W) dims, got shape {tuple(x.shape)}")
    return (x * w).mean(dim=(-2, -1))


def _pair(pred, target):
    pred = _tensor(pred)
    return pred, _tensor(target, pred.device)


def rmse(pred, target, lat) -> torch.Tensor:
    """Latitude-weighted root-mean-square error over the trailing ``(H, W)`` axes."""
    pred, target = _pair(pred, target)
    w = _weights(pred, lat)
    err = (pred - target).to(w.dtype)
    return torch.sqrt(_weighted_spatial_mean(err * err, w))


def mae(pred, target, lat) -> torch.Tensor:
    """Latitude-weighted mean absolute error over the trailing ``(H, W)`` axes."""
    pred, target = _pair(pred, target)
    w = _weights(pred, lat)
    return _weighted_spatial_mean((pred - target).to(w.dtype).abs(), w)


def bias(pred, target, lat) -> torch.Tensor:
    """Latitude-weighted mean error (pred - target) over the trailing ``(H, W)`` axes."""
    pred, target = _pair(pred, target)
    w = _weights(pred, lat)
    return _weighted_spatial_mean((pred - target).to(w.dtype), w)


def acc(pred, target, climatology, lat) -> torch.Tensor:
    """Anomaly correlation coefficient with respect to ``climatology`` (broadcast against the
    prediction): ``sum w p' t' / sqrt(sum w p'^2 * sum w t'^2)`` over ``(H, W)``."""
    pred, target = _pair(pred, target)
    clim = _tensor(climatology, pred.device)
    w = _weights(pred, lat)
    pa = (pred - clim).to(w.dtype)
    ta = (target - clim).to(w.dtype)
    num = _weighted_spatial_mean(pa * ta, w)
    den = _weighted_spatial_mean(pa * pa, w) * _weighted_spatial_mean(ta * ta, w)
    return num / torch.sqrt(den)


def _metrics_for(pred, target, lat, clim) -> dict[str, torch.Tensor]:
    out = {"rmse": rmse(pred, target, lat), "mae": mae(pred, target, lat),
           "bias": bias(pred, target, lat)}
    if clim is not None:
        out["acc"] = acc(pred, target, clim, lat)
    return out


def evaluate(pred: Batch, target: Batch,
             climatology: Optional[Batch] = None) -> dict[str, dict[str, dict[str, torch.Tensor]]]:
    """Score a prediction :class:`Batch` against a target on the same grid:
    ``{"surf_vars": {name: {metric: tensor}}, "atmos_vars": {...}}``, each tensor with the
    prediction's leading axes (``(B, T)`` for a surface variable, ``(B, T, C)`` for an
    atmospheric one). ``climatology`` adds ``acc``. Raises where a batch is on another grid
    (``lat``/``lon`` differ) or lacks one of the prediction's variables."""
    lat = pred.metadata.lat
    others = [(target, "target")] + ([(climatology, "climatology")] if climatology is not None
                                     else [])
    for other, label in others:
        for coord in ("lat", "lon"):
            a = _host(getattr(pred.metadata, coord))
            b = _host(getattr(other.metadata, coord))
            if a.shape != b.shape or not np.allclose(a, b):
                raise ValueError(
                    f"{label} batch is on a different grid: metadata.{coord} differs from pred's"
                )
    out: dict[str, dict[str, dict[str, torch.Tensor]]] = {"surf_vars": {}, "atmos_vars": {}}
    for group in ("surf_vars", "atmos_vars"):
        targets = getattr(target, group)
        clims = getattr(climatology, group) if climatology is not None else {}
        for name, field in getattr(pred, group).items():
            if name not in targets:
                raise KeyError(f"target batch is missing {group}[{name!r}]")
            t = targets[name]
            if tuple(t.shape) != tuple(field.shape):
                raise ValueError(f"shape mismatch for {group}[{name!r}]: "
                                 f"pred {tuple(field.shape)} vs target {tuple(t.shape)}")
            clim = clims.get(name) if climatology is not None else None
            if climatology is not None and clim is None:
                raise KeyError(f"climatology batch is missing {group}[{name!r}]")
            out[group][name] = _metrics_for(field, t, lat, clim)
    return out
