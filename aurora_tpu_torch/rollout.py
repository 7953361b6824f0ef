"""Autoregressive roll-outs (port of ``aurora_tpu/rollout.py``; reference:
aurora/rollout.py:14-49): every prediction is appended to the history, which drops its
oldest step, and fed back.

* :func:`rollout` yields each prediction as it is made, one ``Aurora.forward`` per step.
* :func:`rollout_scan` runs the whole roll-out and returns the predictions, kept on the
  model's device or, with ``host_offload=True``, shipped to page-locked host memory while
  the next step computes.

The caller's history is uploaded once, before the first step, and the caller's arrays are
never written.
"""

from __future__ import annotations

import dataclasses
from typing import Generator, Iterable, Optional

import torch

from aurora_tpu_torch.batch import Batch
from aurora_tpu_torch.model.aurora import Aurora

__all__ = ["rollout", "rollout_scan", "ship_to_host"]


def rollout(model: Aurora, batch: Batch, steps: int) -> Generator[Batch, None, None]:
    """Roll the model out for ``steps`` steps, yielding the prediction after each step."""
    # The batch in its model form before the history is concatenated.
    batch = model.batch_transform_hook(batch)
    batch = batch.crop(model.cfg.patch_size)
    # Each prediction carries the caller's (cropped) static fields, as ``forward`` returns
    # them. The model reads the device copies, uploaded once here in its dtype, as
    # ``forward`` would upload them: its own ``Batch.to`` is then a no-op.
    static = batch.static_vars
    batch = batch.to(model.device, model.compute_dtype)
    for _ in range(steps):
        pred = model(batch)
        yield dataclasses.replace(pred, static_vars=dict(static))
        batch = dataclasses.replace(
            pred,
            static_vars=batch.static_vars,
            surf_vars={
                k: torch.cat([batch.surf_vars[k][:, 1:], v], dim=1)
                for k, v in pred.surf_vars.items()
            },
            atmos_vars={
                k: torch.cat([batch.atmos_vars[k][:, 1:], v], dim=1)
                for k, v in pred.atmos_vars.items()
            },
        )


def rollout_scan(model: Aurora, batch: Batch, steps: int,
                 host_offload: bool = False) -> list[Batch]:
    """Roll the model out for ``steps`` steps and return the predictions
    (``aurora_tpu/rollout.py:46-214``), :func:`rollout`'s step for step.

    ``host_offload=False`` keeps every prediction on the model's device.
    ``host_offload=True`` ships each one to the host as :func:`ship_to_host` does and
    returns NumPy arrays: the device then holds one step's working set and the prediction
    in flight, for any number of steps."""
    preds = rollout(model, batch, steps)
    return ship_to_host(preds, steps, model.device) if host_offload else list(preds)


def ship_to_host(preds: Iterable[Batch], steps: int, device: torch.device) -> list[Batch]:
    """Copy each of ``steps`` predictions, as ``preds`` makes them, into host memory and
    return them as NumPy arrays with their metadata and static fields.

    On the card the host buffers are page-locked and allocated once, at the first
    prediction; each copy runs on a side stream behind an event recorded after the
    prediction was computed, so it overlaps the next step. A prediction's device tensors
    are dropped once its copy has completed, which is waited for when the next prediction
    is shipped. On the CPU the copies are plain."""
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    host: Optional[tuple[dict, dict]] = None
    shipped, in_flight = [], None  # in_flight: (event, prediction) of the copy last queued
    for i, pred in enumerate(preds):
        groups = (pred.surf_vars, pred.atmos_vars)
        if host is None:
            host = tuple({k: torch.empty((steps, *v.shape), dtype=v.dtype,
                                         pin_memory=stream is not None)
                          for k, v in group.items()} for group in groups)
        if stream is None:
            for buf, group in zip(host, groups):
                for k, v in group.items():
                    buf[k][i].copy_(v)
        else:
            ready = torch.cuda.Event()
            ready.record()
            stream.wait_event(ready)
            with torch.cuda.stream(stream):
                for buf, group in zip(host, groups):
                    for k, v in group.items():
                        buf[k][i].copy_(v, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
            if in_flight is not None:
                in_flight[0].synchronize()
            in_flight = (done, pred)
        shipped.append(dataclasses.replace(pred, surf_vars={}, atmos_vars={}))
        del pred, groups
    if in_flight is not None:
        in_flight[0].synchronize()
    return [dataclasses.replace(p, surf_vars={k: v[i].numpy() for k, v in host[0].items()},
                                atmos_vars={k: v[i].numpy() for k, v in host[1].items()})
            for i, p in enumerate(shipped)]
