"""Autoregressive roll-out (port of ``aurora_tpu/rollout.py::rollout``; reference:
aurora/rollout.py:14-49): every prediction is appended to the history, which drops its
oldest step, and fed back."""

from __future__ import annotations

import dataclasses
from typing import Generator

import torch

from aurora_tpu_torch.batch import Batch
from aurora_tpu_torch.model.aurora import Aurora

__all__ = ["rollout"]


def rollout(model: Aurora, batch: Batch, steps: int) -> Generator[Batch, None, None]:
    """Roll the model out for ``steps`` steps, yielding the prediction after each step."""
    # The batch in its model form before the history is concatenated.
    batch = model.batch_transform_hook(batch)
    batch = batch.crop(model.cfg.patch_size)
    for _ in range(steps):
        pred = model(batch)
        yield pred
        batch = dataclasses.replace(
            pred,
            surf_vars={
                k: torch.cat([_on(batch.surf_vars[k], v)[:, 1:], v], dim=1)
                for k, v in pred.surf_vars.items()
            },
            atmos_vars={
                k: torch.cat([_on(batch.atmos_vars[k], v)[:, 1:], v], dim=1)
                for k, v in pred.atmos_vars.items()
            },
        )


def _on(history, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(history).to(device=like.device, dtype=like.dtype)
