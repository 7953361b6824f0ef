"""The system under test: the port's model built from a configuration file, with the seed's
weights (:mod:`benchmark.weights`). The only module of the harness, with the drivers, that
imports ``aurora_tpu_torch``."""

from __future__ import annotations

import dataclasses

import torch

from aurora_tpu_torch.model.aurora import Aurora, cast_backbone_params
from aurora_tpu_torch.model.config import AuroraConfig, BackboneConfig

from benchmark import weights


def port_config(cfg: dict, **knobs) -> AuroraConfig:
    """The port's configuration of the file ``cfg``: every key that names a field of
    :class:`AuroraConfig`, lists as tuples. The LoRA rank and scale are the backbone's own
    fields, which the file must match."""
    backbone = BackboneConfig()
    for key in ("lora_r", "lora_alpha"):
        if cfg[key] != getattr(backbone, key):
            raise ValueError(f"{key} {cfg[key]}: the port builds {getattr(backbone, key)}")
    fields = {f.name for f in dataclasses.fields(AuroraConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items() if k in fields}
    return AuroraConfig(**kw).replace(**knobs)


def build(cfg: dict, device, seed: int, dtype=torch.float32, **knobs) -> Aurora:
    """The model of ``cfg`` on ``device`` with the seed's weights; under ``autocast`` the
    backbone stored in bf16 (the production form)."""
    pc = port_config(cfg, **knobs)
    model = Aurora(pc, device=device, dtype=dtype, seed=None)
    weights.fill(model.named_parameters(), seed, device)
    if pc.autocast:
        cast_backbone_params(model)
    return model


def shapes(model: torch.nn.Module) -> dict[str, tuple[int, ...]]:
    return {n: tuple(p.shape) for n, p in model.named_parameters()}
