"""Carry weights across: the JAX package's parameter tree (numpy leaves) into the port.

The port's modules are named as the JAX tree's keys and keep its layouts (``(in, out)``
linear weights, ``(T, P, P, D)`` patch kernels, stacked LoRA banks), so the tree path
``backbone/encoder_layers/0/blocks/1/attn/qkv/weight`` is the parameter
``backbone.encoder_layers.0.blocks.1.attn.qkv.weight``. Loading fails on any leaf it does
not consume and on any port parameter left unset.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from aurora_tpu_torch.model.aurora import Aurora
from aurora_tpu_torch.model.config import AuroraConfig

__all__ = ["flatten_tree", "load_numpy_params", "params_from_numpy"]


def flatten_tree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """``{"a": {"b": [x, y]}}`` -> ``{"a.b.0": x, "a.b.1": y}``."""
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}{k}."))
    return out


def _to_tensor(a, like: torch.Tensor) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)  # numpy has no native bf16; widen, then round in torch
    return torch.from_numpy(np.array(a)).to(device=like.device, dtype=like.dtype)


def load_numpy_params(model: torch.nn.Module, tree, *, strict: bool = True) -> torch.nn.Module:
    """Load a JAX-layout parameter tree into ``model`` in place, keeping each port
    parameter's device and dtype. ``strict``: fail on a leaf that names no parameter and on
    a parameter the tree does not set; otherwise load the leaves that name a parameter.
    A shape mismatch always fails."""
    leaves = flatten_tree(tree)
    params = dict(model.named_parameters())
    unconsumed = sorted(set(leaves) - set(params))
    unset = sorted(set(params) - set(leaves))
    if strict and (unconsumed or unset):
        raise ValueError(f"tree/model mismatch: unconsumed leaves {unconsumed}, unset {unset}")
    with torch.no_grad():
        for name, p in params.items():
            if name not in leaves:
                continue
            value = _to_tensor(leaves[name], p)
            if value.shape != p.shape:
                raise ValueError(f"{name}: shape {tuple(value.shape)} != {tuple(p.shape)}")
            p.copy_(value)
    return model


def params_from_numpy(
    tree, cfg: AuroraConfig, *, device=None, dtype: torch.dtype = torch.float32
) -> Aurora:
    """A port model for ``cfg`` on ``device`` holding the weights of a JAX tree."""
    model = Aurora(cfg, device=device, dtype=dtype, seed=None)
    return load_numpy_params(model, tree)
