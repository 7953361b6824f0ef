"""aurora_tpu_torch: the PyTorch/CUDA port of ``aurora_tpu`` for one NVIDIA H100.

It imports torch, numpy and the standard library, never JAX nor the JAX package. The hot
path runs on hand-written Hopper kernels (``csrc/``, built by ``nvcc`` at first use); on
CPU tensors every kernel wrapper takes its plain PyTorch version instead.

``Tracker`` and ``metrics`` load at first use (a module ``__getattr__``): ``tracker.py``
imports scipy, which ``import aurora_tpu_torch`` does not load.
"""

import importlib

from aurora_tpu_torch.batch import Batch, Metadata
from aurora_tpu_torch.model.aurora import (
    Aurora,
    Aurora12hPretrained,
    AuroraAirPollution,
    AuroraHighRes,
    AuroraPretrained,
    AuroraSmall,
    AuroraSmallPretrained,
    AuroraWave,
    cast_backbone_params,
)
from aurora_tpu_torch.model.config import (
    HIGHRES_CONFIG,
    LARGE_CONFIG,
    SMALL_CONFIG,
    AuroraConfig,
)
from aurora_tpu_torch.rollout import rollout, rollout_scan

__all__ = [
    "Aurora",
    "Aurora12hPretrained",
    "AuroraAirPollution",
    "AuroraConfig",
    "AuroraHighRes",
    "AuroraPretrained",
    "AuroraSmall",
    "AuroraSmallPretrained",
    "AuroraWave",
    "Batch",
    "HIGHRES_CONFIG",
    "LARGE_CONFIG",
    "Metadata",
    "SMALL_CONFIG",
    "Tracker",
    "cast_backbone_params",
    "metrics",
    "rollout",
    "rollout_scan",
]

# Names loaded at first use: {name: (module, attribute or None for the module itself)}.
_LAZY = {"Tracker": ("aurora_tpu_torch.tracker", "Tracker"),
         "metrics": ("aurora_tpu_torch.metrics", None)}


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module, attr = _LAZY[name]
    value = importlib.import_module(module)
    if attr is not None:
        value = getattr(value, attr)
    globals()[name] = value
    return value
