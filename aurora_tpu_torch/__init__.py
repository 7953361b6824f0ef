"""aurora_tpu_torch: the PyTorch/CUDA port of ``aurora_tpu`` for one NVIDIA H100.

It imports torch, numpy and the standard library, never JAX nor the JAX package. The hot
path runs on hand-written Hopper kernels (``csrc/``, built by ``nvcc`` at first use); on
CPU tensors every kernel wrapper takes its plain PyTorch version instead.
"""

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
    "cast_backbone_params",
    "rollout",
    "rollout_scan",
]
