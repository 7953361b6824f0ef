"""aurora_tpu_torch: the PyTorch/CUDA port of ``aurora_tpu`` for one NVIDIA H100.

It imports torch, numpy and the standard library, never JAX nor the JAX package. The hot
path runs on hand-written Hopper kernels (``csrc/``, built by ``nvcc`` at first use); on
CPU tensors every kernel wrapper takes its plain PyTorch version instead.
"""

from aurora_tpu_torch.batch import Batch, Metadata
from aurora_tpu_torch.model.aurora import (
    Aurora,
    AuroraPretrained,
    cast_backbone_params,
)
from aurora_tpu_torch.model.config import LARGE_CONFIG, SMALL_CONFIG, AuroraConfig
from aurora_tpu_torch.rollout import rollout

__all__ = [
    "Aurora",
    "AuroraConfig",
    "AuroraPretrained",
    "Batch",
    "LARGE_CONFIG",
    "Metadata",
    "SMALL_CONFIG",
    "cast_backbone_params",
    "rollout",
]
