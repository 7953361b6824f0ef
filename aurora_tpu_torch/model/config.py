"""Static model configuration: the fields and presets of ``aurora_tpu/model/config.py``.

The fields are the same, so one dict of keyword arguments builds both packages' configs,
except the JAX package's ``agg_chunk_size`` (a TPU memory knob the port does not need).

The backbone's routing knobs keep the JAX package's values and meanings
(``aurora_tpu/model/swin3d.py:1193-1377``):

* ``attention_impl``: ``"pallas"`` runs window attention on the padded 5D tokens (K2),
  ``"pallas_windowed"`` on partitioned windows (K6), ``"xla"`` as plain PyTorch
  (``sdpa``) with the projections as plain GEMMs;
* ``mlp_impl``: ``"fused"`` runs the attention tail in the attention kernel (or, under
  ``"xla"`` attention, as K5) and the whole MLP branch as K3; ``"pallas"`` the MLP alone as
  K8 with a plain FiLM LayerNorm and residual; ``"xla"`` everything as plain PyTorch.

``"auto"`` resolves to ``"pallas"`` + ``"fused"`` on every device: on CUDA tensors that
route launches the kernels, on CPU tensors it runs their plain versions. Here the port
differs from the JAX package, where ``"auto"`` means plain XLA off a TPU. An explicit
``"xla"`` runs plain PyTorch on the card too, on purpose, as the JAX package's XLA route.
"""

from __future__ import annotations

import dataclasses
from datetime import timedelta
from typing import Literal, Optional

__all__ = [
    "AuroraConfig",
    "BackboneConfig",
    "LoRAMode",
    "SMALL_CONFIG",
    "LARGE_CONFIG",
    "HIGHRES_CONFIG",
]

LoRAMode = Literal["single", "from_second", "all"]
ATTENTION_IMPLS = ("auto", "pallas", "pallas_windowed", "xla")
MLP_IMPLS = ("auto", "fused", "pallas", "xla")


def _check(remat_scope: str, attention_impl: str, mlp_impl: str) -> None:
    if remat_scope not in ("full", "no_outer", "blocks"):
        raise ValueError(
            f"remat_scope must be 'full', 'no_outer' or 'blocks', got {remat_scope!r}."
        )
    if attention_impl not in ATTENTION_IMPLS:
        raise ValueError(
            f"attention_impl must be one of {ATTENTION_IMPLS}, got {attention_impl!r}."
        )
    if mlp_impl not in MLP_IMPLS:
        raise ValueError(f"mlp_impl must be one of {MLP_IMPLS}, got {mlp_impl!r}.")


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    embed_dim: int = 512
    encoder_depths: tuple[int, ...] = (6, 10, 8)
    encoder_num_heads: tuple[int, ...] = (8, 16, 32)
    decoder_depths: tuple[int, ...] = (8, 10, 6)
    decoder_num_heads: tuple[int, ...] = (32, 16, 8)
    window_size: tuple[int, int, int] = (2, 6, 12)
    mlp_ratio: float = 4.0
    use_lora: bool = False
    lora_steps: int = 40
    lora_mode: LoRAMode = "single"
    lora_r: int = 8
    lora_alpha: int = 8
    remat: bool = False
    remat_scope: str = "full"
    drop_path: float = 0.0
    drop_rate: float = 0.0
    attention_impl: str = "auto"
    mlp_impl: str = "auto"

    def __post_init__(self):
        _check(self.remat_scope, self.attention_impl, self.mlp_impl)

    def routes(self) -> tuple[str, str]:
        """``(attention_impl, mlp_impl)`` with ``"auto"`` resolved (module docstring)."""
        a, m = self.attention_impl, self.mlp_impl
        return ("pallas" if a == "auto" else a), ("fused" if m == "auto" else m)


@dataclasses.dataclass(frozen=True)
class AuroraConfig:
    surf_vars: tuple[str, ...] = ("2t", "10u", "10v", "msl")
    static_vars: tuple[str, ...] = ("lsm", "z", "slt")
    atmos_vars: tuple[str, ...] = ("z", "u", "v", "t", "q")
    window_size: tuple[int, int, int] = (2, 6, 12)
    encoder_depths: tuple[int, ...] = (6, 10, 8)
    encoder_num_heads: tuple[int, ...] = (8, 16, 32)
    decoder_depths: tuple[int, ...] = (8, 10, 6)
    decoder_num_heads: tuple[int, ...] = (32, 16, 8)
    latent_levels: int = 4
    patch_size: int = 4
    embed_dim: int = 512
    num_heads: int = 16
    mlp_ratio: float = 4.0
    enc_depth: int = 1
    dec_depth: int = 1
    dec_mlp_ratio: float = 2.0
    perceiver_ln_eps: float = 1e-5
    max_history_size: int = 2
    timestep_hours: float = 6.0
    stabilise_level_agg: bool = False
    use_lora: bool = True
    lora_steps: int = 40
    lora_mode: LoRAMode = "single"
    autocast: bool = False
    level_condition: Optional[tuple[float, ...]] = None
    dynamic_vars: bool = False
    atmos_static_vars: bool = False
    separate_perceiver: tuple[str, ...] = ()
    modulation_heads: tuple[str, ...] = ()
    positive_surf_vars: tuple[str, ...] = ()
    positive_atmos_vars: tuple[str, ...] = ()
    clamp_at_first_step: bool = False
    simulate_indexing_bug: bool = False
    remat: bool = False
    remat_scope: str = "full"
    drop_path: float = 0.0
    drop_rate: float = 0.0
    attention_impl: str = "auto"
    mlp_impl: str = "auto"
    variant: str = "base"
    # Production throughput modes: the VALUE path of the decoder's de-aggregation /
    # the encoder's level aggregation runs in bf16 while q/k/logits stay f32.
    deagg_bf16: bool = False
    agg_bf16: bool = False
    surf_stats: tuple[tuple[str, tuple[float, float]], ...] = ()
    density_channel_surf_vars: tuple[str, ...] = ()
    angle_surf_vars: tuple[str, ...] = ()

    def __post_init__(self):
        _check(self.remat_scope, self.attention_impl, self.mlp_impl)

    @property
    def timestep(self) -> timedelta:
        return timedelta(hours=self.timestep_hours)

    @property
    def dynamic_var_names(self) -> tuple[str, ...]:
        return ("tod_cos", "tod_sin", "dow_cos", "dow_sin", "doy_cos", "doy_sin")

    @property
    def all_static_vars(self) -> tuple[str, ...]:
        """Static variables including the time features of ``dynamic_vars``."""
        if self.dynamic_vars:
            return self.static_vars + self.dynamic_var_names
        return self.static_vars

    @property
    def all_surf_vars(self) -> tuple[str, ...]:
        """Surface variables as seen by the patch embedding (surface + static)."""
        return self.surf_vars + self.all_static_vars

    @property
    def all_atmos_vars(self) -> tuple[str, ...]:
        """Atmospheric variables as seen by the patch embedding."""
        if self.atmos_static_vars:
            return self.atmos_vars + tuple(f"static_{v}" for v in self.all_static_vars)
        return self.atmos_vars

    @property
    def backbone(self) -> BackboneConfig:
        return BackboneConfig(
            embed_dim=self.embed_dim,
            encoder_depths=self.encoder_depths,
            encoder_num_heads=self.encoder_num_heads,
            decoder_depths=self.decoder_depths,
            decoder_num_heads=self.decoder_num_heads,
            window_size=self.window_size,
            mlp_ratio=self.mlp_ratio,
            use_lora=self.use_lora,
            lora_steps=self.lora_steps,
            lora_mode=self.lora_mode,
            remat=self.remat,
            remat_scope=self.remat_scope,
            drop_path=self.drop_path,
            drop_rate=self.drop_rate,
            attention_impl=self.attention_impl,
            mlp_impl=self.mlp_impl,
        )

    @property
    def decoder_embed_dim(self) -> int:
        # The backbone's final concat skip doubles the feature dim.
        return self.embed_dim * 2

    def replace(self, **kwargs) -> "AuroraConfig":
        return dataclasses.replace(self, **kwargs)


SMALL_CONFIG = AuroraConfig(
    encoder_depths=(2, 6, 2),
    encoder_num_heads=(4, 8, 16),
    decoder_depths=(2, 6, 2),
    decoder_num_heads=(16, 8, 4),
    embed_dim=256,
    num_heads=8,
    use_lora=False,
)
"""The small (debugging) configuration."""

LARGE_CONFIG = AuroraConfig(use_lora=False)
"""The 1.3 B-parameter pretrained configuration."""

HIGHRES_CONFIG = AuroraConfig(
    patch_size=10,
    encoder_depths=(6, 8, 8),
    decoder_depths=(8, 8, 6),
)
"""The 0.1° high-resolution configuration."""
