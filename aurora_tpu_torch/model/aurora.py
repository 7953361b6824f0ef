"""The Aurora model: seeded init, the forward pass and the batch wrapper (port of
``aurora_tpu/model/aurora.py``, base variant).

``forward`` runs normalise -> clamp -> encoder (f32) -> backbone (bf16 under ``autocast``)
-> decoder -> gated clamps -> unnormalise. The Fourier encodings are computed on the host
in float64. The model runs on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from aurora_tpu_torch.batch import Batch, Metadata
from aurora_tpu_torch.fourier import (
    absolute_time_expansion,
    lead_time_expansion,
    levels_expansion,
)
from aurora_tpu_torch.model.config import LARGE_CONFIG, AuroraConfig
from aurora_tpu_torch.model.decoder import Decoder
from aurora_tpu_torch.model.encoder import Encoder, EncoderEncodings
from aurora_tpu_torch.model.swin3d import Backbone
from aurora_tpu_torch.normalisation import (
    normalise_atmos_var,
    normalise_surf_var,
    unnormalise_atmos_var,
    unnormalise_surf_var,
)
from aurora_tpu_torch.posencoding import pos_scale_enc_cached

__all__ = [
    "Aurora",
    "AuroraPretrained",
    "cast_backbone_params",
    "resolve_device",
]


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the card. Raises when no card is present and the caller
    did not ask for the CPU: the port never carries on quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "No CUDA device is available. Pass device='cpu' to run the plain versions "
            "of the kernels on the CPU."
        )
    return torch.device("cuda")


def _check_supported(cfg: AuroraConfig) -> None:
    unported = {
        "variant": cfg.variant != "base",
        "level_condition": bool(cfg.level_condition),
        "dynamic_vars": cfg.dynamic_vars,
        "atmos_static_vars": cfg.atmos_static_vars,
        "separate_perceiver": bool(cfg.separate_perceiver),
        "modulation_heads": bool(cfg.modulation_heads),
        "simulate_indexing_bug": cfg.simulate_indexing_bug,
        "drop_path/drop_rate": cfg.drop_path > 0 or cfg.drop_rate > 0,
        "remat": cfg.remat,
    }
    missing = [k for k, v in unported.items() if v]
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")


def cast_backbone_params(model: "Aurora", dtype: torch.dtype = torch.bfloat16) -> "Aurora":
    """Store the backbone weights in ``dtype`` (in place). Under ``autocast`` the backbone
    computes in bf16 and every kernel casts its weights per use, so bf16 storage gives the
    same compute with half the weight memory."""
    model.backbone.to(dtype)
    return model


class Aurora(nn.Module):
    """The Aurora forecasting model.

    ``Aurora(cfg, device=None, dtype=torch.float32, seed=0, **overrides)``: parameters are
    created on ``device`` (the card when None) and initialised from ``seed`` with a
    ``torch.Generator``. ``model(batch)`` returns the prediction one timestep ahead.
    """

    def __init__(
        self,
        cfg: Optional[AuroraConfig] = None,
        *,
        device=None,
        dtype: torch.dtype = torch.float32,
        seed: Optional[int] = 0,
        **overrides,
    ):
        super().__init__()
        cfg = cfg or self.default_config()
        if overrides:
            cfg = cfg.replace(**overrides)
        _check_supported(cfg)
        self.cfg = cfg
        dev = resolve_device(device)
        if dev.type == "cuda":
            # The encoder, decoder and perceiver q/k run full f32, as the JAX reference.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        kw = dict(device=dev, dtype=dtype)
        self.encoder = Encoder(cfg, **kw)
        self.backbone = Backbone(cfg.backbone, **kw)
        self.decoder = Decoder(cfg, **kw)
        if seed is not None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            self.encoder.reset_parameters(gen)
            self.backbone.reset_parameters(gen)
            self.decoder.reset_parameters(gen)

    @classmethod
    def default_config(cls) -> AuroraConfig:
        return LARGE_CONFIG.replace(use_lora=True)

    @property
    def device(self) -> torch.device:
        return self.encoder.surf_level_encoding.device

    def prepare_encodings(self, batch: Batch, dtype: torch.dtype) -> EncoderEncodings:
        """All Fourier encodings, computed on the host in float64 (rounded to float32)."""
        cfg = self.cfg
        D = cfg.embed_dim
        md = batch.metadata
        lat = np.asarray(md.lat, dtype=np.float64)
        lon = np.asarray(md.lon, dtype=np.float64)
        pos, scale = pos_scale_enc_cached(D, lat, lon, cfg.patch_size)
        levels = np.asarray(md.atmos_levels, dtype=np.float64)
        abs_hours = np.array([t.timestamp() / 3600 for t in md.time], dtype=np.float64)

        def dev(a):
            return torch.as_tensor(np.asarray(a)).to(device=self.device, dtype=dtype)

        return EncoderEncodings(
            pos=dev(pos),
            scale=dev(scale),
            levels=dev(levels_expansion(levels, D)),
            levels_dec=dev(levels_expansion(levels, cfg.decoder_embed_dim)),
            lead_time=dev(lead_time_expansion(np.array(cfg.timestep_hours, np.float64), D)),
            absolute_time=dev(absolute_time_expansion(abs_hours, D)),
        )

    def forward_core(self, surf, static, atmos, enc: EncoderEncodings, rollout_step: int,
                     atmos_levels):
        """Unnormalised ``surf (B, T, H, W)``, ``static (H, W)``, ``atmos (B, T, C, H, W)``
        -> unnormalised predictions ``(B, H, W)`` / ``(B, C, H, W)``."""
        cfg = self.cfg
        stats = dict(cfg.surf_stats)
        B, T, H, W = next(iter(surf.values())).shape
        patch_res = (cfg.latent_levels, H // cfg.patch_size, W // cfg.patch_size)

        surf_n = {k: normalise_surf_var(v, k, stats) for k, v in surf.items()}
        static_n = {k: normalise_surf_var(v, k, stats) for k, v in static.items()}
        atmos_n = {k: normalise_atmos_var(v, k, atmos_levels) for k, v in atmos.items()}
        static_exp = {k: v[None, None].expand(B, T, H, W) for k, v in static_n.items()}
        surf_t = {
            k: v.clamp(min=0) if k in cfg.positive_surf_vars else v for k, v in surf_n.items()
        }
        atmos_t = {
            k: v.clamp(min=0) if k in cfg.positive_atmos_vars else v for k, v in atmos_n.items()
        }

        x = self.encoder(surf_t, static_exp, atmos_t, enc)
        if cfg.autocast:
            x = self.backbone(x.to(torch.bfloat16), enc.lead_time, rollout_step, patch_res)
            x = x.to(torch.float32)
        else:
            x = self.backbone(x, enc.lead_time, rollout_step, patch_res)
        surf_pred, atmos_pred = self.decoder(
            x, tuple(surf_t), tuple(atmos_t), enc.levels_dec, patch_res, H, W
        )

        pred_step = rollout_step + 1
        gate = pred_step >= 1 if cfg.clamp_at_first_step else pred_step > 1
        if gate:
            surf_pred = {
                k: v.clamp(min=0) if k in cfg.positive_surf_vars else v
                for k, v in surf_pred.items()
            }
            atmos_pred = {
                k: v.clamp(min=0) if k in cfg.positive_atmos_vars else v
                for k, v in atmos_pred.items()
            }
        surf_out = {k: unnormalise_surf_var(v, k, stats) for k, v in surf_pred.items()}
        atmos_out = {k: unnormalise_atmos_var(v, k, atmos_levels) for k, v in atmos_pred.items()}
        return surf_out, atmos_out

    @torch.no_grad()
    def forward(self, batch: Batch) -> Batch:
        """One prediction step: returns a :class:`Batch` one timestep ahead."""
        cfg = self.cfg
        batch = batch.crop(patch_size=cfg.patch_size)
        # The compute dtype is the encoder's: the backbone may be stored in bf16.
        dtype = self.encoder.surf_level_encoding.dtype
        enc = self.prepare_encodings(batch, torch.float32 if dtype == torch.bfloat16 else dtype)
        b = batch.to(self.device, dtype)
        surf_pred, atmos_pred = self.forward_core(
            b.surf_vars, b.static_vars, b.atmos_vars, enc,
            batch.metadata.rollout_step, tuple(batch.metadata.atmos_levels),
        )
        md = batch.metadata
        return Batch(
            surf_vars={k: v[:, None] for k, v in surf_pred.items()},
            static_vars=dict(b.static_vars),
            atmos_vars={k: v[:, None] for k, v in atmos_pred.items()},
            metadata=Metadata(
                lat=md.lat,
                lon=md.lon,
                time=tuple(t + cfg.timestep for t in md.time),
                atmos_levels=md.atmos_levels,
                rollout_step=md.rollout_step + 1,
            ),
        )


class AuroraPretrained(Aurora):
    @classmethod
    def default_config(cls):
        return LARGE_CONFIG
