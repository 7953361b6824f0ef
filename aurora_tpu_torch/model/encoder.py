"""Perceiver3D encoder: variables x pressure levels -> latent token grid (port of
``aurora_tpu/model/encoder.py``; reference: aurora/model/encoder.py:198-366).

The Fourier encodings (position, scale, pressure level, lead time, absolute time) arrive
precomputed on the host in float64 and rounded to float32 (:mod:`aurora_tpu_torch.fourier`).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from aurora_tpu_torch.model.config import AuroraConfig
from aurora_tpu_torch.model.nn import LayerNorm, Linear, MLP, trunc_normal_
from aurora_tpu_torch.model.patchembed import LevelPatchEmbed
from aurora_tpu_torch.model.perceiver import PerceiverResampler, resampler_shared_query_apply

__all__ = ["Encoder", "EncoderEncodings"]


@dataclasses.dataclass
class EncoderEncodings:
    """Host-precomputed encodings: ``pos``/``scale`` ``(L, D)``, ``levels`` ``(C_A, D)``,
    ``levels_dec`` ``(C_A, 2D)``, ``lead_time`` ``(D,)``, ``absolute_time`` ``(B, D)``."""

    pos: torch.Tensor
    scale: torch.Tensor
    levels: torch.Tensor
    levels_dec: torch.Tensor
    lead_time: torch.Tensor
    absolute_time: torch.Tensor


class Encoder(nn.Module):
    def __init__(self, cfg: AuroraConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        D = cfg.embed_dim
        self.cfg = cfg
        self.surf_token_embeds = LevelPatchEmbed(
            cfg.all_surf_vars, cfg.patch_size, D, cfg.max_history_size, **kw
        )
        self.atmos_token_embeds = LevelPatchEmbed(
            cfg.atmos_vars, cfg.patch_size, D, cfg.max_history_size, **kw
        )
        self.atmos_latents = nn.Parameter(torch.zeros(cfg.latent_levels - 1, D, **kw))
        self.surf_level_encoding = nn.Parameter(torch.zeros(D, **kw))
        self.surf_mlp = MLP(D, int(D * cfg.mlp_ratio), **kw)
        self.surf_norm = LayerNorm(D, **kw)
        self.pos_embed = Linear(D, D, **kw)
        self.scale_embed = Linear(D, D, **kw)
        self.lead_time_embed = Linear(D, D, **kw)
        self.absolute_time_embed = Linear(D, D, **kw)
        self.atmos_levels_embed = Linear(D, D, **kw)
        self.level_agg = PerceiverResampler(
            D, D, depth=cfg.enc_depth, head_dim=D // cfg.num_heads, num_heads=cfg.num_heads,
            mlp_ratio=cfg.mlp_ratio, ln_k_q=cfg.stabilise_level_agg, **kw,
        )

    def reset_parameters(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, (Linear, LevelPatchEmbed)):
                m.reset_parameters(gen)
        trunc_normal_(self.atmos_latents, gen)
        trunc_normal_(self.surf_level_encoding, gen)

    def _aggregate_levels(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, C_A, L, D) -> (B, C_l, L, D)``, one cross-attention per token column."""
        cfg = self.cfg
        B, C_A, L, D = x.shape
        value_bf16 = bool(cfg.agg_bf16) and x.dtype == torch.float32
        latents = self.atmos_latents.to(x.dtype)
        ctx = x.reshape(C_A, B * L, D) if B == 1 else x.transpose(0, 1).reshape(C_A, B * L, D)
        out = resampler_shared_query_apply(
            self.level_agg, latents, ctx, ln_eps=cfg.perceiver_ln_eps, value_bf16=value_bf16
        )  # (B * L, C_l, D)
        return out.reshape(B, L, -1, D).transpose(1, 2).to(x.dtype)

    def forward(self, surf_vars, static_vars, atmos_vars, enc: EncoderEncodings):
        """``surf_vars[k]: (B, T, H, W)``, ``static_vars[k]: (B, T, H, W)`` (expanded),
        ``atmos_vars[k]: (B, T, C_A, H, W)``, all normalised -> ``(B, C_l * L, D)``."""
        cfg = self.cfg
        surf_names = tuple(surf_vars) + tuple(static_vars)
        atmos_names = tuple(atmos_vars)
        x_surf = torch.stack(list(surf_vars.values()) + list(static_vars.values()), dim=2)
        x_atmos = torch.stack(list(atmos_vars.values()), dim=2)  # (B, T, V, C, H, W)
        B, T, _, C_A, H, W = x_atmos.shape
        dtype = x_surf.dtype

        x_surf = self.surf_token_embeds(x_surf.transpose(1, 2), surf_names)  # (B, L, D)
        xa = x_atmos.permute(0, 3, 2, 1, 4, 5).reshape(B * C_A, len(atmos_names), T, H, W)
        x_atmos = self.atmos_token_embeds(xa, atmos_names).reshape(B, C_A, -1, cfg.embed_dim)

        x_surf = x_surf + self.surf_level_encoding.to(dtype)
        x_surf = x_surf + self.surf_norm(self.surf_mlp(x_surf))

        levels_embed = self.atmos_levels_embed(enc.levels.to(dtype))  # (C_A, D)
        x_atmos = self._aggregate_levels(x_atmos + levels_embed[None, :, None, :])

        x = torch.cat((x_surf[:, None], x_atmos), dim=1)  # (B, C_l, L, D)
        x = x + self.pos_embed(enc.pos.to(dtype))[None, None]
        x = x + self.scale_embed(enc.scale.to(dtype))[None, None]
        x = x.reshape(B, -1, cfg.embed_dim)
        lt = enc.lead_time.to(dtype)[None].expand(B, cfg.embed_dim)
        x = x + self.lead_time_embed(lt)[:, None]
        x = x + self.absolute_time_embed(enc.absolute_time.to(dtype))[:, None]
        return x
