"""Perceiver3D encoder: variables x pressure levels -> latent token grid (port of
``aurora_tpu/model/encoder.py``; reference: aurora/model/encoder.py:198-366).

The Fourier encodings (position, scale, pressure level, lead time, absolute time) arrive
precomputed on the host in float64 and rounded to float32 (:mod:`aurora_tpu_torch.fourier`).
The air-pollution model adds the time features of ``dynamic_vars`` as surface channels, the
static (and time) channels to every pressure level (``atmos_static_vars``), and one
atmospheric patch embedding per level (``level_condition``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from aurora_tpu_torch.model.config import AuroraConfig
from aurora_tpu_torch.model.nn import LayerNorm, Linear, MLP, full_f32_products, trunc_normal_
from aurora_tpu_torch.model.patchembed import LevelPatchEmbed
from aurora_tpu_torch.model.perceiver import PerceiverResampler, resampler_shared_query_apply
from aurora_tpu_torch.normalisation import level_to_str

__all__ = ["Encoder", "EncoderEncodings"]


@dataclasses.dataclass
class EncoderEncodings:
    """Host-precomputed encodings: ``pos``/``scale`` ``(L, D)``, ``levels`` ``(C_A, D)``,
    ``levels_dec`` ``(C_A, 2D)``, ``lead_time`` ``(D,)``, ``absolute_time`` ``(B, D)``, and
    for ``dynamic_vars`` models ``dynamic_scalars`` ``(B, 6)``: the time-of-day, -week and
    -year features in the order of ``AuroraConfig.dynamic_var_names``."""

    pos: torch.Tensor
    scale: torch.Tensor
    levels: torch.Tensor
    levels_dec: torch.Tensor
    lead_time: torch.Tensor
    absolute_time: torch.Tensor
    dynamic_scalars: Optional[torch.Tensor] = None


class Encoder(nn.Module):
    def __init__(self, cfg: AuroraConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        D = cfg.embed_dim
        self.cfg = cfg
        self.surf_token_embeds = LevelPatchEmbed(
            cfg.all_surf_vars, cfg.patch_size, D, cfg.max_history_size, **kw
        )
        if not cfg.level_condition:
            self.atmos_token_embeds = LevelPatchEmbed(
                cfg.all_atmos_vars, cfg.patch_size, D, cfg.max_history_size, **kw
            )
        else:  # One embedding per pressure level (``atmos_token_embeds.layers.<level>``).
            self.atmos_token_embeds = nn.Module()
            self.atmos_token_embeds.layers = nn.ModuleDict({
                level_to_str(lvl): LevelPatchEmbed(
                    cfg.all_atmos_vars, cfg.patch_size, D, cfg.max_history_size, **kw)
                for lvl in cfg.level_condition
            })
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

    @full_f32_products()
    def forward(self, surf_vars, static_vars, atmos_vars, enc: EncoderEncodings,
                atmos_levels=None):
        """``surf_vars[k]: (B, T, H, W)``, ``static_vars[k]: (B, T, H, W)`` (expanded),
        ``atmos_vars[k]: (B, T, C_A, H, W)``, all normalised -> ``(B, C_l * L, D)``. A
        ``level_condition`` model picks each level's embedding by ``atmos_levels`` (hPa)."""
        cfg = self.cfg
        static_names = tuple(static_vars)
        surf_names = tuple(surf_vars) + static_names
        atmos_names = tuple(atmos_vars)
        x_static = torch.stack(list(static_vars.values()), dim=2)  # (B, T, Vs, H, W)
        x_surf = torch.stack(list(surf_vars.values()), dim=2)
        x_atmos = torch.stack(list(atmos_vars.values()), dim=2)  # (B, T, V, C, H, W)
        B, T, _, C_A, H, W = x_atmos.shape
        dtype = x_surf.dtype

        def per_level(z):  # (B, T, V, H, W) -> (B, T, V, C_A, H, W)
            return z[:, :, :, None].expand(*z.shape[:3], C_A, H, W)

        extra = [x_static]
        if cfg.dynamic_vars:
            if enc.dynamic_scalars is None:
                raise ValueError("a dynamic_vars model needs enc.dynamic_scalars")
            dyn = enc.dynamic_scalars.to(dtype)  # (B, 6)
            extra.append(dyn[:, None, :, None, None].expand(B, T, dyn.shape[-1], H, W))
            surf_names = surf_names + cfg.dynamic_var_names
            static_names = static_names + cfg.dynamic_var_names
        x_surf = torch.cat([x_surf] + extra, dim=2)
        if cfg.atmos_static_vars:
            atmos_names = atmos_names + tuple(
                (f"static_{v}" for v in static_names) if cfg.dynamic_vars else static_names)
            x_atmos = torch.cat([x_atmos] + [per_level(z) for z in extra], dim=2)

        x_surf = self.surf_token_embeds(x_surf.transpose(1, 2), surf_names)  # (B, L, D)

        # The original air-pollution model reads ``z`` where it means ``static_z``; kept for
        # the released weights (``aurora_tpu/model/encoder.py:217-228``).
        if cfg.simulate_indexing_bug and "z" in atmos_names and "static_z" in atmos_names:
            i_z, i_sz = atmos_names.index("z"), atmos_names.index("static_z")
            x_atmos = torch.cat(
                (x_atmos[:, :, :i_sz], x_atmos[:, :, i_z:i_z + 1], x_atmos[:, :, i_sz + 1:]),
                dim=2)

        if not cfg.level_condition:
            xa = x_atmos.permute(0, 3, 2, 1, 4, 5).reshape(B * C_A, len(atmos_names), T, H, W)
            x_atmos = self.atmos_token_embeds(xa, atmos_names).reshape(B, C_A, -1, cfg.embed_dim)
        else:
            if atmos_levels is None:
                raise ValueError("a level_condition model needs the batch's atmos_levels")
            layers = self.atmos_token_embeds.layers
            x_atmos = torch.stack([
                layers[level_to_str(lvl)](x_atmos[:, :, :, i].transpose(1, 2), atmos_names)
                for i, lvl in enumerate(atmos_levels)
            ], dim=1)  # (B, C_A, L, D)

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
