"""Perceiver3D decoder: backbone tokens -> per-variable fields (port of
``aurora_tpu/model/decoder.py``; reference: aurora/model/decoder.py:140-276).

The latent levels are de-aggregated to the pressure levels by a resampler whose queries
are the pressure-level embeddings; per-variable linear heads, stacked into one GEMM,
produce patch pixels that are un-patchified into fields.
"""

from __future__ import annotations

import torch
from torch import nn

from aurora_tpu_torch.model.config import AuroraConfig
from aurora_tpu_torch.model.nn import Linear, linear
from aurora_tpu_torch.model.perceiver import PerceiverResampler, resampler_shared_query_apply

__all__ = ["Decoder", "unpatchify"]


def unpatchify(x: torch.Tensor, V: int, H: int, W: int, P: int) -> torch.Tensor:
    """``(B, L, C, P*P*V)`` with features in (p_h, p_w, v) order -> ``(B, V, C, H, W)``."""
    B, L, C, _ = x.shape
    Hp, Wp = H // P, W // P
    assert L == Hp * Wp and x.shape[-1] == V * P * P
    x = x.reshape(B, Hp, Wp, C, P, P, V).permute(0, 6, 3, 1, 4, 2, 5)
    return x.reshape(B, V, C, H, W)


def _stack_heads(heads: nn.ModuleDict, names) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-variable ``(D, P*P)`` heads as one ``(D, P*P*V)`` linear in (p, v) order."""
    w = torch.stack([heads[n].weight for n in names], dim=-1)
    b = torch.stack([heads[n].bias for n in names], dim=-1)
    return w.reshape(w.shape[0], -1), b.reshape(-1)


class Decoder(nn.Module):
    def __init__(self, cfg: AuroraConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        D = cfg.decoder_embed_dim
        P2 = cfg.patch_size**2
        self.cfg = cfg
        self.level_decoder = PerceiverResampler(
            D, D, depth=cfg.dec_depth, head_dim=D // cfg.num_heads, num_heads=cfg.num_heads,
            mlp_ratio=cfg.dec_mlp_ratio, **kw,
        )
        self.atmos_levels_embed = Linear(D, D, **kw)
        self.surf_heads = nn.ModuleDict({n: Linear(D, P2, **kw) for n in cfg.surf_vars})
        self.atmos_heads = nn.ModuleDict({n: Linear(D, P2, **kw) for n in cfg.atmos_vars})

    def reset_parameters(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, Linear):
                m.reset_parameters(gen)

    def _deaggregate(self, level_embed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``(C_A, D)`` queries, level-major ``(B, C', L, D)`` context -> ``(B, L, C_A, D)``."""
        cfg = self.cfg
        B, Cp, L, D = x.shape
        value_bf16 = bool(cfg.deagg_bf16) and x.dtype == torch.float32
        ctx = x.reshape(Cp, B * L, D) if B == 1 else x.transpose(0, 1).reshape(Cp, B * L, D)
        out = resampler_shared_query_apply(
            self.level_decoder, level_embed, ctx, ln_eps=cfg.perceiver_ln_eps,
            value_bf16=value_bf16,
        )
        out = out.reshape(B, L, *out.shape[1:])
        # Under value_bf16 the heads read bf16 and accumulate in f32 (_head_linear).
        return out if value_bf16 else out.to(x.dtype)

    def forward(self, x, surf_names, atmos_names, levels_encode, patch_res, H: int, W: int):
        """Tokens ``(B, C_l * Hp * Wp, 2D)`` -> surface ``{name: (B, H, W)}`` and
        atmospheric ``{name: (B, C_A, H, W)}`` predictions (normalised)."""
        B, _, D = x.shape
        C_l, Hp, Wp = patch_res
        P = self.cfg.patch_size
        x = x.reshape(B, C_l, Hp * Wp, D)

        w, b = _stack_heads(self.surf_heads, surf_names)
        surf = unpatchify(linear(x[:, 0][:, :, None], w, b), len(surf_names), H, W, P)[:, :, 0]

        levels_embed = self.atmos_levels_embed(levels_encode.to(x.dtype))  # (C_A, D)
        x_atmos = self._deaggregate(levels_embed, x[:, 1:])
        w, b = _stack_heads(self.atmos_heads, atmos_names)
        atmos = unpatchify(_head_linear(x_atmos, w, b), len(atmos_names), H, W, P)
        return (
            {v: surf[:, i] for i, v in enumerate(surf_names)},
            {v: atmos[:, i] for i, v in enumerate(atmos_names)},
        )


def _head_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Head projection in ``x``'s dtype with an f32 result for bf16 inputs: the GEMM
    operands stay bf16, products accumulate in f32 (``decoder.py:186-202``)."""
    if x.dtype != torch.bfloat16:
        return linear(x, w, b)
    return x.float() @ w.to(torch.bfloat16).float() + b.to(torch.float32)
