"""Perceiver3D decoder: backbone tokens -> per-variable fields (port of
``aurora_tpu/model/decoder.py``; reference: aurora/model/decoder.py:140-276).

The latent levels are de-aggregated to the pressure levels by a resampler whose queries
are the pressure-level embeddings; per-variable linear heads, stacked into one GEMM,
produce patch pixels that are un-patchified into fields. The air-pollution model adds a
``_mod`` head per variable of ``modulation_heads``, a second de-aggregation
(``level_decoder_alternate``) for the variables of ``separate_perceiver``, and one head per
pressure level under ``level_condition``; those heads run one by one.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from aurora_tpu_torch.model.config import AuroraConfig
from aurora_tpu_torch.model.nn import Linear, full_f32_products, linear
from aurora_tpu_torch.model.perceiver import PerceiverResampler, resampler_shared_query_apply
from aurora_tpu_torch.normalisation import level_to_str

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


def _head_vars(cfg: AuroraConfig):
    """The head variables: each variable, then a ``<name>_mod`` head for every variable of
    ``modulation_heads``; and the heads that read the second de-aggregation
    (``aurora_tpu/model/decoder.py:66-77``)."""
    surf = cfg.surf_vars + tuple(f"{n}_mod" for n in cfg.surf_vars if n in cfg.modulation_heads)
    atmos = cfg.atmos_vars + tuple(
        f"{n}_mod" for n in cfg.atmos_vars if n in cfg.modulation_heads)
    separate = cfg.separate_perceiver
    if cfg.modulation_heads:
        separate = separate + tuple(f"{n}_mod" for n in cfg.separate_perceiver)
    return surf, atmos, separate


def _level_heads(D: int, P2: int, levels, **kw) -> nn.Module:
    """One ``(D, P*P)`` head per pressure level: ``<head>.layers.<level>``."""
    m = nn.Module()
    m.layers = nn.ModuleDict({level_to_str(lvl): Linear(D, P2, **kw) for lvl in levels})
    return m


class Decoder(nn.Module):
    def __init__(self, cfg: AuroraConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        D = cfg.decoder_embed_dim
        P2 = cfg.patch_size**2
        self.cfg = cfg
        surf_vars, atmos_vars, separate = _head_vars(cfg)

        def resampler():
            return PerceiverResampler(
                D, D, depth=cfg.dec_depth, head_dim=D // cfg.num_heads,
                num_heads=cfg.num_heads, mlp_ratio=cfg.dec_mlp_ratio, **kw,
            )

        self.level_decoder = resampler()
        # The heads of ``separate_perceiver`` read a de-aggregation of their own.
        self.level_decoder_alternate = resampler() if separate else None
        self.atmos_levels_embed = Linear(D, D, **kw)
        self.surf_heads = nn.ModuleDict({n: Linear(D, P2, **kw) for n in surf_vars})
        if not cfg.level_condition:
            self.atmos_heads = nn.ModuleDict({n: Linear(D, P2, **kw) for n in atmos_vars})
        else:
            self.atmos_heads = nn.ModuleDict(
                {n: _level_heads(D, P2, cfg.level_condition, **kw) for n in atmos_vars})

    def reset_parameters(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, Linear):
                m.reset_parameters(gen)

    def _deaggregate(self, level_embed: torch.Tensor, x: torch.Tensor,
                     resampler: Optional[PerceiverResampler] = None) -> torch.Tensor:
        """``(C_A, D)`` queries, level-major ``(B, C', L, D)`` context -> ``(B, L, C_A, D)``
        through ``resampler`` (``level_decoder`` by default)."""
        cfg = self.cfg
        B, Cp, L, D = x.shape
        value_bf16 = bool(cfg.deagg_bf16) and x.dtype == torch.float32
        ctx = x.reshape(Cp, B * L, D) if B == 1 else x.transpose(0, 1).reshape(Cp, B * L, D)
        out = resampler_shared_query_apply(
            resampler or self.level_decoder, level_embed, ctx, ln_eps=cfg.perceiver_ln_eps,
            value_bf16=value_bf16,
        )
        out = out.reshape(B, L, *out.shape[1:])
        # Under value_bf16 the heads read bf16 and accumulate in f32 (_head_linear).
        return out if value_bf16 else out.to(x.dtype)

    @full_f32_products()
    def forward(self, x, surf_names, atmos_names, levels_encode, patch_res, H: int, W: int,
                atmos_levels=None):
        """Tokens ``(B, C_l * Hp * Wp, 2D)`` -> surface ``{name: (B, H, W)}`` and
        atmospheric ``{name: (B, C_A, H, W)}`` predictions (normalised), with a
        ``<name>_mod`` entry for every variable of ``modulation_heads``. A
        ``level_condition`` model picks each level's heads by ``atmos_levels`` (hPa)."""
        cfg = self.cfg
        if cfg.level_condition and atmos_levels is None:
            raise ValueError("a level_condition model needs the batch's atmos_levels")
        _, _, separate = _head_vars(cfg)
        surf_names = tuple(surf_names) + tuple(
            f"{n}_mod" for n in surf_names if n in cfg.modulation_heads)
        atmos_names = tuple(atmos_names) + tuple(
            f"{n}_mod" for n in atmos_names if n in cfg.modulation_heads)
        B, _, D = x.shape
        C_l, Hp, Wp = patch_res
        P = cfg.patch_size
        x = x.reshape(B, C_l, Hp * Wp, D)

        w, b = _stack_heads(self.surf_heads, surf_names)
        surf = unpatchify(linear(x[:, 0][:, :, None], w, b), len(surf_names), H, W, P)[:, :, 0]

        levels_embed = self.atmos_levels_embed(levels_encode.to(x.dtype))  # (C_A, D)
        x_atmos = self._deaggregate(levels_embed, x[:, 1:])
        if not cfg.level_condition and not separate:
            w, b = _stack_heads(self.atmos_heads, atmos_names)
            xa = _head_linear(x_atmos, w, b)
        else:
            inputs = {False: x_atmos}
            if separate:  # A second K4 + K3 call on the same context.
                inputs[True] = self._deaggregate(
                    levels_embed, x[:, 1:], self.level_decoder_alternate)

            def run_head(name):
                inp, head = inputs[name in separate], self.atmos_heads[name]
                if not cfg.level_condition:
                    return _head_linear(inp, head.weight, head.bias)  # (B, L, C_A, P*P)
                heads = [head.layers[level_to_str(lvl)] for lvl in atmos_levels]
                return torch.stack([_head_linear(inp[..., i, :], h.weight, h.bias)
                                    for i, h in enumerate(heads)], dim=-2)

            xa = torch.stack([run_head(n) for n in atmos_names], dim=-1)
            xa = xa.reshape(*xa.shape[:3], -1)  # (B, L, C_A, P*P*V)
        atmos = unpatchify(xa, len(atmos_names), H, W, P)
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
