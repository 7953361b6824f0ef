"""3D Swin-Transformer U-Net backbone (port of ``aurora_tpu/model/swin3d.py``).

Tokens stay 5D ``(B, C, H, W, D)`` through the backbone. One block is LN-after with FiLM
on both branches (reference: aurora/model/swin3d.py:440-509):

* shifted blocks roll the grid by ``-window/2`` before attention and back after it (K1);
* the grid is centre-padded to window multiples; window attention with its whole tail,
  ``x + LN(proj(attn(x))) * scale + shift``, runs on the padded tokens (K2), with the LoRA
  adapters folded into the qkv/proj weights;
* the MLP branch ``x + LN(mlp(x)) * scale + shift`` is one call (K3).

Encoder stages double the feature dim by patch merging, decoder stages halve it by patch
splitting; intermediate skips are additive and the last one a concatenation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from aurora_tpu_torch.model.config import BackboneConfig
from aurora_tpu_torch.model.lora import LoRA, lora_weight_delta
from aurora_tpu_torch.model.nn import (
    AdaptiveLayerNorm,
    LayerNorm,
    Linear,
    MLP,
)
from aurora_tpu_torch.ops.masks import three_sided_padding, window_group_ids
from aurora_tpu_torch.ops.mlp import mlp_adaln_residual
from aurora_tpu_torch.ops.roll import roll3d
from aurora_tpu_torch.ops.window_attention import window_attention_tail

__all__ = [
    "Backbone",
    "SwinBlock",
    "maybe_adjust_windows",
    "pad_3d",
    "crop_3d",
    "get_encoder_specs",
]


def maybe_adjust_windows(window_size, shift_size, res):
    """Shrink windows (and zero the shift) along axes where the grid is not larger than
    the window (reference: aurora/model/util.py:53-71)."""
    ws, ss = list(window_size), list(shift_size)
    for i in range(len(res)):
        if res[i] <= window_size[i]:
            ss[i] = 0
            ws[i] = res[i]
    return tuple(ws), tuple(ss)


def pad_3d(x: torch.Tensor, pad: tuple[int, int, int]) -> torch.Tensor:
    """Centre-pad ``(B, C, H, W, D)`` with zeros along (C, H, W)."""
    left, right, top, bottom, front, back = three_sided_padding(*pad)
    return F.pad(x, (0, 0, left, right, top, bottom, front, back))


def crop_3d(x: torch.Tensor, pad: tuple[int, int, int]) -> torch.Tensor:
    """Inverse of :func:`pad_3d`."""
    _, C, H, W, _ = x.shape
    left, right, top, bottom, front, back = three_sided_padding(*pad)
    return x[:, front : C - back, top : H - bottom, left : W - right, :]


class WindowAttention(nn.Module):
    def __init__(self, dim: int, cfg: BackboneConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.qkv = Linear(dim, 3 * dim, **kw)
        self.proj = Linear(dim, dim, **kw)
        if cfg.use_lora:
            lk = dict(r=cfg.lora_r, max_steps=cfg.lora_steps, mode=cfg.lora_mode, **kw)
            self.lora_qkv = LoRA(dim, 3 * dim, **lk)
            self.lora_proj = LoRA(dim, dim, **lk)
        else:
            self.lora_qkv = self.lora_proj = None


class SwinBlock(nn.Module):
    def __init__(self, dim: int, cfg: BackboneConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.norm1 = AdaptiveLayerNorm(dim, cfg.embed_dim, **kw)
        self.attn = WindowAttention(dim, cfg, **kw)
        self.norm2 = AdaptiveLayerNorm(dim, cfg.embed_dim, **kw)
        self.mlp = MLP(dim, int(dim * cfg.mlp_ratio), **kw)

    def _weight(self, lin: Linear, lora, rollout_step: int) -> torch.Tensor:
        w = lin.weight
        if lora is not None:
            cfg = self.cfg
            w = w + lora_weight_delta(
                lora.A, lora.B, rollout_step, r=cfg.lora_r, alpha=cfg.lora_alpha,
                max_steps=cfg.lora_steps, mode=cfg.lora_mode,
            )
        return w

    def forward(
        self,
        x: torch.Tensor,
        c: torch.Tensor,
        res: tuple[int, int, int],
        shift_size: tuple[int, int, int],
        num_heads: int,
        rollout_step: int,
    ) -> torch.Tensor:
        C, H, W = res
        B, D = x.shape[0], x.shape[-1]
        assert tuple(x.shape[1:4]) == (C, H, W), f"Wrong grid: {x.shape} vs {res}"
        ws, ss = maybe_adjust_windows(self.cfg.window_size, shift_size, res)
        shifted = any(ss)
        if shifted:
            x = roll3d(x, (-ss[0], -ss[1], -ss[2]))
        pad = ((-C) % ws[0], (-H) % ws[1], (-W) % ws[2])
        groups = window_group_ids(C, H, W, ws, ss) if shifted else None
        shift1, scale1 = self.norm1.shift_scale(c)
        att = self.attn
        xp = window_attention_tail(
            pad_3d(x, pad),
            self._weight(att.qkv, att.lora_qkv, rollout_step), att.qkv.bias,
            self._weight(att.proj, att.lora_proj, rollout_step), att.proj.bias,
            shift1, scale1, groups, ws, num_heads,
        )
        x = crop_3d(xp, pad).contiguous()
        if shifted:
            x = roll3d(x, ss)
        shift2, scale2 = self.norm2.shift_scale(c)
        m = self.mlp
        x = mlp_adaln_residual(
            x.reshape(B, C * H * W, D),
            m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias, shift2, scale2,
        )
        return x.reshape(B, C, H, W, D)


class PatchMerge(nn.Module):
    """2x2 spatial merge ``(B, C, H, W, D) -> (B, C, H/2, W/2, 2D)`` (odd H/W are
    centre-padded first)."""

    def __init__(self, dim: int, *, device=None, dtype=None):
        super().__init__()
        self.norm = LayerNorm(4 * dim, device=device, dtype=dtype)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, res: tuple[int, int, int]) -> torch.Tensor:
        C, H, W = res
        B, D = x.shape[0], x.shape[-1]
        x = pad_3d(x, (0, H % 2, W % 2))
        H2, W2 = x.shape[2] // 2, x.shape[3] // 2
        # Feature order (i, j, D) with i the row and j the column offset in the 2x2 cell.
        x = x.reshape(B, C, H2, 2, W2, 2 * D).permute(0, 1, 2, 4, 3, 5)
        x = x.reshape(B, C, H2, W2, 4 * D)
        return self.reduction(self.norm(x))


class PatchSplit(nn.Module):
    """Inverse of :class:`PatchMerge`: ``(B, C, H, W, D) -> (B, C, 2H', 2W', D/2)`` with
    the merge padding cropped away."""

    def __init__(self, dim: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.lin1 = Linear(dim, 2 * dim, bias=False, **kw)
        self.lin2 = Linear(dim // 2, dim // 2, bias=False, **kw)
        self.norm = LayerNorm(dim // 2, **kw)

    def forward(self, x, res, crop) -> torch.Tensor:
        C, H, W = res
        B, D = x.shape[0], x.shape[-1]
        x = self.lin1(x).reshape(B, C, H, W, 2, D).permute(0, 1, 2, 4, 3, 5)
        x = crop_3d(x.reshape(B, C, 2 * H, 2 * W, D // 2), crop)
        return self.lin2(self.norm(x))


class BasicLayer(nn.Module):
    def __init__(self, dim, depth, cfg, down: bool, up: bool, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.blocks = nn.ModuleList(SwinBlock(dim, cfg, **kw) for _ in range(depth))
        self.downsample = PatchMerge(dim, **kw) if down else None
        self.upsample = PatchSplit(dim, **kw) if up else None


def get_encoder_specs(cfg: BackboneConfig, patch_res: tuple[int, int, int]):
    """Input resolution and output padding of every encoder stage."""
    all_res = [patch_res]
    padded_outs = []
    for _ in range(1, len(cfg.encoder_depths)):
        C, H, W = all_res[-1]
        pad_H, pad_W = H % 2, W % 2
        padded_outs.append((0, pad_H, pad_W))
        all_res.append((C, (H + pad_H) // 2, (W + pad_W) // 2))
    padded_outs.append((0, 0, 0))
    return all_res, padded_outs


class TimeMLP(nn.Module):
    def __init__(self, dim: int, *, device=None, dtype=None):
        super().__init__()
        self.fc1 = Linear(dim, dim, device=device, dtype=dtype)
        self.fc2 = Linear(dim, dim, device=device, dtype=dtype)

    def forward(self, t):
        return self.fc2(F.silu(self.fc1(t)))


class Backbone(nn.Module):
    """The U-Net over tokens ``(B, L, D)`` with FiLM conditioning on the lead time."""

    def __init__(self, cfg: BackboneConfig, *, device=None, dtype=None):
        super().__init__()
        assert sum(cfg.encoder_depths) == sum(cfg.decoder_depths)
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        n_enc, n_dec = len(cfg.encoder_depths), len(cfg.decoder_depths)
        self.time_mlp = TimeMLP(cfg.embed_dim, **kw)
        self.encoder_layers = nn.ModuleList(
            BasicLayer(cfg.embed_dim * 2**i, cfg.encoder_depths[i], cfg,
                       down=i < n_enc - 1, up=False, **kw)
            for i in range(n_enc)
        )
        self.decoder_layers = nn.ModuleList(
            BasicLayer(cfg.embed_dim * 2 ** (n_dec - i - 1), cfg.decoder_depths[i], cfg,
                       down=False, up=i < n_dec - 1, **kw)
            for i in range(n_dec)
        )

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Seeded init: linears truncated-normal with zero bias, LoRA A uniform and B
        zero, FiLM modulations zero, LayerNorms one/zero."""
        for m in self.modules():
            if isinstance(m, (Linear, LoRA)):
                m.reset_parameters(gen)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, AdaptiveLayerNorm):
                    m.modulation.weight.zero_()

    def _run_blocks(self, layer, x, c, res, num_heads, rollout_step):
        half = tuple(w // 2 for w in self.cfg.window_size)
        for i, block in enumerate(layer.blocks):
            shift = (0, 0, 0) if i % 2 == 0 else half
            x = block(x, c, res, shift, num_heads, rollout_step)
        return x

    def forward(self, x, lead_time_encode, rollout_step: int, patch_res):
        cfg = self.cfg
        B, L, D = x.shape
        assert L == patch_res[0] * patch_res[1] * patch_res[2], "Input shape mismatch."
        assert patch_res[0] % cfg.window_size[0] == 0
        all_enc_res, padded_outs = get_encoder_specs(cfg, patch_res)
        n_dec = len(cfg.decoder_depths)
        lt = lead_time_encode.to(x.dtype).expand(B, lead_time_encode.shape[-1])
        c = self.time_mlp(lt)
        x = x.reshape(B, *patch_res, D)
        skips = []
        for i, layer in enumerate(self.encoder_layers):
            x = self._run_blocks(layer, x, c, all_enc_res[i], cfg.encoder_num_heads[i],
                                 rollout_step)
            skips.append(x)
            if layer.downsample is not None:
                x = layer.downsample(x, all_enc_res[i])
        for i, layer in enumerate(self.decoder_layers):
            index = n_dec - i - 1
            x = self._run_blocks(layer, x, c, all_enc_res[index], cfg.decoder_num_heads[i],
                                 rollout_step)
            if layer.upsample is not None:
                x = layer.upsample(x, all_enc_res[index], padded_outs[index - 1])
            if 0 < i < n_dec - 1:
                x = x + skips[index - 1]
            elif i == n_dec - 1:
                x = torch.cat([x, skips[0]], dim=-1)
        return x.reshape(B, L, x.shape[-1])
