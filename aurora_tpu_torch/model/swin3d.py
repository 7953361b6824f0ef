"""3D Swin-Transformer U-Net backbone (port of ``aurora_tpu/model/swin3d.py``).

Tokens stay 5D ``(B, C, H, W, D)`` through the backbone. One block is LN-after with FiLM
on both branches (reference: aurora/model/swin3d.py:440-509). Shifted blocks roll the grid
by ``-window/2`` before attention and back after it (K1), and the grid is centre-padded to
window multiples. The rest of a block is routed by ``BackboneConfig.attention_impl`` and
``mlp_impl`` as ``swin_block_apply`` routes it on one device
(``aurora_tpu/model/swin3d.py:1193-1377``):

* attention: ``"pallas"`` runs on the padded 5D tokens (K2); ``"pallas_windowed"`` on
  partitioned windows (K6); ``"xla"`` as plain PyTorch (``nn.sdpa``, plain GEMMs);
* ``mlp_impl="fused"``: the attention tail ``x + LN(proj(attn)) * scale + shift`` runs
  inside K2/K6, or under ``"xla"`` attention after un-windowing as K5; the MLP branch
  ``x + LN(mlp(x)) * scale + shift`` is one call (K3);
* ``mlp_impl`` ``"pallas"``/``"xla"``: proj is a plain GEMM with the LoRA side path, the
  FiLM LayerNorm and residual are plain, and the MLP runs as K8 (``"pallas"``) or plain.

Training with the stochastic knobs (a :class:`~aurora_tpu_torch.model.nn.DrawKey` given, and
the block's stochastic-depth rate or ``drop_rate`` above 0) routes a block as the JAX package
does (``swin3d.py:1122-1124``, ``:1204-1208``): K1 for its rolls, then plain attention and a
plain MLP (the ``"xla"`` route), with dropout after proj and on the MLP's hidden layer and
output, and ``drop_path`` on both branches. The fused tails would add a branch to the
residual inside a kernel before it could be dropped. The rate rises linearly from 0 to
``drop_path`` over the encoder's blocks; the decoder's stages take the same ramp's slices by
their depths (``swin3d.py:1724-1733``). Blocks at rate 0 with ``drop_rate`` 0 keep their
kernels.

LoRA is folded into the weights a kernel reads (the qkv of K2/K6, the proj of an in-kernel
or K5 tail), as the JAX package folds it; every plain projection adds the side path. The
JAX package's fallback from the 5D kernel to the windowed one when no window-row batch fits
the TPU's VMEM budget (``swin3d.py:1253-1260``) has no counterpart on the card: only
``"pallas_windowed"`` reaches K6.

Encoder stages double the feature dim by patch merging, decoder stages halve it by patch
splitting; intermediate skips are additive and the last one a concatenation.

With ``remat`` each block is rematerialised in the backward, and under ``remat_scope``
"full" and "no_outer" each stage too (``aurora_tpu/model/swin3d.py:1585-1586``,
``:1632-1634``, ``:1673-1675``); the whole backbone is wrapped by the model under "full".
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from aurora_tpu_torch.model.config import BackboneConfig
from aurora_tpu_torch.model.lora import LoRA, lora_apply, lora_weight_delta
from aurora_tpu_torch.model.nn import (
    AdaptiveLayerNorm,
    DrawKey,
    LayerNorm,
    Linear,
    MLP,
    checkpointed,
    drop_path,
    dropout,
    gelu,
    linear,
    merge_heads,
    sdpa,
    split_heads,
)
from aurora_tpu_torch.ops.masks import (
    bias_from_groups,
    group_ids_tensor,
    three_sided_padding,
    window_group_ids,
)
from aurora_tpu_torch.ops.mlp import linear_adaln_residual, mlp_adaln_residual, mlp_fused
from aurora_tpu_torch.ops.roll import roll3d
from aurora_tpu_torch.ops.window_attention import (
    window_attention_tail,
    window_attention_windowed,
    window_partition,
    window_reverse,
)

__all__ = [
    "Backbone",
    "SwinBlock",
    "WindowAttention",
    "maybe_adjust_windows",
    "pad_3d",
    "crop_3d",
    "drop_path_rates",
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
        self.cfg = cfg
        self.qkv = Linear(dim, 3 * dim, **kw)
        self.proj = Linear(dim, dim, **kw)
        if cfg.use_lora:
            lk = dict(r=cfg.lora_r, max_steps=cfg.lora_steps, mode=cfg.lora_mode, **kw)
            self.lora_qkv = LoRA(dim, 3 * dim, **lk)
            self.lora_proj = LoRA(dim, dim, **lk)
        else:
            self.lora_qkv = self.lora_proj = None

    def _lora_kw(self) -> dict:
        cfg = self.cfg
        return dict(r=cfg.lora_r, alpha=cfg.lora_alpha, max_steps=cfg.lora_steps,
                    mode=cfg.lora_mode)

    def folded_weight(self, name: str, rollout_step: int) -> torch.Tensor:
        """The weight of ``qkv``/``proj`` with its LoRA adapter folded in, for a kernel."""
        w = getattr(self, name).weight
        lora = getattr(self, f"lora_{name}")
        if lora is not None:
            w = w + lora_weight_delta(lora.A, lora.B, rollout_step, **self._lora_kw())
        return w

    def plain_linear(self, name: str, x: torch.Tensor, rollout_step: int) -> torch.Tensor:
        """``qkv``/``proj`` as a plain GEMM plus the LoRA side path."""
        lin = getattr(self, name)
        out = linear(x, lin.weight, lin.bias)
        lora = getattr(self, f"lora_{name}")
        if lora is not None:
            out = out + lora_apply(lora.A, lora.B, x, rollout_step, **self._lora_kw())
        return out

    def project(self, x: torch.Tensor, rollout_step: int) -> torch.Tensor:
        """The plain proj of ``(..., D)`` tokens, on the flattened rows."""
        return self.plain_linear("proj", x.reshape(-1, x.shape[-1]), rollout_step).reshape(
            x.shape
        )

    def forward(
        self,
        x: torch.Tensor,
        num_heads: int,
        groups: Optional[np.ndarray],
        rollout_step: int,
        impl: str,
        project: bool = True,
        tail=None,
    ) -> torch.Tensor:
        """W-MSA over windows ``x: (B, nW, N, D)`` for ``impl`` ``"pallas_windowed"`` (K6,
        with or without ``tail``) or ``"xla"`` (``window_attention_apply``,
        ``aurora_tpu/model/swin3d.py:275-383``). ``project=False`` returns the attention
        output before proj."""
        B, nW, N, D = x.shape
        if impl == "pallas_windowed":
            out = window_attention_windowed(
                x, self.folded_weight("qkv", rollout_step), self.qkv.bias, groups, num_heads,
                tail=tail,
            )
            if tail is not None or not project:
                return out
            return self.project(out, rollout_step)
        assert impl == "xla" and tail is None, impl
        qkv = self.plain_linear("qkv", x.reshape(B * nW * N, D), rollout_step)
        q, k, v = (split_heads(t, num_heads) for t in qkv.reshape(B, nW, N, 3 * D).chunk(3, -1))
        bias = None
        if groups is not None:
            bias = bias_from_groups(group_ids_tensor(groups, x.device), torch.float32)
            bias = bias[None, :, None]  # (1, nW, 1, N, N) over (B, nW, h, N, N) logits
        out = merge_heads(sdpa(q, k, v, bias))  # (B, nW, N, D)
        return self.project(out, rollout_step) if project else out


class SwinBlock(nn.Module):
    def __init__(self, dim: int, cfg: BackboneConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.norm1 = AdaptiveLayerNorm(dim, cfg.embed_dim, **kw)
        self.attn = WindowAttention(dim, cfg, **kw)
        self.norm2 = AdaptiveLayerNorm(dim, cfg.embed_dim, **kw)
        self.mlp = MLP(dim, int(dim * cfg.mlp_ratio), **kw)

    def forward(
        self,
        x: torch.Tensor,
        c: torch.Tensor,
        res: tuple[int, int, int],
        shift_size: tuple[int, int, int],
        num_heads: int,
        rollout_step: int,
        dp_rate: float = 0.0,
        key: Optional[DrawKey] = None,
    ) -> torch.Tensor:
        """``dp_rate``: the block's stochastic-depth rate; ``key``: its place in the step's
        draws (None: deterministic)."""
        C, H, W = res
        B, D = x.shape[0], x.shape[-1]
        assert tuple(x.shape[1:4]) == (C, H, W), f"Wrong grid: {x.shape} vs {res}"
        stochastic = key is not None and (dp_rate > 0.0 or self.cfg.drop_rate > 0.0)
        if stochastic:
            k_dp1, k_dp2, k_proj, k_hid, k_out = (key.fold(j) for j in range(5))
            aimpl, mimpl = "xla", "xla"
        else:
            aimpl, mimpl = self.cfg.routes()
        fuse_attn_tail = mimpl == "fused"
        tail_in_kernel = fuse_attn_tail and aimpl in ("pallas", "pallas_windowed")
        att = self.attn

        ws, ss = maybe_adjust_windows(self.cfg.window_size, shift_size, res)
        shortcut = x
        shifted = any(ss)
        if shifted:
            x = roll3d(x, (-ss[0], -ss[1], -ss[2]))
        pad = ((-C) % ws[0], (-H) % ws[1], (-W) % ws[2])
        groups = window_group_ids(C, H, W, ws, ss) if shifted else None
        xp = pad_3d(x, pad)
        _, Cp, Hp, Wp, _ = xp.shape

        tail = None
        if fuse_attn_tail:
            shift1, scale1 = self.norm1.shift_scale(c)
            if tail_in_kernel:
                tail = (att.folded_weight("proj", rollout_step), att.proj.bias, shift1, scale1)
        if aimpl == "pallas":
            xp = window_attention_tail(
                xp, att.folded_weight("qkv", rollout_step), att.qkv.bias, groups, ws, num_heads,
                tail=tail,
            )
            if not fuse_attn_tail:
                xp = att.project(xp, rollout_step)
        else:
            out = att(window_partition(xp, ws), num_heads, groups, rollout_step, aimpl,
                      project=not fuse_attn_tail, tail=tail)
            xp = window_reverse(out, ws, Cp, Hp, Wp)
        x = crop_3d(xp, pad).contiguous()
        if shifted:
            x = roll3d(x, ss)

        x = x.reshape(B, C * H * W, D)
        shortcut = shortcut.reshape(B, C * H * W, D)
        if tail_in_kernel:
            pass  # x is already post-residual: the tail ran in the attention kernel
        elif fuse_attn_tail:
            x = linear_adaln_residual(
                x, att.folded_weight("proj", rollout_step), att.proj.bias, shortcut,
                shift1, scale1,
            )
        elif stochastic:
            # Dropout after proj, on the un-windowed tokens: crop and roll commute with an
            # element-wise draw (``swin3d.py:1326-1330``).
            x = dropout(x, self.cfg.drop_rate, k_proj)
            x = shortcut + drop_path(self.norm1(x, c), dp_rate, k_dp1)
        else:
            x = shortcut + self.norm1(x, c)

        m = self.mlp
        if mimpl == "fused":
            shift2, scale2 = self.norm2.shift_scale(c)
            x = mlp_adaln_residual(
                x, m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias, shift2, scale2
            )
        elif stochastic:
            rate = self.cfg.drop_rate
            hidden = dropout(gelu(m.fc1(x)), rate, k_hid)
            y = dropout(m.fc2(hidden), rate, k_out)
            x = x + drop_path(self.norm2(y, c), dp_rate, k_dp2)
        else:
            if mimpl == "pallas":
                y = mlp_fused(x, m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias)
            else:
                y = m(x)
            x = x + self.norm2(y, c)
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


def drop_path_rates(cfg: BackboneConfig) -> tuple[list[tuple], list[tuple]]:
    """The stochastic-depth rate of every block, ``(encoder stages, decoder stages)``: a ramp
    from 0 to ``cfg.drop_path`` over the encoder's blocks, which the decoder's stages slice
    by their own depths (``aurora_tpu/model/swin3d.py:1724-1733``)."""
    assert sum(cfg.encoder_depths) == sum(cfg.decoder_depths)
    dpr = np.linspace(0.0, cfg.drop_path, sum(cfg.encoder_depths))

    def stages(depths):
        ends = np.cumsum((0,) + tuple(depths))
        return [tuple(float(r) for r in dpr[a:b]) for a, b in zip(ends[:-1], ends[1:])]

    return stages(cfg.encoder_depths), stages(cfg.decoder_depths)


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

    def _run_blocks(self, layer, x, c, res, num_heads, rollout_step, rates, key):
        half = tuple(w // 2 for w in self.cfg.window_size)
        for i, block in enumerate(layer.blocks):
            shift = (0, 0, 0) if i % 2 == 0 else half
            k = key.fold(i) if key is not None else None
            x = checkpointed(self.cfg.remat, block, x, c, res, shift, num_heads, rollout_step,
                             rates[i], k)
        return x

    def _run_layer(self, layer, x, c, res, num_heads, rollout_step, rates, key):
        """One stage, rematerialised as a whole under ``remat_scope`` "full" / "no_outer"."""
        cfg = self.cfg
        on = cfg.remat and cfg.remat_scope in ("full", "no_outer")
        return checkpointed(on, self._run_blocks, layer, x, c, res, num_heads, rollout_step,
                            rates, key)

    def forward(self, x, lead_time_encode, rollout_step: int, patch_res,
                key: Optional[DrawKey] = None):
        """``key``: the root of the step's draws for the stochastic knobs (None:
        deterministic), folded with the stage (encoder ``i``, decoder ``100 + i``)."""
        cfg = self.cfg
        enc_rates, dec_rates = drop_path_rates(cfg)
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
            x = self._run_layer(layer, x, c, all_enc_res[i], cfg.encoder_num_heads[i],
                                rollout_step, enc_rates[i], None if key is None else key.fold(i))
            skips.append(x)
            if layer.downsample is not None:
                x = layer.downsample(x, all_enc_res[i])
        for i, layer in enumerate(self.decoder_layers):
            index = n_dec - i - 1
            x = self._run_layer(layer, x, c, all_enc_res[index], cfg.decoder_num_heads[i],
                                rollout_step, dec_rates[i],
                                None if key is None else key.fold(100 + i))
            if layer.upsample is not None:
                x = layer.upsample(x, all_enc_res[index], padded_outs[index - 1])
            if 0 < i < n_dec - 1:
                x = x + skips[index - 1]
            elif i == n_dec - 1:
                x = torch.cat([x, skips[0]], dim=-1)
        return x.reshape(B, L, x.shape[-1])
