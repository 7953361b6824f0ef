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
kernels. Under an entered mesh a rank's masks are its elements of the one-process draw
(:class:`~aurora_tpu_torch.model.nn.DrawPart`): its batch rows and its block of the grid.

LoRA is folded into the weights a kernel reads (the qkv of K2/K6, the proj of an in-kernel
or K5 tail), as the JAX package folds it; every plain projection adds the side path. The
JAX package's fallback from the 5D kernel to the windowed one when no window-row batch fits
the TPU's VMEM budget (``swin3d.py:1253-1260``) has no counterpart on the card: only
``"pallas_windowed"`` reaches K6.

Encoder stages double the feature dim by patch merging, decoder stages halve it by patch
splitting; intermediate skips are additive and the last one a concatenation.

Under a ``(lat, lon)`` mesh (``aurora_tpu/model/swin3d.py:1082-1468``) each rank holds its
block of the token grid (:mod:`~aurora_tpu_torch.parallel.sharding`'s rule) and runs the
same kernels on it: a block over-pads the grid by whole pad-only windows to window x mesh
multiples (``extra``), so that every rank's block of the padded grid is whole windows, and
takes the roll, pad and crop as :mod:`~aurora_tpu_torch.parallel.halo` moves (thin halo
strips over the lines of the mesh); K2 runs on the rank's windows with its slice of the
global group ids, K3 on its tokens; the patch merge brings a 2 x 2 cell that an odd block's
edge cuts to one rank first. The backbone then takes and returns 5D tokens. Every move is
differentiable (its backward the transpose move), so the train steps run under the mesh.

With ``remat`` each block is rematerialised in the backward, and under ``remat_scope``
"full" and "no_outer" each stage too (``aurora_tpu/model/swin3d.py:1585-1586``,
``:1632-1634``, ``:1673-1675``); the whole backbone is wrapped by the model under "full".
"""

from __future__ import annotations

import contextlib
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
    DrawPart,
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
from aurora_tpu_torch.parallel import halo
from aurora_tpu_torch.parallel.mesh import current_mesh
from aurora_tpu_torch.parallel.sharding import spatial_mesh
from aurora_tpu_torch.utils.profiling import span

__all__ = [
    "Backbone",
    "SwinBlock",
    "WindowAttention",
    "maybe_adjust_windows",
    "mesh_kernel_alignment",
    "overpadded",
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


def pad_3d(x: torch.Tensor, pad: tuple[int, int, int],
           extra: tuple[int, int, int] = (0, 0, 0)) -> torch.Tensor:
    """Centre-pad ``(B, C, H, W, D)`` with zeros along (C, H, W); ``extra`` appends that many
    more zero planes, rows and columns after the centre pad (whole pad-only windows where
    each is a multiple of the window: :func:`~aurora_tpu_torch.ops.masks.window_group_ids`)."""
    left, right, top, bottom, front, back = three_sided_padding(*pad)
    return F.pad(x, (0, 0, left, right + extra[2], top, bottom + extra[1], front,
                     back + extra[0]))


def crop_3d(x: torch.Tensor, pad: tuple[int, int, int],
            extra: tuple[int, int, int] = (0, 0, 0)) -> torch.Tensor:
    """Inverse of :func:`pad_3d`."""
    _, C, H, W, _ = x.shape
    left, right, top, bottom, front, back = three_sided_padding(*pad)
    return x[:, front : C - back - extra[0], top : H - bottom - extra[1],
             left : W - right - extra[2], :]


_OVERPAD: list = []  # the (lat, lon) geometry whose over-pad a one-process block applies


@contextlib.contextmanager
def overpadded(lat: int, lon: int):
    """Inside, a block in one process over-pads its grid as a rank's block under a ``(lat,
    lon)`` mesh does (whole pad-only windows to window x mesh multiples, ``extra``): the
    geometry's cost on one device, ``tools.overpad_bench``'s measure. The outputs do not
    change (the pad-only windows are cropped)."""
    _OVERPAD.append((int(lat), int(lon)))
    try:
        yield
    finally:
        _OVERPAD.pop()


def _overpad_extra(H: int, W: int, pad, ws) -> tuple[int, int, int]:
    if not _OVERPAD:
        return (0, 0, 0)
    la, lo = _OVERPAD[-1]
    return (0, (-(H + pad[1])) % (ws[1] * la), (-(W + pad[2])) % (ws[2] * lo))


def mesh_kernel_alignment(mesh_shape: dict, Cp: int, Hp: int, Wp: int, ws) -> bool:
    """True when the window kernels run on each rank's block of the padded grid ``(Cp, Hp,
    Wp)``: every (lat, lon) block holds whole windows (``aurora_tpu/model/swin3d.py:969-993``,
    without the TPU's VMEM fit). The over-padding makes it hold for every grid; a block
    checks it."""
    la, lo = mesh_shape.get("lat", 1), mesh_shape.get("lon", 1)
    return not (Cp % ws[0] or Hp % (ws[1] * la) or Wp % (ws[2] * lo))


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
        draws (None: deterministic). Under a ``(lat, lon)`` mesh ``x`` is the rank's block of
        the ``res`` grid."""
        C, H, W = res
        B, D = x.shape[0], x.shape[-1]
        shape = x.shape
        mesh = spatial_mesh()
        rows = (C, H, W)
        if mesh is not None:
            (a, b), (c0, c1) = halo.local_extents((H, W), mesh)
            rows = (C, b - a, c1 - c0)
        assert tuple(x.shape[1:4]) == rows, f"Wrong grid: {x.shape} vs {res}"
        stochastic = key is not None and (dp_rate > 0.0 or self.cfg.drop_rate > 0.0)
        if stochastic:
            k_dp1, k_dp2, k_proj, k_hid, k_out = (key.fold(j) for j in range(5))
            aimpl, mimpl = "xla", "xla"
            dmesh = current_mesh()
            part = (None if dmesh is None or dmesh.size == 1
                    else _draw_part(B, (C, H, W), rows, dmesh))
        else:
            # Under a mesh the JAX package routes a block whose windows or rows do not
            # split evenly to XLA (``swin3d.py:1178-1230``: the MLP at stage 3's uneven
            # rows, say). The port keeps the route: on the card a per-token kernel runs on
            # any row split and the window kernel on every block of whole windows; on the
            # CPU every route is plain.
            aimpl, mimpl = self.cfg.routes()
        fuse_attn_tail = mimpl == "fused"
        tail_in_kernel = fuse_attn_tail and aimpl in ("pallas", "pallas_windowed")
        att = self.attn

        ws, ss = maybe_adjust_windows(self.cfg.window_size, shift_size, res)
        shortcut = x
        shifted = any(ss)
        if mesh is None:
            if shifted:
                x = roll3d(x, (-ss[0], -ss[1], -ss[2]))
            pad = ((-C) % ws[0], (-H) % ws[1], (-W) % ws[2])
            extra = _overpad_extra(H, W, pad, ws)
            groups = None
            if shifted:
                groups = (window_group_ids(C, H, W, ws, ss, True, extra) if any(extra)
                          else window_group_ids(C, H, W, ws, ss))
            xp = pad_3d(x, pad, extra)
        else:
            geo = halo.window_geometry(res, ws, ss, mesh)
            if not mesh_kernel_alignment(mesh.shape, *geo.padded, ws):
                raise AssertionError(f"the over-padded grid {geo.padded} is not whole windows "
                                     f"{ws} on every block of {mesh.shape}")
            sent = halo.STATS["bytes_sent"]
            xp = halo.enter_windows(x, geo, mesh)
            groups = halo.local_group_ids(geo) if shifted else None
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
        if mesh is None:
            x = crop_3d(xp, pad, extra).contiguous()
            if shifted:
                x = roll3d(x, ss)
        else:
            x = halo.leave_windows(xp, geo, mesh)
            halo.note("block", res=res, shift=ss, extra=geo.extra, rows=rows[1:],
                      padded_block=geo.block, bytes=halo.STATS["bytes_sent"] - sent)

        x = x.reshape(B, -1, D)
        shortcut = shortcut.reshape(B, -1, D)
        if tail_in_kernel:
            pass  # x is already post-residual: the tail ran in the attention kernel
        elif fuse_attn_tail:
            x = linear_adaln_residual(
                x, att.folded_weight("proj", rollout_step), att.proj.bias, shortcut,
                shift1, scale1,
            )
        elif stochastic:
            # Dropout after proj, on the un-windowed tokens: crop and roll commute with an
            # element-wise draw (``swin3d.py:1326-1330``). Under a mesh the rank's tokens
            # take their elements of the one-process draw.
            x = dropout(x, self.cfg.drop_rate, k_proj, part)
            x = shortcut + drop_path(self.norm1(x, c), dp_rate, k_dp1, part)
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
            hidden = dropout(gelu(m.fc1(x)), rate, k_hid, part)
            y = dropout(m.fc2(hidden), rate, k_out, part)
            x = x + drop_path(self.norm2(y, c), dp_rate, k_dp2, part)
        else:
            if mimpl == "pallas":
                y = mlp_fused(x, m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias)
            else:
                y = m(x)
            x = x + self.norm2(y, c)
        return x.reshape(shape)


def _draw_part(B: int, res: tuple[int, int, int], rows: tuple[int, int, int], mesh) -> DrawPart:
    """The part of a stochastic block's one-process draws that this rank takes under
    ``mesh``: batch rows ``[i B, (i + 1) B)`` of ``B d`` (``d`` the ``data`` degree) and its
    ``(lat, lon)`` block of the ``res`` grid."""
    (a, b), (c0, c1) = halo.local_extents(res[1:], mesh)
    assert rows == (res[0], b - a, c1 - c0), (rows, res)
    return DrawPart(B, mesh.shape["data"], mesh.axis_index("data"), tuple(res),
                    ((a, b), (c0, c1)))


class PatchMerge(nn.Module):
    """2x2 spatial merge ``(B, C, H, W, D) -> (B, C, H/2, W/2, 2D)`` (odd H/W are
    centre-padded first). Under a ``(lat, lon)`` mesh ``x`` is the rank's block: the cells
    of its block of the merged grid are brought whole to it first
    (:func:`~aurora_tpu_torch.parallel.halo.merge_rows`; ``aurora_tpu/model/swin3d.py:
    1411-1421``), in the same feature order."""

    def __init__(self, dim: int, *, device=None, dtype=None):
        super().__init__()
        self.norm = LayerNorm(4 * dim, device=device, dtype=dtype)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, res: tuple[int, int, int]) -> torch.Tensor:
        C, H, W = res
        B, D = x.shape[0], x.shape[-1]
        mesh = spatial_mesh()
        if mesh is None:
            x = pad_3d(x, (0, H % 2, W % 2))
        else:
            rows = tuple(x.shape[2:4])
            x = halo.merge_rows(x, res, mesh)
            halo.note("merge", res=res, rows=rows, odd=int(rows[0] % 2 or rows[1] % 2))
        H2, W2 = x.shape[2] // 2, x.shape[3] // 2
        # Feature order (i, j, D) with i the row and j the column offset in the 2x2 cell.
        x = x.reshape(B, C, H2, 2, W2, 2 * D).permute(0, 1, 2, 4, 3, 5)
        x = x.reshape(B, C, H2, W2, 4 * D)
        return self.reduction(self.norm(x))


class PatchSplit(nn.Module):
    """Inverse of :class:`PatchMerge`: ``(B, C, H, W, D) -> (B, C, 2H', 2W', D/2)`` with
    the merge padding cropped away (under a ``(lat, lon)`` mesh on the rank's block, the
    crop a :func:`~aurora_tpu_torch.parallel.halo.split_crop` move)."""

    def __init__(self, dim: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.lin1 = Linear(dim, 2 * dim, bias=False, **kw)
        self.lin2 = Linear(dim // 2, dim // 2, bias=False, **kw)
        self.norm = LayerNorm(dim // 2, **kw)

    def forward(self, x, res, crop) -> torch.Tensor:
        B, C, h, w, D = x.shape
        x = self.lin1(x).reshape(B, C, h, w, 2, D).permute(0, 1, 2, 4, 3, 5)
        x = x.reshape(B, C, 2 * h, 2 * w, D // 2)
        mesh = spatial_mesh()
        x = crop_3d(x, crop) if mesh is None else halo.split_crop(x, res, crop, mesh)
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
        """``x``: tokens ``(B, L, D)``, or 5D ``(B, C, H, W, D)`` (under a ``(lat, lon)`` mesh
        the rank's block of the ``patch_res`` grid), returned in the same form. ``key``: the
        root of the step's draws for the stochastic knobs (None: deterministic), folded with
        the stage (encoder ``i``, decoder ``100 + i``)."""
        cfg = self.cfg
        enc_rates, dec_rates = drop_path_rates(cfg)
        flat_io = x.dim() == 3
        B, D = x.shape[0], x.shape[-1]
        if flat_io:
            L = x.shape[1]
            assert L == patch_res[0] * patch_res[1] * patch_res[2], "Input shape mismatch."
            x = x.reshape(B, *patch_res, D)
        assert patch_res[0] % cfg.window_size[0] == 0
        all_enc_res, padded_outs = get_encoder_specs(cfg, patch_res)
        n_dec = len(cfg.decoder_depths)
        lt = lead_time_encode.to(x.dtype).expand(B, lead_time_encode.shape[-1])
        c = self.time_mlp(lt)
        skips = []
        for i, layer in enumerate(self.encoder_layers):
            with span(f"aurora:backbone.enc{i}"):
                x = self._run_layer(layer, x, c, all_enc_res[i], cfg.encoder_num_heads[i],
                                    rollout_step, enc_rates[i],
                                    None if key is None else key.fold(i))
            skips.append(x)
            if layer.downsample is not None:
                with span(f"aurora:backbone.merge{i}"):
                    x = layer.downsample(x, all_enc_res[i])
        for i, layer in enumerate(self.decoder_layers):
            index = n_dec - i - 1
            with span(f"aurora:backbone.dec{i}"):
                x = self._run_layer(layer, x, c, all_enc_res[index], cfg.decoder_num_heads[i],
                                    rollout_step, dec_rates[i],
                                    None if key is None else key.fold(100 + i))
            if layer.upsample is not None:
                with span(f"aurora:backbone.split{i}"):
                    x = layer.upsample(x, all_enc_res[index], padded_outs[index - 1])
            if 0 < i < n_dec - 1:
                x = x + skips[index - 1]
            elif i == n_dec - 1:
                x = torch.cat([x, skips[0]], dim=-1)
        return x.reshape(B, L, x.shape[-1]) if flat_io else x
