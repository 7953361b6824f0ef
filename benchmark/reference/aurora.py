"""The plain reference of the Aurora forecast step and of its LoRA fine-tune step, in plain
PyTorch, float32 with TF32 off.

Written from the model's equations (Bodnar et al., "A foundation model for the Earth system",
Nature 2025; ``aurora/model/{encoder,swin3d,decoder,perceiver,film,lora}.py`` of
microsoft/aurora), for the released 0.25 degree configuration: no variant hooks, one
Perceiver layer in the level aggregation and de-aggregation, LoRA in mode "single". It reads
its weights from a dict under the measured port's parameter names (Linear weights ``(in,
out)``) that the benchmark makes from the seed, and it imports nothing of the port.

One step, ``Reference.step``:

1. normalise every field by its climatological location and scale;
2. encoder: per-variable patch embeddings (a ``P x P`` patch of each variable and history
   step), the surface tokens plus a learned level encoding and ``LN(MLP(x))``; the
   atmospheric tokens of each pressure level plus its level embedding, aggregated into
   ``latent_levels - 1`` latent levels by a Perceiver layer (queries the learned latents,
   cross-attention over the pressure levels, ``LN1`` then the query residual, then
   ``x + LN2(MLP(x))``); then the position, scale, lead-time and absolute-time embeddings;
3. backbone: a 3D Swin U-Net over (latent level, lat, lon) tokens. A block is
   ``x + FiLM1(LN(attention))`` then ``x + FiLM2(LN(MLP))`` (post-norm; FiLM's shift and
   scale from ``silu(c)`` with ``c = time_mlp(lead time)``); window attention over windows of
   ``window_size``, the grid centre-padded with zeros to whole windows; every second block
   rolled by half a window, with a mask that keeps attention inside the rolled grid's
   regions (the longitude edge joined, so attention wraps round the globe); LoRA on qkv and
   proj as the side path ``(x A^T) B alpha / r``. Stages are joined by patch merging (2 x 2
   tokens, LN, a linear to 2D) and splitting (a linear to 2D, the inverse reshape, the
   merge's pad cropped, LN, a linear); the middle decoder stage adds the first stage's
   output, the last concatenates it;
4. decoder: the pressure levels' embeddings as queries of a Perceiver layer over the latent
   levels (the de-aggregation), per-variable linear heads to ``P x P`` pixels;
5. unnormalise.

``precision``: "f32" (full float32 products, TF32 off: the reference), "tf32" (TF32
products: the control of a float32 configuration), "fp8" (every product's operands rounded to
float8 e4m3 with one scale a tensor: the control of a bfloat16 configuration). Where the
configuration stores the backbone in bfloat16 (``autocast``), its weights are rounded to
bfloat16 here and the products run at ``precision`` on those values.

``Reference.train_step`` is the LoRA fine-tune step: the latitude-unweighted mean absolute
error of the unnormalised fields, averaged over the variables, its gradient with respect to
the adapters only, and AdamW (b1 0.9, b2 0.999, eps 1e-8, no weight decay) computed in
float32, each adapter stored back in its configured dtype. With ``checkpoint=True`` every
Swin block, the level aggregation and each block of :data:`COLUMNS` token columns of the
de-aggregation and its heads are recomputed in the backward, so that the float32 autograd
fits on the card. Blocks of columns change no result: each column is its own computation.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from datetime import timedelta
import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from benchmark.reference import encodings
from benchmark.reference.stats import NORMALISATION_STATS

PRECISIONS = ("f32", "tf32", "fp8")
FP8_MAX = 448.0  # the largest float8 e4m3 value
LN_EPS = 1e-5
COLUMNS = 16384  # token columns a block of the de-aggregation (its memory under autograd)


def level_name(level: float) -> str:
    level = round(float(level), 3)
    return str(int(level) if level % 1 == 0 else level).replace(".", "_")


def stats(name: str, levels=None) -> tuple[np.ndarray, np.ndarray]:
    """Location and scale of a surface variable, or per level of an atmospheric one."""
    if levels is None:
        loc, scale = NORMALISATION_STATS[name]
        return np.float64(loc), np.float64(scale)
    pairs = [NORMALISATION_STATS[f"{name}_{level_name(lv)}"] for lv in levels]
    return np.array([p[0] for p in pairs]), np.array([p[1] for p in pairs])


@contextlib.contextmanager
def products(precision: str):
    """TF32 on for "tf32", off otherwise; the caller's switches restored on exit."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the whole tensor, and back."""
    s = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t * (1 / s)).to(torch.float8_e4m3fn).to(t.dtype).mul_(s)


class _FP8(torch.autograd.Function):
    """A product's operand in float8: rounded in the forward, and its gradient rounded in
    the backward, so that the backward's products take float8 operands too."""

    @staticmethod
    def forward(ctx, t):
        return _round_fp8(t)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    return _FP8.apply(t)


def _layernorm(x, w=None, b=None, eps=LN_EPS):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y if w is None else y * w + b


def _pad_sides(pad: int) -> tuple[int, int]:
    return pad // 2, pad - pad // 2


def _window_regions(C, H, W, ws, ss) -> np.ndarray:
    """Region id of every token of the rolled ``(C, H, W)`` grid: 27 regions by the window
    and shift edges of each axis; along longitude the last two regions of every (level, lat)
    band join the first ones' neighbours, so that attention wraps round the globe."""
    img = np.zeros((C, H, W), dtype=np.int64)
    cuts = [(slice(0, -w), slice(-w, -s), slice(-s, None)) for w, s in zip(ws, ss)]
    n = 0
    for c in cuts[0]:
        for h in cuts[1]:
            for w in cuts[2]:
                img[c, h, w] = n
                n += 1
    for c in range(3):
        for a, b in ((1, 2), (4, 5), (7, 8)):
            img[img == a + 9 * c] = b + 9 * c
    return img


@dataclasses.dataclass
class Step:
    """One step's inputs: unnormalised ``surf {name: (B, T, H, W)}``, ``static {name: (H,
    W)}``, ``atmos {name: (B, T, C, H, W)}`` on the device, the grid, the batch's times (of
    the last history entry), the pressure levels and the roll-out step."""

    surf: dict
    static: dict
    atmos: dict
    lat: np.ndarray
    lon: np.ndarray
    times: tuple
    levels: tuple
    rollout_step: int = 0


class Reference:
    def __init__(self, cfg: dict, weights: dict[str, torch.Tensor], precision: str = "f32",
                 checkpoint: bool = False, dtype: torch.dtype = torch.float32):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
        self.cfg, self.precision, self.checkpoint = cfg, precision, checkpoint
        self.dtype = dtype  # float32; float64 only where a test holds the port to it
        bf16 = bool(cfg.get("autocast", False))
        self.w = {}
        for name, t in weights.items():
            t = t.detach()
            if bf16 and name.startswith("backbone."):
                t = t.to(torch.bfloat16)
            self.w[name] = t.to(dtype)
        self.adapter_dtype = torch.bfloat16 if bf16 else dtype

    # ------------------------------------------------------------------ products
    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            a, b = _fp8(a), _fp8(b)
        return a @ b

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            a, b = _fp8(a), _fp8(b)
        return torch.einsum(eq, a, b)

    def linear(self, x, name: str, bias: bool = True):
        y = self.mm(x, self.w[f"{name}.weight"])
        return y + self.w[f"{name}.bias"] if bias else y

    def mlp(self, x, name: str):
        return self.linear(F.gelu(self.linear(x, f"{name}.fc1")), f"{name}.fc2")

    def ln(self, x, name: str, eps: float = LN_EPS):
        return _layernorm(x, self.w[f"{name}.weight"], self.w[f"{name}.bias"], eps)

    def _ckpt(self, fn, *args):
        if self.checkpoint and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    # ------------------------------------------------------------------ encoder
    def patch_embed(self, x: torch.Tensor, name: str, names) -> torch.Tensor:
        """``x (N, V, T, H, W) -> (N, H/P * W/P, D)``: each patch of every variable and history
        step against that variable's ``(T, P, P, D)`` kernel, plus a bias."""
        N, V, T, H, W = x.shape
        P = self.cfg["patch_size"]
        patches = x.reshape(N, V, T, H // P, P, W // P, P).permute(0, 3, 5, 1, 2, 4, 6)
        patches = patches.reshape(N * (H // P) * (W // P), V * T * P * P)
        k = torch.stack([self.w[f"{name}.weights.{n}"][:T] for n in names])  # (V, T, P, P, D)
        y = self.mm(patches, k.reshape(V * T * P * P, -1))
        return y.reshape(N, (H // P) * (W // P), -1) + self.w[f"{name}.bias"]

    def perceiver(self, queries, ctx, name: str, heads: int):
        """One post-norm Perceiver layer with queries shared by every column: ``queries (Q,
        D)``, context ``(M, K, D)`` -> ``(M, Q, D)``."""
        q = self.mm(queries, self.w[f"{name}.attn.to_q.weight"])  # (Q, inner)
        kv = self.mm(ctx, self.w[f"{name}.attn.to_kv.weight"])
        k, v = kv.chunk(2, dim=-1)
        inner = q.shape[-1]
        dh = inner // heads
        M, K = ctx.shape[:2]
        qh = q.reshape(-1, heads, dh)
        logits = self.einsum("mkhd,qhd->mhqk", k.reshape(M, K, heads, dh), qh) / math.sqrt(dh)
        weights = torch.softmax(logits, dim=-1)
        o = self.einsum("mhqk,mkhd->mqhd", weights, v.reshape(M, K, heads, dh))
        out = self.mm(o.reshape(M, -1, inner), self.w[f"{name}.attn.to_out.weight"])
        lat = self.ln(out, f"{name}.ln1") + queries
        return lat + self.ln(self.mlp(lat, f"{name}.mlp"), f"{name}.ln2")

    def encoder(self, surf, static, atmos, st: Step, enc: dict) -> torch.Tensor:
        cfg = self.cfg
        B, T, H, W = next(iter(surf.values())).shape
        names_s = tuple(surf) + tuple(static)
        xs = torch.stack([surf[k] for k in surf]
                         + [static[k][None, None].expand(B, T, H, W) for k in static], dim=1)
        x_surf = self.patch_embed(xs, "encoder.surf_token_embeds", names_s)  # (B, L, D)
        xa = torch.stack([atmos[k] for k in atmos], dim=1)  # (B, V, T, C, H, W)
        C = xa.shape[3]
        xa = xa.permute(0, 3, 1, 2, 4, 5).reshape(B * C, len(atmos), T, H, W)
        x_atmos = self.patch_embed(xa, "encoder.atmos_token_embeds", tuple(atmos))
        L, D = x_surf.shape[1:]
        x_atmos = x_atmos.reshape(B, C, L, D)

        x_surf = x_surf + self.w["encoder.surf_level_encoding"]
        x_surf = x_surf + self.ln(self.mlp(x_surf, "encoder.surf_mlp"), "encoder.surf_norm")
        lev = self.linear(enc["levels"], "encoder.atmos_levels_embed")  # (C, D)
        x_atmos = x_atmos + lev[None, :, None]
        ctx = x_atmos.permute(0, 2, 1, 3).reshape(B * L, C, D)
        agg = self._ckpt(self.perceiver, self.w["encoder.atmos_latents"], ctx,
                         "encoder.level_agg.layers.0", cfg["num_heads"])  # (B L, Cl - 1, D)
        x_atmos = agg.reshape(B, L, -1, D).permute(0, 2, 1, 3)
        x = torch.cat((x_surf[:, None], x_atmos), dim=1)
        x = x + self.linear(enc["pos"], "encoder.pos_embed")[None, None]
        x = x + self.linear(enc["scale"], "encoder.scale_embed")[None, None]
        x = x.reshape(B, -1, D)
        x = x + self.linear(enc["lead_time"], "encoder.lead_time_embed")[None, None]
        return x + self.linear(enc["absolute_time"], "encoder.absolute_time_embed")[:, None]

    # ------------------------------------------------------------------ backbone
    def lora(self, x, name: str, step: int):
        cfg = self.cfg
        if step >= cfg["lora_steps"]:
            return 0.0
        a = self.w[f"{name}.A"][0]  # (r, in)
        b = self.w[f"{name}.B"][0]  # (r, out)
        return self.mm(self.mm(x, a.T), b) * (cfg["lora_alpha"] / cfg["lora_r"])

    def proj(self, x, name: str, lora: str, step: int):
        return self.linear(x, name) + self.lora(x, lora, step)

    def film(self, x, c, name: str):
        shift, scale = self.linear(F.silu(c), f"{name}.modulation").chunk(2, dim=-1)
        shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
        return _layernorm(x) * scale.reshape(shape) + shift.reshape(shape)

    def attention(self, x, name: str, res, shift, heads: int, step: int):
        """Window attention of ``x (B, C, H, W, D)``, the tokens back in place before proj."""
        cfg = self.cfg
        C, H, W = res
        ws = tuple(cfg["window_size"])
        ws = tuple(min(w, r) for w, r in zip(ws, res))
        ss = tuple(0 if r <= w else s for w, s, r in zip(cfg["window_size"], shift, res))
        shifted = any(ss)
        B, D = x.shape[0], x.shape[-1]
        if shifted:
            x = torch.roll(x, shifts=tuple(-s for s in ss), dims=(1, 2, 3))
        pads = [(-n) % w for n, w in zip(res, ws)]
        (f0, f1), (t0, t1), (l0, l1) = (_pad_sides(p) for p in pads)
        xp = F.pad(x, (0, 0, l0, l1, t0, t1, f0, f1))
        Cp, Hp, Wp = xp.shape[1:4]
        nw = (Cp // ws[0], Hp // ws[1], Wp // ws[2])
        N = ws[0] * ws[1] * ws[2]
        win = xp.reshape(B, nw[0], ws[0], nw[1], ws[1], nw[2], ws[2], D)
        win = win.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, N, D)
        qkv = self.proj(win, f"{name}.qkv", f"{name}.lora_qkv", step)
        q, k, v = (t.reshape(t.shape[0], N, heads, D // heads).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        logits = self.einsum("whqd,whkd->whqk", q, k) / math.sqrt(D // heads)
        if shifted:
            ids = np.pad(_window_regions(C, H, W, ws, ss), ((f0, f1), (t0, t1), (l0, l1)),
                         constant_values=27)
            ids = ids.reshape(nw[0], ws[0], nw[1], ws[1], nw[2], ws[2])
            ids = torch.as_tensor(ids.transpose(0, 2, 4, 1, 3, 5).reshape(-1, N),
                                  device=x.device)
            mask = torch.where(ids[:, :, None] == ids[:, None, :], 0.0, -100.0)
            logits = logits + mask.repeat(B, 1, 1)[:, None]
        o = self.einsum("whqk,whkd->whqd", torch.softmax(logits, dim=-1), v)
        o = o.transpose(1, 2).reshape(B, *nw, *ws, D).permute(0, 1, 4, 2, 5, 3, 6, 7)
        o = o.reshape(B, Cp, Hp, Wp, D)[:, f0:Cp - f1, t0:Hp - t1, l0:Wp - l1]
        if shifted:
            o = torch.roll(o, shifts=ss, dims=(1, 2, 3))
        return o

    def block(self, x, c, name: str, res, shift, heads: int, step: int):
        att = self.attention(x, f"{name}.attn", res, shift, heads, step)
        att = self.proj(att, f"{name}.attn.proj", f"{name}.attn.lora_proj", step)
        x = x + self.film(att, c, f"{name}.norm1")
        return x + self.film(self.mlp(x, f"{name}.mlp"), c, f"{name}.norm2")

    def merge(self, x, name: str):
        B, C, H, W, D = x.shape
        (t0, t1), (l0, l1) = _pad_sides(H % 2), _pad_sides(W % 2)
        x = F.pad(x, (0, 0, l0, l1, t0, t1))
        H2, W2 = x.shape[2] // 2, x.shape[3] // 2
        x = x.reshape(B, C, H2, 2, W2, 2 * D).permute(0, 1, 2, 4, 3, 5)
        x = x.reshape(B, C, H2, W2, 4 * D)
        return self.linear(self.ln(x, f"{name}.norm"), f"{name}.reduction", bias=False)

    def split(self, x, name: str, crop):
        B, C, h, w, D = x.shape
        x = self.linear(x, f"{name}.lin1", bias=False).reshape(B, C, h, w, 2, D)
        x = x.permute(0, 1, 2, 4, 3, 5).reshape(B, C, 2 * h, 2 * w, D // 2)
        (t0, t1), (l0, l1) = _pad_sides(crop[1]), _pad_sides(crop[2])
        x = x[:, :, t0:2 * h - t1, l0:2 * w - l1]
        return self.linear(self.ln(x, f"{name}.norm"), f"{name}.lin2", bias=False)

    def backbone(self, x, lead, patch_res, step: int):
        cfg = self.cfg
        B, _, D = x.shape
        x = x.reshape(B, *patch_res, D)
        res = [tuple(patch_res)]
        pads = []
        for _ in range(1, len(cfg["encoder_depths"])):
            C, H, W = res[-1]
            pads.append((0, H % 2, W % 2))
            res.append((C, (H + H % 2) // 2, (W + W % 2) // 2))
        half = tuple(w // 2 for w in cfg["window_size"])
        t = lead.expand(B, -1)
        c = self.linear(F.silu(self.linear(t, "backbone.time_mlp.fc1")),
                        "backbone.time_mlp.fc2")

        def stage(x, name, depth, r, heads):
            for i in range(depth):
                shift = (0, 0, 0) if i % 2 == 0 else half
                x = self._ckpt(self.block, x, c, f"{name}.blocks.{i}", r, shift, heads, step)
            return x

        skips = []
        n = len(cfg["encoder_depths"])
        for i in range(n):
            name = f"backbone.encoder_layers.{i}"
            x = stage(x, name, cfg["encoder_depths"][i], res[i], cfg["encoder_num_heads"][i])
            skips.append(x)
            if i < n - 1:
                x = self.merge(x, f"{name}.downsample")
        for i in range(n):
            j = n - i - 1
            name = f"backbone.decoder_layers.{i}"
            x = stage(x, name, cfg["decoder_depths"][i], res[j], cfg["decoder_num_heads"][i])
            if i < n - 1:
                x = self.split(x, f"{name}.upsample", pads[j - 1])
            if 0 < i < n - 1:
                x = x + skips[j - 1]
            elif i == n - 1:
                x = torch.cat([x, skips[0]], dim=-1)
        return x.reshape(B, -1, x.shape[-1])

    # ------------------------------------------------------------------ decoder
    def heads(self, x, group: str, names) -> torch.Tensor:
        w = torch.stack([self.w[f"decoder.{group}.{n}.weight"] for n in names], dim=-1)
        b = torch.stack([self.w[f"decoder.{group}.{n}.bias"] for n in names], dim=-1)
        return self.mm(x, w.reshape(w.shape[0], -1)) + b.reshape(-1)

    def unpatchify(self, x, V: int, H: int, W: int) -> torch.Tensor:
        """``(B, L, C, P P V)`` in (p_h, p_w, v) order -> ``(B, V, C, H, W)``."""
        P = self.cfg["patch_size"]
        B, _, C, _ = x.shape
        x = x.reshape(B, H // P, W // P, C, P, P, V).permute(0, 6, 3, 1, 4, 2, 5)
        return x.reshape(B, V, C, H, W)

    def decoder(self, x, surf_names, atmos_names, enc: dict, patch_res, H: int, W: int):
        cfg = self.cfg
        B, _, D = x.shape
        Cl = patch_res[0]
        x = x.reshape(B, Cl, -1, D)
        L = x.shape[2]
        surf = self.unpatchify(self.heads(x[:, 0][:, :, None], "surf_heads", surf_names),
                               len(surf_names), H, W)[:, :, 0]
        lev = self.linear(enc["levels_dec"], "decoder.atmos_levels_embed")  # (C_A, D)
        ctx = x[:, 1:].permute(0, 2, 1, 3).reshape(B * L, Cl - 1, D)

        def columns(c):  # the de-aggregation and the heads of a block of token columns
            out = self.perceiver(lev, c, "decoder.level_decoder.layers.0", cfg["num_heads"])
            return self.heads(out, "atmos_heads", atmos_names)

        rows = torch.cat([self._ckpt(columns, c) for c in ctx.split(COLUMNS)])
        atmos = self.unpatchify(rows.reshape(B, L, *rows.shape[1:]), len(atmos_names), H, W)
        return ({n: surf[:, i] for i, n in enumerate(surf_names)},
                {n: atmos[:, i] for i, n in enumerate(atmos_names)})

    # ------------------------------------------------------------------ the step
    def encodings(self, st: Step, device) -> dict:
        cfg = self.cfg
        D = cfg["embed_dim"]
        pos, scale = encodings.pos_scale(D, st.lat, st.lon, cfg["patch_size"])
        host = dict(pos=pos, scale=scale, levels=encodings.levels(st.levels, D),
                    levels_dec=encodings.levels(st.levels, 2 * D),
                    lead_time=encodings.lead_time(cfg["timestep_hours"], D),
                    absolute_time=encodings.absolute_time(st.times, D))
        return {k: torch.as_tensor(v, device=device).to(self.dtype) for k, v in host.items()}

    def step(self, st: Step):
        """One forecast step: unnormalised ``surf {name: (B, H, W)}``, ``atmos {name: (B, C,
        H, W)}`` one timestep after ``st``."""
        cfg = self.cfg
        device = next(iter(st.surf.values())).device
        B, T, H, W = next(iter(st.surf.values())).shape
        P = cfg["patch_size"]
        patch_res = (cfg["latent_levels"], H // P, W // P)

        def tensor(a):
            return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=device)

        def norm(v, loc, scale):
            return (v - loc) / scale

        surf = {k: norm(v, *map(float, stats(k))) for k, v in st.surf.items()}
        static = {k: norm(v, *map(float, stats(k))) for k, v in st.static.items()}
        atmos = {}
        for k, v in st.atmos.items():
            loc, scale = stats(k, st.levels)
            atmos[k] = norm(v, tensor(loc)[:, None, None], tensor(scale)[:, None, None])
        with products(self.precision):
            enc = self.encodings(st, device)
            x = self.encoder(surf, static, atmos, st, enc)
            x = self.backbone(x, enc["lead_time"], patch_res, st.rollout_step)
            surf_p, atmos_p = self.decoder(x, tuple(surf), tuple(atmos), enc, patch_res, H, W)
        out_s = {k: v * float(stats(k)[1]) + float(stats(k)[0]) for k, v in surf_p.items()}
        out_a = {}
        for k, v in atmos_p.items():
            loc, scale = stats(k, st.levels)
            out_a[k] = v * tensor(scale)[:, None, None] + tensor(loc)[:, None, None]
        return out_s, out_a

    # ------------------------------------------------------------------ training
    def adapters(self) -> list[str]:
        return sorted(n for n in self.w if ".lora_" in n)

    def train_step(self, st: Step, tgt_surf, tgt_atmos, state: dict, lr: float) -> dict:
        """One LoRA fine-tune step on ``st`` against the targets (unnormalised, ``(B, H, W)``
        / ``(B, C, H, W)``). ``state`` holds the AdamW moments and the step count and is
        updated, as are the adapters in ``self.w``. Returns the loss, the gradients and the
        adapters' values after the update."""
        names = self.adapters()
        for n in names:
            self.w[n] = self.w[n].detach().requires_grad_(True)
        with torch.enable_grad():
            surf, atmos = self.step(st)
            errs = [(surf[k] - tgt_surf[k]).abs().mean() for k in surf]
            errs += [(atmos[k] - tgt_atmos[k]).abs().mean() for k in atmos]
            loss = torch.stack(errs).mean()
            grads = torch.autograd.grad(loss, [self.w[n] for n in names])
        t = state.get("t", 0) + 1
        state["t"] = t
        b1, b2, eps = 0.9, 0.999, 1e-8
        out = {}
        with torch.no_grad():
            for n, g in zip(names, grads):
                m = state.setdefault(f"m.{n}", torch.zeros_like(g))
                v = state.setdefault(f"v.{n}", torch.zeros_like(g))
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v / (1 - b2**t)).sqrt() + eps
                p = self.w[n].detach() - lr * (m / (1 - b1**t)) / denom
                self.w[n] = p.to(self.adapter_dtype).to(self.dtype)
                out[n] = self.w[n]
        return dict(loss=float(loss.detach()), grads=dict(zip(names, grads)), params=out)


def next_step(st: Step, pred_surf, pred_atmos, timestep_hours: float) -> Step:
    """The step after ``st``: the prediction appended to the history, its oldest entry
    dropped, the time one timestep later."""
    return dataclasses.replace(
        st,
        surf={k: torch.cat([v[:, 1:], pred_surf[k][:, None]], dim=1) for k, v in st.surf.items()},
        atmos={k: torch.cat([v[:, 1:], pred_atmos[k][:, None]], dim=1)
               for k, v in st.atmos.items()},
        times=tuple(t + timedelta(hours=timestep_hours) for t in st.times),
        rollout_step=st.rollout_step + 1,
    )
