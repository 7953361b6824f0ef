"""The products (floating-point operations, 2 a multiply-add) and bytes of each part of an
Aurora step, counted from the configuration's shapes as the model's equations define the
work (``benchmark/reference/aurora.py``), whatever implements it.

* :func:`forward`: one forecast step, by part (``encoder``, ``backbone``, ``decoder``). The
  window attention counts the padded windows (the pad tokens are keys and values of the
  algorithm); the projections after it count the real tokens only. LoRA counts as its side
  path ``(x A^T) B``; the level aggregation and de-aggregation count their keys and values
  for every level and column.
* :func:`train_backward`: the backward of the LoRA fine-tune step, the products that the
  input gradients and the adapters' gradients need and nothing more: no gradient of a frozen
  weight, none of the encoder (nothing before the backbone needs one), none of the FiLM
  context (it depends on the lead time alone), no recomputation.
* :func:`backbone_bytes`: the backbone's tokens read once and written once and its weights
  read once, in their stored dtypes.

Every count is a Python integer.
"""

from __future__ import annotations

import math


def _grid(cfg: dict, H: int, W: int) -> tuple[int, int, int]:
    P = cfg["patch_size"]
    return cfg["latent_levels"], H // P, W // P


def stage_res(cfg: dict, H: int, W: int) -> list[tuple[int, int, int]]:
    res = [_grid(cfg, H, W)]
    for _ in range(1, len(cfg["encoder_depths"])):
        C, h, w = res[-1]
        res.append((C, (h + h % 2) // 2, (w + w % 2) // 2))
    return res


def _windows(cfg: dict, res) -> tuple[int, int]:
    """``(padded tokens, tokens a window)`` of a block at ``res``."""
    ws = [min(w, r) for w, r in zip(cfg["window_size"], res)]
    padded = math.prod(r + (-r) % w for r, w in zip(res, ws))
    return padded, math.prod(ws)


def _lora(M: int, d_in: int, d_out: int, r: int) -> int:
    return 2 * M * d_in * r + 2 * M * r * d_out


def _perceiver(Q: int, M: int, K: int, D: int, hidden: int) -> dict[str, int]:
    inner = D
    return dict(to_q=2 * Q * D * inner, to_kv=2 * M * K * D * 2 * inner,
                logits=2 * M * Q * K * inner, mix=2 * M * Q * K * inner,
                to_out=2 * M * Q * inner * D, mlp=4 * M * Q * D * hidden)


def _blocks(cfg: dict, H: int, W: int, B: int):
    """Every Swin block as ``(stage name, index, res, dim, heads)``, encoder then decoder."""
    res = stage_res(cfg, H, W)
    D, n = cfg["embed_dim"], len(cfg["encoder_depths"])
    for i in range(n):
        for b in range(cfg["encoder_depths"][i]):
            yield "encoder", i, b, res[i], D * 2**i, cfg["encoder_num_heads"][i]
    for i in range(n):
        j = n - i - 1
        for b in range(cfg["decoder_depths"][i]):
            yield "decoder", i, b, res[j], D * 2**j, cfg["decoder_num_heads"][i]


def _block(cfg: dict, res, d: int, B: int) -> dict[str, int]:
    Tp, N = _windows(cfg, res)
    Tp, T = B * Tp, B * math.prod(res)
    r, D = cfg["lora_r"], cfg["embed_dim"]
    hidden = int(d * cfg["mlp_ratio"])
    return dict(film=2 * 2 * B * D * 2 * d, qkv=2 * Tp * d * 3 * d, lora_qkv=_lora(Tp, d, 3 * d, r),
                core=4 * Tp * N * d, proj=2 * T * d * d, lora_proj=_lora(T, d, d, r),
                mlp=4 * T * d * hidden)


def forward(cfg: dict, H: int, W: int, levels: int, B: int = 1, T: int = 2) -> dict[str, int]:
    """Products of one step by part, on the cropped ``H x W`` grid with ``levels`` pressure
    levels, batch ``B`` and history ``T``."""
    P, D = cfg["patch_size"], cfg["embed_dim"]
    Cl, h, w = _grid(cfg, H, W)
    L = h * w
    Vs = len(cfg["surf_vars"]) + len(cfg["static_vars"])
    Va = len(cfg["atmos_vars"])
    hid = int(D * cfg["mlp_ratio"])
    enc = (2 * B * L * Vs * T * P * P * D + 2 * B * levels * L * Va * T * P * P * D
           + 4 * B * L * D * hid + 2 * levels * D * D
           + sum(_perceiver(Cl - 1, B * L, levels, D, hid).values())
           + 2 * 2 * L * D * D + 2 * D * D + 2 * B * D * D)

    res = stage_res(cfg, H, W)
    n = len(cfg["encoder_depths"])
    bb = 4 * B * D * D  # the time MLP
    for _, _, _, r, d, _ in _blocks(cfg, H, W, B):
        bb += sum(_block(cfg, r, d, B).values())
    for i in range(n - 1):  # patch merges
        C, hh, ww = res[i]
        d = D * 2**i
        bb += 2 * B * C * ((hh + 1) // 2) * ((ww + 1) // 2) * 4 * d * 2 * d
    for i in range(n - 1):  # patch splits of decoder stages 0 .. n-2
        j = n - i - 1
        d = D * 2**j
        bb += 2 * B * math.prod(res[j]) * d * 2 * d + 2 * B * math.prod(res[j - 1]) * (d // 2) ** 2

    D2 = 2 * D
    hid2 = int(D2 * cfg["dec_mlp_ratio"])
    dec = (2 * B * L * D2 * P * P * len(cfg["surf_vars"]) + 2 * levels * D2 * D2
           + sum(_perceiver(levels, B * L, Cl - 1, D2, hid2).values())
           + 2 * B * L * levels * D2 * P * P * Va)
    return dict(encoder=enc, backbone=bb, decoder=dec)


def train_backward(cfg: dict, H: int, W: int, levels: int, B: int = 1) -> int:
    """Products of the LoRA fine-tune step's backward (module docstring)."""
    P, D = cfg["patch_size"], cfg["embed_dim"]
    Cl, h, w = _grid(cfg, H, W)
    L = h * w
    r = cfg["lora_r"]
    total = 0
    for stage, i, b, res, d, _ in _blocks(cfg, H, W, B):
        k = _block(cfg, res, d, B)
        Tp, _ = _windows(cfg, res)
        Tp *= B
        first = stage == "encoder" and i == 0 and b == 0  # its input needs no gradient
        total += 0 if first else k["qkv"]  # dX of qkv
        # dB, d(x A^T) and dA of each adapter, and dX through A where the input needs it.
        total += 2 * Tp * r * 3 * d + 2 * Tp * 3 * d * r + 2 * Tp * r * d
        total += 0 if first else 2 * Tp * r * d
        total += 2 * k["core"] + k["proj"] + 2 * k["lora_proj"] + k["mlp"]
    res = stage_res(cfg, H, W)
    n = len(cfg["encoder_depths"])
    for i in range(n - 1):
        C, hh, ww = res[i]
        d = D * 2**i
        total += 2 * B * C * ((hh + 1) // 2) * ((ww + 1) // 2) * 4 * d * 2 * d
    for i in range(n - 1):
        j = n - i - 1
        d = D * 2**j
        total += 2 * B * math.prod(res[j]) * d * 2 * d + 2 * B * math.prod(res[j - 1]) * (d // 2) ** 2
    D2 = 2 * D
    p = _perceiver(levels, B * L, Cl - 1, D2, int(D2 * cfg["dec_mlp_ratio"]))
    total += p["to_kv"] + p["logits"] + 2 * p["mix"] + p["to_out"] + p["mlp"]
    total += 2 * B * L * D2 * P * P * len(cfg["surf_vars"])
    total += 2 * B * L * levels * D2 * P * P * len(cfg["atmos_vars"])
    return total


def backbone_params(cfg: dict) -> int:
    D, r = cfg["embed_dim"], cfg["lora_r"]
    n = len(cfg["encoder_depths"])
    total = 2 * (D * D + D)  # the time MLP
    for i in range(n):
        for depth, d in ((cfg["encoder_depths"][i], D * 2**i),
                         (cfg["decoder_depths"][i], D * 2 ** (n - i - 1))):
            hid = int(d * cfg["mlp_ratio"])
            block = (d * 3 * d + 3 * d + d * d + d + r * (d + 3 * d + d + d)
                     + 2 * (D * 2 * d + 2 * d) + d * hid + hid + hid * d + d)
            total += depth * block
    for i in range(n - 1):
        d = D * 2**i
        total += 2 * 4 * d + 4 * d * 2 * d  # merge
        d = D * 2 ** (i + 1)
        total += d * 2 * d + (d // 2) ** 2 + 2 * (d // 2)  # split
    return total


def backbone_bytes(cfg: dict, H: int, W: int, B: int = 1, act_bytes: int = 4,
                   weight_bytes: int = 4) -> int:
    """The backbone's input tokens read once, its output (twice the width) written once and
    its weights read once."""
    Cl, h, w = _grid(cfg, H, W)
    D = cfg["embed_dim"]
    tokens = B * Cl * h * w
    return tokens * D * act_bytes + tokens * 2 * D * act_bytes + backbone_params(cfg) * weight_bytes
