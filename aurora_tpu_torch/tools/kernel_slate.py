"""Are the patch embedding and the patch merge / split at their floors on the card?

Counterpart of ``tools/kernel_slate.py``, with its labels. Times four parts of the 1.3 B
model at its 720 x 1440 shapes (batch 1, two history steps, 13 levels), each the port's own
module on seeded random inputs, against the card's floor for the same work:

  patch-embed surf (7 vars)               the encoder's surface embedding (4 surface and 3
                                          static variables): one strided convolution, float32
  patch-embed atmos (5 vars x 13 levels)  the atmospheric embedding of every level as the
                                          encoder runs it (levels into the batch), float32
  patch-merge s0->s1                      stage 0's 2 x 2 merge into stage 1, bf16 (the
                                          production backbone's dtype)
  patch-split s1->s0                      stage 1's split back to stage 0's grid, bf16

The floor is ``max(flops / peak, bytes / 3.35 TB/s)`` with the flops and bytes the JAX tool
counts (``tools/kernel_slate.py:92-151``: the embedding as a product of every token's
``V T P^2`` inputs into D, each input and output once; the merge's reduction and the split's
two products, input and output once) and the peak of the dtype: 67 TF/s for the float32
embeddings (the model's step runs them with TF32 off), 989 TF/s for bf16. Times:
``tools.time_ms`` (CUDA events on the card, the host clock on the CPU), medians of
``--steps`` runs after warm-up, TF32 off. Each row carries its floor's share of the time
(``of_floor``) and the kernel launches of one call (none: the convolution and the products are
PyTorch's, as they are XLA's in the JAX package).

Usage: ``python -m aurora_tpu_torch.tools.kernel_slate [--device cpu] [--steps N]
[--H 720 --W 1440]``; ``--device cpu --H 48 --W 96`` is the JAX tool's ``--cpu`` grid.
``main(argv, cfg=...)`` takes another config (default ``LARGE_CONFIG``).
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional

import torch

from aurora_tpu_torch.model.config import LARGE_CONFIG, AuroraConfig
from aurora_tpu_torch.model.patchembed import LevelPatchEmbed
from aurora_tpu_torch.model.swin3d import PatchMerge, PatchSplit
from aurora_tpu_torch.tools import card_line, report, resolve_device, result
from aurora_tpu_torch.tools.perf_breakdown import time_parts

__all__ = ["main", "slate_inputs", "slate_labels", "slate_parts", "slate_work"]

C_A, T = 13, 2  # levels and history steps of the main path


def slate_labels(cfg: AuroraConfig) -> list[str]:
    """The four parts' labels, the JAX tool's."""
    Vs, Va = len(cfg.surf_vars) + len(cfg.static_vars), len(cfg.atmos_vars)
    return [f"patch-embed surf ({Vs} vars)", f"patch-embed atmos ({Va} vars x {C_A} levels)",
            "patch-merge s0->s1", "patch-split s1->s0"]


def slate_work(cfg: AuroraConfig, H: int, W: int, B: int = 1) -> dict[str, tuple]:
    """``{label: (flops, bytes, float32)}``: each part's work as the JAX tool counts it (its
    bytes at 4 a value for the float32 embeddings, 2 for the bf16 merge and split)."""
    P, D = cfg.patch_size, cfg.embed_dim
    Hp, Wp = H // P, W // P
    Vs, Va = len(cfg.surf_vars) + len(cfg.static_vars), len(cfg.atmos_vars)
    L0 = cfg.latent_levels * Hp * Wp  # stage 0's tokens
    L1 = cfg.latent_levels * (Hp // 2) * (Wp // 2)  # stage 1's
    work = [
        (2 * B * Hp * Wp * (Vs * T * P * P) * D,
         (B * T * Vs * H * W + B * Hp * Wp * D) * 4, True),
        (2 * B * C_A * Hp * Wp * (Va * T * P * P) * D,
         (B * T * Va * C_A * H * W + B * C_A * Hp * Wp * D) * 4, True),
        (2 * B * (L0 // 4) * (4 * D) * (2 * D), (B * L0 * D + B * (L0 // 4) * 2 * D) * 2, False),
        (2 * B * L1 * (2 * D) * (4 * D) + 2 * B * 4 * L1 * D * D // 2,
         (B * L1 * 2 * D + B * 4 * L1 * D) * 2, False),
    ]
    return dict(zip(slate_labels(cfg), work))


def slate_inputs(cfg: AuroraConfig, H: int, W: int, device, gen: torch.Generator, B: int = 1,
                 embed_dtype: torch.dtype = torch.float32,
                 shuffle_dtype: torch.dtype = torch.bfloat16) -> dict:
    """The four parts' modules (weights N(0, 0.02), LayerNorm affines 1 + N(0, 0.02) and
    N(0, 0.02)) and random inputs on ``device``: the embeddings in ``embed_dtype``, the
    merge and split in ``shuffle_dtype``. The surface stack is ``(B, Vs, T, H, W)``, the
    atmospheric ``(B, Va, T, C_A, H, W)`` (the JAX tool's layouts), the merge's input stage
    0's ``(B, C_l, H/P, W/P, D)`` grid and the split's stage 1's ``(B, C_l, H/2P, W/2P, 2D)``."""
    P, D = cfg.patch_size, cfg.embed_dim
    Hp, Wp = H // P, W // P
    surf = tuple(cfg.surf_vars) + tuple(cfg.static_vars)
    atmos = tuple(cfg.atmos_vars)

    def rn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=device, dtype=torch.float32).to(dtype)

    def seeded(m: torch.nn.Module, dtype) -> torch.nn.Module:
        with torch.no_grad():
            for name, p in m.named_parameters():
                p.copy_(0.02 * rn(*p.shape, dtype=p.dtype) + (name.endswith("norm.weight")))
        return m.to(dtype)

    kw = dict(device=device, dtype=torch.float32)
    return dict(
        surf_names=surf, atmos_names=atmos,
        surf_embed=seeded(LevelPatchEmbed(surf, P, D, T, **kw), embed_dtype),
        atmos_embed=seeded(LevelPatchEmbed(atmos, P, D, T, **kw), embed_dtype),
        merge=seeded(PatchMerge(D, **kw), shuffle_dtype),
        split=seeded(PatchSplit(2 * D, **kw), shuffle_dtype),
        surf_stack=rn(B, len(surf), T, H, W, dtype=embed_dtype),
        atmos_stack=rn(B, len(atmos), T, C_A, H, W, dtype=embed_dtype),
        merge_res=(cfg.latent_levels, Hp, Wp),
        merge_x=rn(B, cfg.latent_levels, Hp, Wp, D, dtype=shuffle_dtype),
        split_res=(cfg.latent_levels, Hp // 2, Wp // 2),
        split_x=rn(B, cfg.latent_levels, Hp // 2, Wp // 2, 2 * D, dtype=shuffle_dtype),
    )


def slate_parts(cfg: AuroraConfig, inputs: dict) -> dict[str, Callable[[], object]]:
    """The four parts on ``inputs`` (:func:`slate_inputs`), under :func:`slate_labels`, each a
    callable of no arguments."""
    i = inputs
    labels = slate_labels(cfg)

    def embed_atmos():  # (B, V, T, C, H, W) -> (B, C, L, D), the levels into the batch
        x = i["atmos_stack"]
        B, V, T_, C, H, W = x.shape
        xa = x.permute(0, 3, 1, 2, 4, 5).reshape(B * C, V, T_, H, W)
        return i["atmos_embed"](xa, i["atmos_names"]).reshape(B, C, -1, cfg.embed_dim)

    parts = {
        labels[0]: lambda: i["surf_embed"](i["surf_stack"], i["surf_names"]),
        labels[1]: embed_atmos,
        labels[2]: lambda: i["merge"](i["merge_x"], i["merge_res"]),
        labels[3]: lambda: i["split"](i["split_x"], i["split_res"], (0, 0, 0)),
    }
    return {k: torch.no_grad()(f) for k, f in parts.items()}


def main(argv=None, *, cfg: Optional[AuroraConfig] = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="the card unless 'cpu' is given")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--H", type=int, default=720)
    ap.add_argument("--W", type=int, default=1440)
    args = ap.parse_args(argv)
    cfg = cfg or LARGE_CONFIG
    dev = resolve_device(args.device)
    print(f"device {card_line(dev)}; grid {args.H}x{args.W}, D={cfg.embed_dim}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = slate_inputs(cfg, args.H, args.W, dev, gen)
    timed = time_parts(slate_parts(cfg, inputs), dev, args.steps)
    del inputs
    rows = []
    for t, (label, (flops, nbytes, f32)) in zip(timed, slate_work(cfg, args.H, args.W).items()):
        r = result(label, t["ms"], dev, flops=flops, nbytes=nbytes, f32=f32,
                   launches=t["launches"], flops_counted=flops, bytes_counted=nbytes)
        r["of_floor"] = r["bound_ms"] / r["ms"]
        rows.append(report(r))
    return rows


if __name__ == "__main__":
    main()
