"""Encoder timing at the main path's width: where does the encoder's time go on the card?

Counterpart of ``tools/encoder_breakdown.py``, with its labels. Times the parts of the
production model's :class:`~aurora_tpu_torch.model.encoder.Encoder` (as
:mod:`~aurora_tpu_torch.tools.perf_breakdown` builds it) on seeded random inputs of the
shapes the step gives them, against the whole encoder:

  encoder FULL                the encoder on 4 surface, 3 static and 5 x 13-level inputs
  surf patch embed (7ch)      the surface patch embedding (4 surface + 3 static variables)
  atmos patch embed (13 lvl)  the atmospheric patch embedding of the 13 levels
  level aggregation           13 levels to the latent levels: K4, then K3 (the MLP half)
  surf MLP chain              x + LN(MLP(x)) of the surface level
  pos+scale adds              the position and scale embeddings added to every level

Every row carries the kernel launches of one call of its part. The JAX tool's note that
part of each time is the round trip to a remote TPU does not apply here. Times:
``tools.time_ms`` (CUDA events on the card, the host clock on the CPU), medians of
``--steps`` runs after warm-up.

Usage: ``python -m aurora_tpu_torch.tools.encoder_breakdown [--device cpu] [--steps N]
[--H 720 --W 1440]``. The JAX tool fixes the grid at 720 x 1440; here it is a flag, so a
test can run the tool small. ``main(argv, cfg=...)`` takes another config,
``main(argv, model=...)`` a model already built.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from aurora_tpu_torch.model.aurora import Aurora
from aurora_tpu_torch.model.config import AuroraConfig
from aurora_tpu_torch.model.encoder import EncoderEncodings
from aurora_tpu_torch.tools import card_line, report
from aurora_tpu_torch.tools.perf_breakdown import LEVELS, time_parts, tool_args, tool_model


def encoder_inputs(model: Aurora, H: int, W: int, gen: torch.Generator, B: int = 1,
                   T: int = 2, C_A: int = len(LEVELS)) -> dict:
    """Random float32 inputs of every part on the model's device: the encoder's variables
    and encodings, the patch embeddings' stacks, the aggregation's ``(B, C_A, L, D)`` tokens,
    the surface level's ``(B, L, D)`` and the latent levels' ``(B, C_l, L, D)``."""
    cfg = model.cfg
    P, D = cfg.patch_size, cfg.embed_dim
    L = (H // P) * (W // P)
    dev, f32 = model.device, torch.float32

    def rn(*shape, positive=False):
        x = torch.randn(*shape, generator=gen, device=dev, dtype=f32)
        return x.abs() if positive else x

    n_surf = len(cfg.surf_vars) + len(cfg.static_vars)
    return dict(
        surf={k: rn(B, T, H, W) for k in cfg.surf_vars},
        static={k: rn(B, T, H, W, positive=True) for k in cfg.static_vars},
        atmos={k: rn(B, T, C_A, H, W) for k in cfg.atmos_vars},
        enc=EncoderEncodings(pos=rn(L, D), scale=rn(L, D), levels=rn(C_A, D),
                             levels_dec=rn(C_A, 2 * D), lead_time=rn(D), absolute_time=rn(B, D)),
        x_surf=rn(B, n_surf, T, H, W),
        x_atmos=rn(B * C_A, len(cfg.atmos_vars), T, H, W),
        xa=rn(B, C_A, L, D),
        xs=rn(B, L, D),
        x4=rn(B, cfg.latent_levels, L, D),
    )


def encoder_parts(model: Aurora, inputs: dict) -> dict[str, Callable[[], object]]:
    """The encoder's parts on ``inputs`` (the keys of :func:`encoder_inputs`), each a
    callable of no arguments that runs the model's own modules."""
    E, cfg = model.encoder, model.cfg
    i = inputs
    names7 = tuple(cfg.surf_vars) + tuple(cfg.static_vars)
    dtype = i["xs"].dtype
    parts = {
        "encoder FULL": lambda: E(i["surf"], i["static"], i["atmos"], i["enc"]),
        "surf patch embed (7ch)": lambda: E.surf_token_embeds(i["x_surf"], names7),
        "atmos patch embed (13 lvl)": lambda: E.atmos_token_embeds(i["x_atmos"],
                                                                   tuple(cfg.atmos_vars)),
        "level aggregation": lambda: E._aggregate_levels(i["xa"]),
        "surf MLP chain": lambda: i["xs"] + E.surf_norm(E.surf_mlp(i["xs"])),
        "pos+scale adds": lambda: (i["x4"] + E.pos_embed(i["enc"].pos.to(dtype))[None, None]
                                   + E.scale_embed(i["enc"].scale.to(dtype))[None, None]),
    }
    return {k: torch.no_grad()(f) for k, f in parts.items()}


def main(argv=None, *, cfg: Optional[AuroraConfig] = None,
         model: Optional[Aurora] = None) -> list[dict]:
    args = tool_args(argv, __doc__, steps=3, H=720)
    dev, model = tool_model(args.device, cfg, model)
    P = model.cfg.patch_size
    L = (args.H // P) * (args.W // P)
    print(f"device {card_line(dev)}; L={L}, D={model.cfg.embed_dim}, C_A={len(LEVELS)}",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = encoder_inputs(model, args.H, args.W, gen)
    rows = time_parts(encoder_parts(model, inputs), dev, args.steps)
    del inputs
    for r in rows:
        report(r)
    return rows


if __name__ == "__main__":
    main()
