"""Fine-tuning through a ``K``-step roll-out on the card: seconds an update, peak memory,
the losses and the kernel launches of each update.

Counterpart of ``tools/rollout_train_bench.py``, with its recipe: the LoRA-only recipe of
:mod:`~aurora_tpu_torch.tools.train_bench` with per-roll-out-step banks (``--lora-mode``
"all" or "from_second"), ``remat`` at ``--remat-scope``, and
:func:`~aurora_tpu_torch.training.make_rollout_train_step`, whose steps are each
rematerialised, so the activations kept between steps are one step's inputs. Each step's
absolute time comes from ``Aurora.step_encodings`` of the batch's time advanced by that many
steps; every step's target is the last input frame.

Usage: ``python -m aurora_tpu_torch.tools.rollout_train_bench [--K 2] [--steps 3]
[--H 721 --W 1440] [--remat-scope full|no_outer|blocks] [--lora-mode all|from_second]
[--default-config] [--device cpu]``; ``--default-config`` and ``main(argv, cfg=...,
model=...)`` as ``train_bench``'s. The last line printed is one JSON object; on the card the
tool then raises where an update's launches differ from ``train_bench.expected_launches``.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import torch

from aurora_tpu_torch.model.aurora import Aurora
from aurora_tpu_torch.model.config import AuroraConfig
from aurora_tpu_torch.ops import _lib
from aurora_tpu_torch.tools import card_line, resolve_device
from aurora_tpu_torch.tools.perf_breakdown import config_form
from aurora_tpu_torch.tools.train_bench import (
    build,
    check_launches,
    expected_launches,
    inputs,
    run_steps,
    train_config,
)
from aurora_tpu_torch.training import adamw, lora_mask, make_rollout_train_step

__all__ = ["main", "step_encodings"]


def step_encodings(model: Aurora, batch, K: int):
    """``(abs_t_steps (K, B, D), dyn_steps (K, B, 6) or None)``: each roll-out step's time
    encodings, the batch's times advanced by the step's index."""
    abs_t, dyn = [], []
    for i in range(K):
        a, d = model.step_encodings([t + i * model.cfg.timestep for t in batch.metadata.time],
                                    torch.float32)
        abs_t.append(a)
        dyn.append(d)
    return torch.stack(abs_t), None if dyn[0] is None else torch.stack(dyn)


def main(argv=None, *, cfg: Optional[AuroraConfig] = None,
         model: Optional[Aurora] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--K", type=int, default=2, help="roll-out steps to backpropagate through")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--H", type=int, default=721)
    ap.add_argument("--W", type=int, default=1440)
    ap.add_argument("--remat-scope", choices=("full", "no_outer", "blocks"), default="full")
    ap.add_argument("--lora-mode", choices=("all", "from_second"), default="all")
    ap.add_argument("--default-config", action="store_true",
                    help="Aurora()'s default config (float32) in place of the production knobs")
    ap.add_argument("--device", default=None, help="the card unless 'cpu' is given")
    args = ap.parse_args(argv)
    if args.steps < 1 or args.K < 1:
        ap.error("--steps and --K must be at least 1")
    dev = resolve_device(args.device)
    build_s = _lib.build() if dev.type == "cuda" else None
    if model is None:
        cfg = train_config(cfg, remat_scope=args.remat_scope, default=args.default_config,
                           lora_mode=args.lora_mode)
        model = build(cfg, dev, "lora")
    cfg = model.cfg
    (surf, static, atmos, batch), (tgt_surf, tgt_atmos) = inputs(model, args.H, args.W, args.K)
    enc = model.prepare_encodings(batch, torch.float32)
    abs_t, dyn = step_encodings(model, batch, args.K)
    levels = tuple(float(x) for x in batch.metadata.atmos_levels)
    step = make_rollout_train_step(model, adamw(3e-4, trainable=lora_mask), levels, args.K)
    row = run_steps(lambda i: step(surf, static, atmos, enc, abs_t, 0, tgt_surf, tgt_atmos,
                                   dyn), args.steps, dev)
    out = dict(metric="rollout_train_step_lora", device=dev.type, card=card_line(dev),
               config=config_form(cfg), grid=[args.H, args.W], K=args.K,
               lora_mode=cfg.lora_mode, remat_scope=cfg.remat_scope, build_s=build_s, **row,
               s_per_rollout_step=row["s_per_step"] / args.K,
               expected_launches=expected_launches(cfg, lora=True, K=args.K))
    for i, (s, n) in enumerate(zip(out["times"], out["launches_per_step"]), 1):
        print(f"update {i}: {s:.4f} s (host clock, {dev.type}), launches {n}", flush=True)
    print(json.dumps(out), flush=True)
    check_launches(out)
    return out


if __name__ == "__main__":
    main()
