"""A/B of the train step's speed levers at 0.25 degrees on the card, in one process.

Counterpart of ``tools/train_speed_probe.py``: the 1.3 B LoRA recipe of
:mod:`~aurora_tpu_torch.tools.train_bench`, one model, its arms in one process:

* ``remat_scope``: "full" replays the forward at every level of the JAX package's nested
  checkpoint list in the backward; "no_outer" and "blocks" drop the outer levels one by
  one, each keeping that level's activations instead of replaying them ("none": no remat);
* the backward's chunk budget (``ops/ad.py::GRAD_CHUNK_BYTES``, 512 MiB; the counterpart of
  the JAX tool's chunk environment knobs): the ``_chunks`` arms run with larger chunks, fewer
  of them;
* ``base2`` repeats ``base`` at the end, a control of the card's drift over the run.

Each arm sets its knobs on the same model (``Aurora.set_knobs``) and binds a fresh AdamW,
so every arm starts from the weights the arm before left. After its warm-up step an arm's
measured peak memory is held to ``--hbm-gate`` GiB (the card has no compile-time estimate):
above it the arm is skipped. Then ``--steps`` steps, each ended by a synchronise; an arm's
``s_per_step`` is the fastest. It prints one line per arm and, last, one JSON object; it
writes no file.

Usage: ``python -m aurora_tpu_torch.tools.train_speed_probe [--steps 3] [--H 721 --W 1440]
[--hbm-gate 76] [--arms base,no_outer,blocks,blocks_chunks,base2] [--device cpu]``;
``main(argv, cfg=..., model=...)`` as ``train_bench``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch

from aurora_tpu_torch.model.aurora import Aurora
from aurora_tpu_torch.model.config import AuroraConfig
from aurora_tpu_torch.ops import _lib, ad
from aurora_tpu_torch.tools import card_line, resolve_device
from aurora_tpu_torch.tools.train_bench import build, inputs, train_config
from aurora_tpu_torch.training import adamw, lora_mask, make_train_step

__all__ = ["ARMS", "main"]

_CHUNKS = 4 * ad.GRAD_CHUNK_BYTES
ARMS = {  # name: (remat_scope, or None for no remat; the backward's chunk budget in bytes)
    "base": ("full", ad.GRAD_CHUNK_BYTES),
    "no_outer": ("no_outer", ad.GRAD_CHUNK_BYTES),
    "blocks": ("blocks", ad.GRAD_CHUNK_BYTES),
    "blocks_chunks": ("blocks", _CHUNKS),
    "no_outer_chunks": ("no_outer", _CHUNKS),
    "full_chunks": ("full", _CHUNKS),
    "none": (None, ad.GRAD_CHUNK_BYTES),
    "base2": ("full", ad.GRAD_CHUNK_BYTES),
}


def main(argv=None, *, cfg: Optional[AuroraConfig] = None,
         model: Optional[Aurora] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--H", type=int, default=721)
    ap.add_argument("--W", type=int, default=1440)
    ap.add_argument("--hbm-gate", type=float, default=76.0,
                    help="GiB of peak memory after the warm-up step above which an arm stops")
    ap.add_argument("--arms", default="base,no_outer,blocks,blocks_chunks,base2")
    ap.add_argument("--device", default=None, help="the card unless 'cpu' is given")
    args = ap.parse_args(argv)
    arms = args.arms.split(",")
    if args.steps < 1:
        ap.error("--steps must be at least 1 (one warm-up step always runs)")
    unknown = [a for a in arms if a not in ARMS]
    if unknown:
        ap.error(f"unknown arms {unknown}; choose from {sorted(ARMS)}")
    dev = resolve_device(args.device)
    build_s = _lib.build() if dev.type == "cuda" else None
    if model is None:
        model = build(train_config(cfg), dev, "lora")
    dev = model.device
    cuda = dev.type == "cuda"
    (surf, static, atmos, batch), (tgt_surf, tgt_atmos) = inputs(model, args.H, args.W)
    enc = model.prepare_encodings(batch, torch.float32)
    levels = tuple(float(x) for x in batch.metadata.atmos_levels)
    tgt_surf = {k: v[0] for k, v in tgt_surf.items()}
    tgt_atmos = {k: v[0] for k, v in tgt_atmos.items()}
    knobs0 = {k: getattr(model.cfg, k) for k in ("remat", "remat_scope")}
    chunk0 = ad.GRAD_CHUNK_BYTES

    def sync():
        if cuda:
            torch.cuda.synchronize()

    results = []
    try:
        for arm in arms:
            scope, chunk = ARMS[arm]
            model.set_knobs(remat=scope is not None, remat_scope=scope or "full")
            ad.GRAD_CHUNK_BYTES = chunk
            step = make_train_step(model, adamw(3e-4, trainable=lora_mask), levels)
            rec = dict(arm=arm, remat_scope=scope, grad_chunk_mib=chunk >> 20)
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            times, losses = [], []
            for i in range(args.steps + 1):
                t0 = time.perf_counter()
                losses.append(float(step(surf, static, atmos, enc, i % 3, tgt_surf, tgt_atmos)))
                sync()
                times.append(time.perf_counter() - t0)
                if i == 0:
                    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
                    rec.update(warmup_s=times[0], peak_gib=peak)
                    if peak is not None and peak > args.hbm_gate:
                        rec["skipped"] = f"peak {peak:.2f} GiB > gate {args.hbm_gate}"
                        break
            if "skipped" not in rec:
                rec.update(s_per_step=min(times[1:]), times=times[1:], loss_first=losses[0],
                           loss_last=losses[-1])
            print(json.dumps(rec), flush=True)
            results.append(rec)
            del step
    finally:
        model.set_knobs(**knobs0)
        ad.GRAD_CHUNK_BYTES = chunk0
    out = dict(metric="train_speed_probe", device=dev.type, card=card_line(dev),
               grid=[args.H, args.W], steps=args.steps, hbm_gate_gib=args.hbm_gate,
               build_s=build_s, arms=results)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
