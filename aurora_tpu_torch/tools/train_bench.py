"""The fine-tuning step of the 1.3 B 0.25 degree model on the card: seconds a step, peak
memory, the losses and the kernel launches of each step.

Counterpart of ``tools/train_bench.py``, with its recipe: ``LARGE_CONFIG`` with LoRA, the
backbone in bf16 under ``autocast``, bf16 values in the level aggregation and
de-aggregation, ``remat`` at ``--remat-scope`` (the JAX default "full"), seeded random
weights with the FiLM modulations and LoRA ``B`` opened, persistence targets (each target
the last input frame), ``adamw(3e-4)``.

* ``--mode lora`` (default): the base weights frozen, the backbone stored in bf16
  (``cast_backbone_params``, which casts the LoRA adapters too, as the JAX tool's code
  does), AdamW over the adapter banks only.
* ``--mode full``: every parameter trained, stored in f32, AdamW over all of them.
* ``--default-config``: ``Aurora()``'s default config in place of the production knobs:
  float32 all through (no ``autocast``, float32 aggregation values, nothing cast), the
  backward's products full float32 (TF32 off).

With ``--drop-path`` / ``--drop-rate`` above 0 every step draws its masks from a generator
seeded with 0 (stochastic depth and dropout, the JAX step's ``rng``).

A warm-up step (which builds the kernels) comes first, then ``--steps`` steps, each ended
by a synchronise; the host clock times each. Peak memory is ``max_memory_allocated`` over
the timed steps. On the card every step's launches are held to :func:`expected_launches`:
the tool raises, after printing its results, where a step's differ.

Usage: ``python -m aurora_tpu_torch.tools.train_bench [--mode lora|full] [--steps 3]
[--H 721 --W 1440] [--no-remat] [--remat-scope full|no_outer|blocks] [--drop-path 0.2]
[--drop-rate 0.1] [--default-config] [--device cpu]``.
``main(argv, cfg=...)`` takes another :class:`~aurora_tpu_torch.model.config.AuroraConfig`
(the recipe's knobs are set on it), ``main(argv, model=...)`` a model already built. The
last line printed is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Optional

import numpy as np
import torch

from aurora_tpu_torch.model.aurora import Aurora, cast_backbone_params
from aurora_tpu_torch.model.config import AuroraConfig
from aurora_tpu_torch.model.swin3d import drop_path_rates
from aurora_tpu_torch.ops import _lib
from aurora_tpu_torch.tools import card_line, resolve_device
from aurora_tpu_torch.tools.perf_breakdown import (
    config_form,
    numpy_batch,
    open_gates,
    production_config,
)
from aurora_tpu_torch.training import adamw, lora_mask, make_train_step

__all__ = ["block_runs", "build", "check_launches", "expected_launches", "inputs", "launch_mismatches",
           "resampler_launches",
           "main", "run_steps", "step_generator", "train_config"]


def train_config(cfg: Optional[AuroraConfig] = None, remat: bool = True,
                 remat_scope: str = "full", default: bool = False, **knobs) -> AuroraConfig:
    """``cfg`` (the 1.3 B model with LoRA by default) with the production knobs, or with
    ``default`` as it is (``Aurora()``'s default config: float32 all through), and ``remat``
    at ``remat_scope``."""
    cfg = (cfg or Aurora.default_config()) if default else production_config(cfg)
    return cfg.replace(remat=remat, remat_scope=remat_scope, **knobs)


def build(cfg: AuroraConfig, device, mode: str, seed: int = 0) -> Aurora:
    """The model of the recipe: seeded weights, gates opened, the backbone stored in bf16 in
    LoRA mode under ``autocast`` (the default config keeps float32)."""
    model = Aurora(cfg, device=device, seed=seed)
    open_gates(model)
    if mode == "lora" and cfg.autocast:
        cast_backbone_params(model)
    return model


def inputs(model: Aurora, H: int, W: int, K: int = 1):
    """``(surf, static, atmos, batch)`` on the model's device and the persistence targets
    with a leading axis of ``K`` (each the last input frame)."""
    cfg = model.cfg
    batch = numpy_batch(cfg, H, W).crop(cfg.patch_size)
    b = batch.to(model.device, model.compute_dtype)
    tgt_surf = {k: torch.stack([v[:, -1]] * K) for k, v in b.surf_vars.items()}
    tgt_atmos = {k: torch.stack([v[:, -1]] * K) for k, v in b.atmos_vars.items()}
    return (b.surf_vars, b.static_vars, b.atmos_vars, batch), (tgt_surf, tgt_atmos)


def step_generator(cfg: AuroraConfig, device) -> Optional[torch.Generator]:
    """The generator of the steps' draws (seeded with 0) when ``cfg`` has a stochastic knob
    above 0, else None (a deterministic step)."""
    if cfg.drop_path > 0 or cfg.drop_rate > 0:
        return torch.Generator(device=device).manual_seed(0)
    return None


def block_runs(cfg: AuroraConfig, stage: int, block: int, depth: int, stages: int,
               body: int = 0) -> int:
    """The forward passes of block ``block`` of backbone stage ``stage`` (of ``stages``,
    encoder then decoder; ``depth`` blocks in it) in one update: its forward, one more in a
    roll-out step's replay (``body``), and the replays of the rematerialised regions around
    it (:func:`expected_launches` says which)."""
    runs = 1 + body
    if cfg.remat:
        runs += 1
        runs += cfg.remat_scope in ("full", "no_outer") and block < depth - 1
        runs += cfg.remat_scope == "full" and stage < stages - 1
    return runs


def resampler_launches(cfg: AuroraConfig) -> dict[str, int]:
    """The launches of one forward of the level aggregation and the de-aggregations: each
    resampler launches K4 once (layer 0) and K3 once a layer (layer 0's MLP half and each
    deeper layer's), so ``enc_depth`` K3 in the encoder and ``dec_depth`` in each
    de-aggregation (two with ``separate_perceiver``)."""
    decoders = 2 if cfg.separate_perceiver else 1
    return {"perceiver_core": 1 + decoders,
            "mlp_adaln_residual": cfg.enc_depth + decoders * cfg.dec_depth}


def expected_launches(cfg: AuroraConfig, lora: bool, K: int = 0,
                      stochastic: bool = False) -> dict[str, int]:
    """The kernel launches of one update on the card, from the code: a single-step train
    step (``K = 0``) or a roll-out train step of ``K`` steps, on the main route;
    ``stochastic``: the steps draw masks (a generator is passed).

    Each forward pass of a Swin block launches K2 and K3 once and, in a shifted block (odd
    index), K1 twice; a stochastic block (a generator, and its stochastic-depth rate or
    ``drop_rate`` above 0) runs plain attention and a plain MLP and launches K1 only; the
    level aggregation and de-aggregation launch K4 once each and K3 once a resampler layer
    (``enc_depth``, ``dec_depth``).
    The backward of every roll launches K1 once more (``roll3d_bwd``: the first block of a
    stage is unshifted, so every roll's input needs a gradient). A rematerialised region runs
    its forward again in the backward, inside the replays of the regions around it, and each
    replay stops after the last tensor its own region saves (``torch.utils.checkpoint``'s
    early stop):

    * ``remat``: every block once more;
    * ``remat_scope`` "full" / "no_outer": each stage replays its blocks up to the input of
      its last block, so every block but the last of its stage once more;
    * "full": the backbone replays every stage but the last (the last tensor it saves is
      the second decoder stage's patch split), each whole; the decoder replays once, the
      encoder once where its input or weights need a gradient;
    * a roll-out step (``K`` > 0) is one region: its replay runs the whole step once more
      (its last saved tensor is the loss's). From the second step on the encoder's input,
      the history, holds a prediction and needs a gradient.

    A LoRA update's backward launches K3's hand-written input gradient
    (``mlp_adaln_residual_grad``) once for each K3 call of each step whose tokens are bf16 (the
    backbone's under ``autocast``; the first resampler layer's under ``agg_bf16`` /
    ``deagg_bf16``) and need a gradient, replays or not: only the tokens ask for one. A full
    fine-tune's backward asks for the weights' too and launches none.
    """
    remat, scope = cfg.remat, cfg.remat_scope
    enc_rates, dec_rates = drop_path_rates(cfg.backbone)
    stages = enc_rates + dec_rates
    steps = max(K, 1)
    n = dict.fromkeys(("roll3d", "window_attention", "mlp_adaln_residual", "perceiver_core",
                       "roll3d_bwd", "mlp_adaln_residual_grad"), 0)
    for step in range(steps):
        body = int(K > 0)
        for s, rates in enumerate(stages):
            depth = len(rates)
            for i in range(depth):
                runs = block_runs(cfg, s, i, depth, len(stages), body)
                if not (stochastic and (rates[i] > 0 or cfg.drop_rate > 0)):
                    n["window_attention"] += runs
                    n["mlp_adaln_residual"] += runs
                    n["mlp_adaln_residual_grad"] += int(lora and cfg.autocast)
                if i % 2:
                    n["roll3d"] += 2 * runs
                    n["roll3d_bwd"] += 2
        full = remat and scope == "full"
        encoder_grad = not lora or step > 0
        for runs, depth, bf16, grad in (
                (1 + body + (full and encoder_grad), cfg.enc_depth, cfg.agg_bf16, encoder_grad),
                (1 + body + full, cfg.dec_depth, cfg.deagg_bf16, True)):  # encoder, decoder
            n["perceiver_core"] += runs
            n["mlp_adaln_residual"] += runs * depth
            n["mlp_adaln_residual_grad"] += int(lora and grad and bf16)
    return n


def launch_mismatches(launches_per_step: list[dict], expected: dict) -> list[int]:
    """The indices of the steps whose launches (the non-zero counts of each kernel) differ
    from ``expected``."""
    want = {k: v for k, v in expected.items() if v}
    return [i for i, n in enumerate(launches_per_step)
            if {k: v for k, v in n.items() if v} != want]


def check_launches(out: dict) -> None:
    """Raise unless every timed step of a tool's result ``out`` on the card launched
    ``out["expected_launches"]``."""
    if out["device"] != "cuda":
        return
    wrong = launch_mismatches(out["launches_per_step"], out["expected_launches"])
    if wrong:
        raise AssertionError(f"launches of steps {wrong} differ from the derived count "
                             f"{out['expected_launches']}: {out['launches_per_step']}")


def run_steps(step: Callable[[int], torch.Tensor], n: int, device: torch.device) -> dict:
    """A warm-up call of ``step(i)`` (``i`` its index), then ``n`` timed ones, each ended by
    a synchronise: the host-clock seconds, losses and launches of each, and the peak memory
    over the timed ones."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    losses = [float(step(0))]
    sync()
    warm = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    times, launches = [], []
    for i in range(1, n + 1):
        before = dict(_lib.LAUNCHES)
        t0 = time.perf_counter()
        loss = step(i)
        sync()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        launches.append({k: v - before[k] for k, v in _lib.LAUNCHES.items() if v != before[k]})
    peak = torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else None
    return dict(warmup_s=warm, times=times, s_per_step=float(np.median(times)),
                s_per_step_min=min(times), peak_mem_gib=peak, loss_first=losses[0],
                loss_last=losses[-1], losses=losses, launches_per_step=launches)


def main(argv=None, *, cfg: Optional[AuroraConfig] = None,
         model: Optional[Aurora] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("lora", "full"), default="lora")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--H", type=int, default=721)
    ap.add_argument("--W", type=int, default=1440)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--remat-scope", choices=("full", "no_outer", "blocks"), default="full")
    ap.add_argument("--drop-path", type=float, default=0.0, help="stochastic-depth rate")
    ap.add_argument("--drop-rate", type=float, default=0.0, help="dropout rate")
    ap.add_argument("--default-config", action="store_true",
                    help="Aurora()'s default config (float32) in place of the production knobs")
    ap.add_argument("--device", default=None, help="the card unless 'cpu' is given")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be at least 1")
    dev = resolve_device(args.device)
    build_s = _lib.build() if dev.type == "cuda" else None
    if model is None:
        cfg = train_config(cfg, remat=not args.no_remat, remat_scope=args.remat_scope,
                           default=args.default_config, drop_path=args.drop_path,
                           drop_rate=args.drop_rate)
        model = build(cfg, dev, args.mode)
    cfg = model.cfg
    gen = step_generator(cfg, dev)
    (surf, static, atmos, batch), (tgt_surf, tgt_atmos) = inputs(model, args.H, args.W)
    enc = model.prepare_encodings(batch, torch.float32)
    levels = tuple(float(x) for x in batch.metadata.atmos_levels)
    trainable = lora_mask if args.mode == "lora" else None
    step = make_train_step(model, adamw(3e-4, trainable=trainable), levels)
    tgt_surf = {k: v[0] for k, v in tgt_surf.items()}
    tgt_atmos = {k: v[0] for k, v in tgt_atmos.items()}
    row = run_steps(lambda i: step(surf, static, atmos, enc, i % 3, tgt_surf, tgt_atmos,
                                   generator=gen), args.steps, dev)
    out = dict(metric=f"train_step_{args.mode}", device=dev.type, card=card_line(dev),
               config=config_form(cfg), grid=[args.H, args.W], remat=cfg.remat,
               remat_scope=cfg.remat_scope,
               drop_path=cfg.drop_path, drop_rate=cfg.drop_rate,
               trainable_params=sum(p.numel() for p in model.parameters() if p.requires_grad),
               build_s=build_s, **row,
               expected_launches=expected_launches(cfg, lora=args.mode == "lora",
                                                   stochastic=gen is not None))
    for i, (s, n) in enumerate(zip(out["times"], out["launches_per_step"]), 1):
        print(f"step {i}: {s:.4f} s (host clock, {dev.type}), launches {n}", flush=True)
    print(json.dumps(out), flush=True)
    check_launches(out)
    return out


if __name__ == "__main__":
    main()
