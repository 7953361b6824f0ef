"""Real multi-process execution of the model over a ``(data, lat, lon)`` mesh of ranks
(counterpart of ``tools/multihost_sim.py``).

The launcher starts one worker process a rank, each brought up by
:func:`aurora_tpu_torch.parallel.initialize` over a ``FileStore`` in a temporary folder (no
fixed port: runs side by side do not collide), and meanwhile runs the same work in its own
process on the whole batch. Each worker builds the same model with the same weights (seeded
from ``--seed`` on its device, or ``--params``, a ``save_params`` file).

**The data axis** (``--data N``, ``lat = lon = 1``): ``AuroraSmallPretrained(use_lora=True)``
in float32, each rank on its slice of the batch (the JAX tool's draws, batch 2, on the
device's layout, :data:`LAYOUTS`; ``shard_batch_arrays``), under ``make_mesh(data=N)``:

1. ``forward_core`` and a one-step ``rollout``, each prediction gathered (``gather_batch``);
2. one LoRA train step (``adamw(1e-4, trainable=lora_mask)``, zero targets), then one K = 2
   roll-out train step;
3. from the same weights, one full fine-tune step under ``shard_params`` (ZeRO over
   ``data``), the updated parameters gathered.

The launcher holds each against its one-process run: the forward, the LoRA step's averaged
gradients and the full step's ``encoder.surf_token_embeds.weights.2t`` (the JAX test's
probe) within 1e-5 max-rel, the roll-out step's averaged gradients within
:data:`ROLLOUT_GRAD_TOL`, the losses within 1e-6 relative; each rank's AdamW
moments of a split parameter are 1/N of it; ``replicate`` gives every rank the first rank's
values. The LoRA step's parameters are held within 1e-5 where the gradient is resolved:
AdamW's first update is about ``lr * sign(gradient)``, so an element whose gradient is
rounding noise moves either way when the sums are taken in another order (the worst element
over all of them is printed beside, and so is the full step's worst parameter). Beside each
gradient check it prints what the check would read had rank 0 skipped the average (its own
gradient, recorded as the backward accumulates it, against the one-process gradient): the
reading of a fault, which the bound must lie far below.

**The (lat, lon) split** (``--lat`` or ``--lon`` above 1; without ``--data``, ``--lat`` and
``--lon`` the JAX tool's layout, ``data=1, lat=2, lon=4``): the forward only, the train steps
under such a mesh not being ported yet. On each grid of ``--grids`` (pixels, cropped to the
patch; default the layout's), each rank takes its block of the batch (``shard_batch``), runs
``Aurora.forward``, a 2-step ``rollout`` and, unless ``--no-scan``, a
``rollout_scan(host_offload=True)`` (which gathers each step once), and gathers the
predictions (``gather_batch``); the launcher holds them against its one-process run within
:data:`FORWARD_TOL` max-rel, and prints what the blocks saw (:func:`geometry`): grids
over-padded (``extra``), patch merges of an odd block, uneven splits, shifted windows on each
split axis, pixel grids the mesh does not split into whole patches, and the halo bytes each
rank sent per block. With ``--deep-params FILE`` (a ``save_params`` file of the small model
with ``enc_depth = dec_depth = 2``) the run adds that model's forward on the first grid, held
to its one-process forward as the others. ``--config production`` runs the main path's model
instead (the 1.3 B model with the production knobs, ``tools.perf_breakdown.build_model``) on
its seeded batch (``numpy_batch``, batch 1, 13 levels; default grid 721 x 1440), held within
:data:`PRODUCTION_TOL` mean-rel per variable (its bf16 backbone).

It prints one JSON line and exits non-zero on a failed check. The ranks run on the card
(every rank on the one card, over gloo: NCCL refuses two ranks on one device) unless
``--device cpu`` asks for the CPU. The small model's batch follows the device: the JAX
tool's 4 levels at 33 x 64 on the CPU, 13 levels at 121 x 240 on the card, whose level
aggregation kernel takes 13 levels and whose window kernels take whole 144-token windows,
which the smallest stage of a 33 x 64 grid cannot hold.

Usage: ``python -m aurora_tpu_torch.tools.multihost_sim [--data N] [--lat A] [--lon O]
[--device cpu|cuda] [--seed S] [--params FILE] [--depths D] [--width D] [--dtype float64]
[--config small|production] [--grids HxW,...] [--no-scan] [--deep-params FILE]
[--save FILE]``;
``--depths`` cuts every stage to ``D`` blocks, ``--width`` sets the small model's
``embed_dim``, ``--save`` writes every result (``torch.save``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from aurora_tpu_torch.model.aurora import resolve_device
from aurora_tpu_torch.training import AdamW

__all__ = ["FORWARD_TOL", "LAYOUTS", "LOSS_TOL", "PARAM_TOL", "PRODUCTION_TOL",
           "ROLLOUT_GRAD_TOL", "SPATIAL_STEPS", "RecordingAdamW", "collect", "compare",
           "compare_spatial", "geometry", "make_inputs", "ready_host", "release", "result",
           "run", "run_spatial", "spawn_workers", "main"]

B = 2
# The batch's pressure levels and grid by device type: the JAX tool's 4 levels at 33 x 64 on
# the CPU; on the card the main path's 13 (its level aggregation kernel takes 13) at 121 x 240
# (its window kernels take whole 144-token windows).
LAYOUTS = {"cpu": ((100, 250, 500, 850), (33, 64)),
           "cuda": ((50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000),
                    (121, 240))}
LR = 1e-4
FORWARD_TOL = PARAM_TOL = 1e-5  # max-rel, the JAX tool's and tests/test_parallel.py's
LOSS_TOL = 1e-6  # relative
# A (lat, lon) run of the production model (bf16 backbone) against the one-process run: mean
# relative error per variable, the bar of every bf16 route against its plain run. A rounding
# that differs anywhere in the bf16 backbone (a cuBLAS or cuDNN product whose algorithm goes
# by the block's shape) lifts the winds and humidity to the bf16 noise floor, ~5e-3 (PERF.md).
PRODUCTION_TOL = 1e-2
SPATIAL_STEPS = 2  # roll-out steps of a (lat, lon) run's serving half, by default
# The roll-out step's gradients (max-rel). Readings (PERF.md; ``--seed`` 0-2): at most 1.12e-5
# on the card and 1.10e-5 on the CPU, against 5.5e-2 or more where rank 0 skips the average.
ROLLOUT_GRAD_TOL = 1e-4
RESOLVED = 1e-6  # the least |gradient| whose AdamW update the parameter check compares
PROBE = "encoder.surf_token_embeds.weights.2t"
ROLLOUT_K = 2  # steps of the roll-out train step
DEEP_DEPTH = 2  # enc_depth = dec_depth of ``--deep-params``'s model
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_inputs(device_type: str = "cpu", seed: int = 0, grid=None, batch: int = B):
    """The JAX tool's batch (``tests/conftest.py::make_batch(H=33, W=64, B=2,
    dtype=np.float32)``: the same draws in the same order), as a port :class:`Batch`, on the
    layout of ``device_type`` (:data:`LAYOUTS`), or on ``grid`` ``(H, W)`` with ``batch``
    elements."""
    LEVELS, (H, W) = LAYOUTS[device_type]
    if grid is not None:
        H, W = grid
    from aurora_tpu_torch.batch import Batch, Metadata
    from aurora_tpu_torch.normalisation import NORMALISATION_STATS, level_to_str

    rng = np.random.default_rng(seed)

    def sample(name, shape):
        loc, scale = NORMALISATION_STATS.get(name, (0.0, 1.0))
        return (loc + scale * rng.standard_normal(shape)).astype(np.float32)

    def sample_atmos(name, shape):
        out = np.empty(shape, dtype=np.float32)
        for i, lvl in enumerate(LEVELS):
            loc, scale = NORMALISATION_STATS[f"{name}_{level_to_str(lvl)}"]
            out[..., i, :, :] = loc + scale * rng.standard_normal((*shape[:-3], *shape[-2:]))
        return out

    return Batch(
        surf_vars={k: torch.from_numpy(sample(k, (batch, 2, H, W)))
                   for k in ("2t", "10u", "10v", "msl")},
        static_vars={k: torch.from_numpy(np.abs(sample(k, (H, W)))) for k in ("lsm", "z", "slt")},
        atmos_vars={k: torch.from_numpy(sample_atmos(k, (batch, 2, len(LEVELS), H, W)))
                    for k in ("z", "u", "v", "t", "q")},
        metadata=Metadata(lat=np.linspace(90, -90, H), lon=np.linspace(0, 360, W, endpoint=False),
                          time=tuple(datetime(2020, 6, 1, 12) for _ in range(batch)),
                          atmos_levels=LEVELS, rollout_step=0),
    )


def build(device, params: Optional[str], depths: Optional[int], seed: int = 0,
          width: Optional[int] = None, dtype: torch.dtype = torch.float32,
          resampler_depth: Optional[int] = None):
    """The model every rank builds: ``AuroraSmallPretrained(use_lora=True)`` in ``dtype``
    (``embed_dim`` ``width`` if given; ``enc_depth = dec_depth = resampler_depth`` if given),
    its weights from ``params`` or seeded from ``seed`` on ``device`` (N(0, 0.02), LayerNorms
    at 1 and 0, FiLM and LoRA ``B`` at N(0, 0.05))."""
    from aurora_tpu_torch.checkpoint import restore_params
    from aurora_tpu_torch.model.aurora import AuroraSmallPretrained
    from aurora_tpu_torch.model.nn import LayerNorm

    cut = {} if depths is None else dict(encoder_depths=(depths,) * 3,
                                          decoder_depths=(depths,) * 3)
    if width is not None:
        cut["embed_dim"] = width
    if resampler_depth is not None:
        cut.update(enc_depth=resampler_depth, dec_depth=resampler_depth)
    model = AuroraSmallPretrained(device=device, dtype=dtype, seed=None, use_lora=True, **cut)
    if params is not None:
        return restore_params(params, like=model)
    norms = {f"{m}.{k}" for m, mod in model.named_modules() if isinstance(mod, LayerNorm)
             for k in ("weight", "bias")}
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in norms:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
                continue
            gate = ("modulation" in name and name.endswith("weight")) or name.endswith(".B")
            p.copy_(torch.randn(p.shape, generator=g, device=device) * (0.05 if gate else 0.02))
    return model


def _grids(args, device_type: str) -> list[tuple[int, int]]:
    if args.grids:
        return [tuple(int(n) for n in g.split("x")) for g in args.grids.split(",")]
    if args.config == "production":
        return [(721, 1440)]
    return [LAYOUTS[device_type][1]]


def build_spatial(device, args):
    """The model of the (lat, lon) runs: the small model (:func:`build`, in ``--dtype``) or,
    with ``--config production``, the main path's 1.3 B model as
    ``tools.perf_breakdown.build_model`` seeds it."""
    if args.config == "production":
        from aurora_tpu_torch.tools.perf_breakdown import build_model, production_config

        return build_model(production_config(), device, seed=args.seed)
    return build(device, args.params, args.depths, args.seed, args.width,
                 getattr(torch, args.dtype))


def spatial_config(args):
    """The config of :func:`build_spatial`'s model."""
    from aurora_tpu_torch.model.aurora import AuroraSmallPretrained
    from aurora_tpu_torch.tools.perf_breakdown import production_config

    if args.config == "production":
        return production_config()
    cut = {} if args.depths is None else dict(encoder_depths=(args.depths,) * 3,
                                               decoder_depths=(args.depths,) * 3)
    if args.width is not None:
        cut["embed_dim"] = args.width
    return AuroraSmallPretrained.default_config().replace(use_lora=True, **cut)


def spatial_inputs(cfg, device_type: str, args, grid):
    """The batch of a (lat, lon) run on ``grid``, cropped to the patch: the main path's
    (``numpy_batch``) with ``--config production``, else the JAX tool's draws with
    ``data`` elements (as float64 with ``--dtype float64``)."""
    if args.config == "production":
        from aurora_tpu_torch.tools.perf_breakdown import numpy_batch

        batch = numpy_batch(cfg, *grid, seed=args.seed)
    else:
        batch = make_inputs(device_type, args.seed, grid, batch=args.data)
        if args.dtype == "float64":
            batch = batch.astype(torch.float64)
    return batch.crop(cfg.patch_size)


def _host(pred) -> dict:
    return {k: torch.as_tensor(v).detach().cpu()
            for k, v in {**pred.surf_vars, **pred.atmos_vars}.items()}


def run_spatial(device, mesh, args, inputs: Optional[dict] = None) -> dict:
    """The forward, a ``--steps``-step roll-out and (unless ``--no-scan``) the host-offload
    ``rollout_scan`` on each grid, on this rank's block under ``mesh`` (a (lat, lon) mesh)
    or on the whole batch without one. Returns per grid the whole predictions (gathered
    under the mesh, on the host), the seconds of each step (synchronised), the launches and
    :func:`~aurora_tpu_torch.parallel.halo.report`. ``inputs``: batches made ahead, by
    grid."""
    import contextlib

    from aurora_tpu_torch.ops import _lib
    from aurora_tpu_torch.parallel import gather_batch, halo, shard_batch
    from aurora_tpu_torch.rollout import rollout, rollout_scan

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    model = build_spatial(device, args)
    sync()
    out: dict = {"build_s": time.perf_counter() - t0, "grids": {}, "config": args.config}
    scope = mesh if mesh is not None else contextlib.nullcontext()
    for grid in _grids(args, device.type):
        batch = (inputs or {}).get(grid)
        if batch is None:
            batch = spatial_inputs(model.cfg, device.type, args, grid)
        part = shard_batch(batch, mesh) if mesh is not None else batch
        halo.reset_stats()
        _lib.reset_launches()
        res: dict = {"grid": list(batch.spatial_shape)}
        with scope, torch.no_grad():
            t = time.perf_counter()
            fwd = model(part)
            sync()
            res["forward_s"] = time.perf_counter() - t
            res["forward"] = _host(gather_batch(fwd) if mesh is not None else fwd)
            del fwd
            res["rollout"], res["step_s"] = [], []
            t = time.perf_counter()
            for pred in rollout(model, part, args.steps):
                sync()
                res["step_s"].append(time.perf_counter() - t)
                res["rollout"].append(_host(gather_batch(pred) if mesh is not None else pred))
                del pred
                t = time.perf_counter()
            res["launches"] = {k: v for k, v in _lib.LAUNCHES.items() if v}
            res["halo"] = halo.report()
            if not args.no_scan:
                res["scan"] = [_host(p) for p in rollout_scan(model, part, args.steps,
                                                              host_offload=True)]
        out["grids"]["x".join(map(str, res["grid"]))] = res
    if args.deep_params:
        # The small model with resamplers of depth DEEP_DEPTH: one forward on the first grid.
        del model
        deep = build(device, args.deep_params, args.depths, args.seed, args.width,
                     getattr(torch, args.dtype), resampler_depth=DEEP_DEPTH)
        batch = spatial_inputs(deep.cfg, device.type, args, _grids(args, device.type)[0])
        part = shard_batch(batch, mesh) if mesh is not None else batch
        with scope, torch.no_grad():
            fwd = deep(part)
            out["deep"] = dict(grid=list(batch.spatial_shape), depth=DEEP_DEPTH,
                               forward=_host(gather_batch(fwd) if mesh is not None else fwd))
    out["seconds"] = time.perf_counter() - t0
    return out


class RecordingAdamW(AdamW):
    """AdamW that keeps a copy of the (averaged) gradients it applies (``grads``) and of each
    gradient as the backward left it on this rank, before any average (``local``)."""

    def init(self, model: torch.nn.Module) -> "RecordingAdamW":
        super().init(model)
        self.local: dict = {}
        self._hooks = [p.register_post_accumulate_grad_hook(self._keep) for p in self.params]
        return self

    def _keep(self, p) -> None:
        self.local[p] = p.grad.detach().clone()

    def step(self) -> None:
        self.grads = {p: p.grad.detach().cpu().clone() for p in self.params}
        self.local = {p: g.cpu() for p, g in self.local.items()}
        for h in self._hooks:
            h.remove()
        super().step()


STOCHASTIC = dict(drop_path=0.2, drop_rate=0.1)  # the knobs of the stochastic LoRA step
TRAIN_STEPS = ("forward", "lora", "rollout", "stochastic", "full")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def recipe(config: str) -> dict:
    """The train steps' recipe of a config: the small model's (the JAX tool's: zero
    targets, ``adamw(1e-4)``, the LoRA step's loss weighted by the cosine of latitude) or
    the production model's (``tools.train_bench``'s: persistence targets, ``adamw(3e-4)``,
    the plain loss)."""
    if config == "production":
        return dict(lr=3e-4, targets="persistence", lat_weighted=False)
    return dict(lr=LR, targets="zeros", lat_weighted=True)


def train_steps(device, mesh, model, batch, which, seed: int = 0, config: str = "small",
                rebuild=None, ckpt: Optional[str] = None) -> dict:
    """The train steps ``which`` (of :data:`TRAIN_STEPS`, in that order, each from where the
    last left the model) on this rank's part of ``batch`` (whole and cropped) under
    ``mesh`` (its slice of the batch over ``data``, its block of the grid over ``lat`` and
    ``lon``), or on the whole batch without one, with :func:`recipe`'s targets, loss and
    learning rate:

    * ``forward``: ``forward_core`` without gradients (its predictions this rank's part);
    * ``lora``: ``make_train_step`` with ``adamw(trainable=lora_mask)``;
    * ``rollout``: a ROLLOUT_K-step ``make_rollout_train_step``, LoRA only;
    * ``stochastic``: the LoRA step with :data:`STOCHASTIC`'s knobs and a generator seeded
      with ``seed`` (beside it the deterministic loss at the same weights);
    * ``full``: from the weights the model had on entry, every parameter trained, under
      ``shard_params`` where the mesh splits ``data``; then, with ``ckpt``, the training
      state saved there (``save_train_state``, and the parameters by ``save_params``) and
      restored into ``rebuild()`` placed alike.

    Returns per step its loss, the gradients the optimiser applied (reduced over the mesh)
    and this rank's own before any reduction, the updated trainable parameters (the full
    step's whole), its seconds, launches and :func:`~aurora_tpu_torch.parallel.halo.report`."""
    import contextlib
    from functools import partial

    from aurora_tpu_torch.checkpoint import (
        restore_params,
        restore_train_state,
        save_params,
        save_train_state,
    )
    from aurora_tpu_torch.ops import _lib
    from aurora_tpu_torch.parallel import gathered_params, halo, shard_batch_arrays
    from aurora_tpu_torch.parallel import shard_params
    from aurora_tpu_torch.parallel.sharding import global_mean, train_mesh
    from aurora_tpu_torch.training.train import _local_targets
    from aurora_tpu_torch.training import (
        adamw,
        lora_mask,
        mae_loss,
        make_rollout_train_step,
        make_train_step,
    )

    rc = recipe(config)
    dtype = model.compute_dtype
    enc_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
    enc = model.prepare_encodings(batch, enc_dtype)
    levels = tuple(float(x) for x in batch.metadata.atmos_levels)
    whole = batch.to(device, dtype)
    if mesh is not None:
        surf, static, atmos = shard_batch_arrays(whole.surf_vars, whole.static_vars,
                                                 whole.atmos_vars, mesh)
    else:
        surf, static, atmos = whole.surf_vars, whole.static_vars, whole.atmos_vars
    if rc["targets"] == "zeros":
        tgt_s = {k: torch.zeros_like(v[:, -1]) for k, v in whole.surf_vars.items()}
        tgt_a = {k: torch.zeros_like(v[:, -1]) for k, v in whole.atmos_vars.items()}
    else:
        tgt_s = {k: v[:, -1] for k, v in whole.surf_vars.items()}
        tgt_a = {k: v[:, -1] for k, v in whole.atmos_vars.items()}
    weights = torch.cos(torch.deg2rad(torch.as_tensor(np.asarray(batch.metadata.lat),
                                                      dtype=torch.float64))).to(device, dtype)
    lora_loss = partial(mae_loss, lat_weights=weights) if rc["lat_weighted"] else mae_loss
    names = {p: n for n, p in model.named_parameters()}
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    scope = mesh if mesh is not None else contextlib.nullcontext()
    out: dict = {}
    if mesh is not None:
        out["coords"] = dict(mesh.coords, shape=dict(mesh.shape))

    def timed(name, call):
        halo.reset_stats()
        before = dict(_lib.LAUNCHES)
        _sync(device)
        t = time.perf_counter()
        loss = float(call())
        _sync(device)
        out[name] = dict(loss=loss, seconds=time.perf_counter() - t, halo=halo.report(),
                         launches={k: v - before[k] for k, v in _lib.LAUNCHES.items()
                                   if v != before[k]})
        return out[name]

    def recorded(name, opt):
        out[name].update(grads={names[p]: g for p, g in opt.grads.items()},
                         local_grads={names[p]: g for p, g in opt.local.items()},
                         params={names[p]: p.detach().cpu().clone() for p in opt.grads})

    with scope:
        if "forward" in which:
            def forward():
                with torch.no_grad():
                    ps, pa = model.forward_core(surf, static, atmos, enc, 0, levels)
                out["predictions"] = {k: v.cpu() for k, v in {**ps, **pa}.items()}
                return 0.0

            timed("forward", forward)
        if "lora" in which:
            opt = RecordingAdamW(rc["lr"], 0.0, 1, lora_mask)
            step = make_train_step(model, opt, levels, loss_fn=lora_loss)
            timed("lora", lambda: step(surf, static, atmos, enc, 0, tgt_s, tgt_a))
            recorded("lora", opt)
        if "rollout" in which:
            opt = RecordingAdamW(rc["lr"], 0.0, 1, lora_mask)
            step = make_rollout_train_step(model, opt, levels, ROLLOUT_K)
            abs_t = torch.stack([model.step_encodings(
                [t + i * model.cfg.timestep for t in batch.metadata.time], enc_dtype)[0]
                for i in range(ROLLOUT_K)])
            timed("rollout", lambda: step(
                surf, static, atmos, enc, abs_t, 0,
                {k: torch.stack([v] * ROLLOUT_K) for k, v in tgt_s.items()},
                {k: torch.stack([v] * ROLLOUT_K) for k, v in tgt_a.items()}))
            recorded("rollout", opt)
        if "stochastic" in which:
            with torch.no_grad():  # the deterministic loss at the same weights, beside it
                ps, pa = model.forward_core(surf, static, atmos, enc, 0, levels)
                mesh_t = train_mesh(model)
                det = float(global_mean(mae_loss(ps, pa, *_local_targets(
                    mesh_t, surf, tgt_s, tgt_a, 0)), mesh_t))
            model.set_knobs(**STOCHASTIC)
            opt = RecordingAdamW(rc["lr"], 0.0, 1, lora_mask)
            step = make_train_step(model, opt, levels)
            gen = torch.Generator(device=device).manual_seed(seed)
            timed("stochastic", lambda: step(surf, static, atmos, enc, 0, tgt_s, tgt_a,
                                             generator=gen))
            recorded("stochastic", opt)
            out["stochastic"]["deterministic_loss"] = det
            model.set_knobs(**dict.fromkeys(STOCHASTIC, 0.0))
        if "full" in which:
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(init[n])
                    p.requires_grad_(True)
            out["probe_init"] = init[PROBE].cpu() if PROBE in init else None
            if mesh is not None:
                shard_params(model, mesh)
            opt = adamw(rc["lr"])
            step = make_train_step(model, opt, levels)
            timed("full", lambda: step(surf, static, atmos, enc, 0, tgt_s, tgt_a))
            zp = getattr(model, "_zero_placement", None)
            if zp is not None:
                params = dict(model.named_parameters())
                out["split"] = {n: dict(param=int(np.prod(shape)), slice=params[n].numel(),
                                        moments=[opt.opt.state[params[n]][m].numel()
                                                 for m in ("exp_avg", "exp_avg_sq")])
                                for n, (ax, shape) in zp.split.items()}
            with gathered_params(model):
                out["full"]["params"] = {n: p.detach().cpu().clone()
                                         for n, p in model.named_parameters()}
            if ckpt is not None:
                save_train_state(ckpt, model, opt, step=1)
                save_params(model, ckpt + ".params")
                again = rebuild()
                if mesh is not None:
                    shard_params(again, mesh)
                opt2 = adamw(rc["lr"]).init(again)
                step_no = restore_train_state(ckpt, again, opt2)
                same = _same_state(model, opt, again, opt2)
                with torch.no_grad():
                    for p in again.parameters():
                        p.zero_()
                restore_params(ckpt + ".params", like=again)
                out["checkpoint"] = dict(step=step_no, bits_equal=same and all(
                    torch.equal(p, q) for p, q in zip(model.parameters(), again.parameters())))
    return out


def _same_state(model, opt, other, other_opt) -> bool:
    """Whether two models and their bound AdamW hold the same bits (each rank its slices)."""
    a, b = dict(model.named_parameters()), dict(other.named_parameters())
    if sorted(a) != sorted(b) or not all(torch.equal(a[n], b[n]) for n in a):
        return False
    for p, q in zip(opt.params, other_opt.params, strict=True):
        sa, sb = opt.opt.state[p], other_opt.opt.state[q]
        if sorted(sa) != sorted(sb) or not all(torch.equal(torch.as_tensor(sa[k]),
                                                           torch.as_tensor(sb[k])) for k in sa):
            return False
    return True


def run(device, mesh=None, params: Optional[str] = None, depths: Optional[int] = None,
        seed: int = 0) -> dict:
    """The forward, the LoRA step, the roll-out step and the full fine-tune step on this
    rank's slice under ``mesh`` (a data mesh), or on the whole batch without one
    (:func:`train_steps`, the small model's recipe). Returns what the launcher compares:
    the whole forward, the losses, the gradients, the updated parameters (whole) and, under
    the mesh, the size of each split parameter and of its AdamW moments on this rank."""
    import contextlib

    from aurora_tpu_torch.parallel import gather_batch, shard_batch_arrays
    from aurora_tpu_torch.rollout import rollout

    t0 = time.perf_counter()
    times = {}
    model = build(device, params, depths, seed)
    batch = make_inputs(device.type, seed).crop(model.cfg.patch_size)
    enc = model.prepare_encodings(batch, torch.float32)
    atmos_levels = tuple(float(x) for x in batch.metadata.atmos_levels)
    whole = batch.to(device, torch.float32)
    if mesh is not None:
        surf, static, atmos = shard_batch_arrays(whole.surf_vars, whole.static_vars,
                                                 whole.atmos_vars, mesh)
    else:
        surf, static, atmos = whole.surf_vars, whole.static_vars, whole.atmos_vars
    scope = mesh if mesh is not None else contextlib.nullcontext()
    out: dict = {}
    with scope:
        with torch.no_grad():
            ps, pa = model.forward_core(surf, static, atmos, enc, 0, atmos_levels)
        out["forward"] = {k: v.cpu() for k, v in {**gather_batch(ps), **gather_batch(pa)}.items()}
        # ``rollout`` (``Aurora.forward``) on this rank's part of the batch: its first step.
        part = dataclasses.replace(batch, surf_vars=surf, static_vars=static, atmos_vars=atmos)
        pred = next(rollout(model, part, 1))
        out["rollout_forward"] = {k: v.cpu() for k, v in gather_batch(
            {**pred.surf_vars, **pred.atmos_vars}).items()}
    times["forward"] = time.perf_counter() - t0
    steps = train_steps(device, mesh, model, batch, ("lora", "rollout", "full"), seed)
    for name in ("lora", "rollout"):
        out[f"{name}_loss"] = steps[name]["loss"]
        out[f"{name}_grads"] = steps[name]["grads"]
        out[f"{name}_local_grads"] = steps[name]["local_grads"]
    out["lora_params"] = steps["lora"]["params"]
    out["full_loss"] = steps["full"]["loss"]
    out["full_params"] = steps["full"]["params"]
    out["probe_init"] = steps["probe_init"]
    if "split" in steps:
        out["split"] = steps["split"]
    times.update({f"{k}_step": steps[k]["seconds"] for k in ("lora", "rollout", "full")})
    out["seconds"] = times
    return out


def train_jobs(args) -> dict[str, list[str]]:
    """``--train`` as ``{config: [steps]}``: entries ``step`` (of ``--config``) or
    ``config:step``, in :data:`TRAIN_STEPS` order."""
    jobs: dict = {}
    for item in (args.train or "").split(","):
        if not item:
            continue
        config, _, step = item.rpartition(":")
        config = config or args.config
        if step not in TRAIN_STEPS or config not in ("small", "production"):
            raise ValueError(f"--train {item}: steps {TRAIN_STEPS}, configs small, production")
        jobs.setdefault(config, []).append(step)
    return {c: [t for t in TRAIN_STEPS if t in steps] for c, steps in jobs.items()}


def build_train(device, args, config: str):
    """The model of a config's train steps: the small model as :func:`build` makes it (in
    ``--dtype``, rematerialised at ``--remat``'s scope), or the production model as
    ``tools.train_bench`` builds its LoRA recipe (``remat`` at "full"; seeded from
    ``--seed``; ``--train-depths`` blocks a stage)."""
    if config == "production":
        from aurora_tpu_torch.tools import train_bench

        d = args.train_depths
        cut = {} if d is None else dict(encoder_depths=(d,) * 3, decoder_depths=(d,) * 3)
        return train_bench.build(train_bench.train_config().replace(**cut), device, "lora",
                                 seed=args.seed)
    model = build(device, args.params, args.depths, args.seed, args.width,
                  getattr(torch, args.dtype))
    if args.remat != "none":
        model.set_knobs(remat=True, remat_scope=args.remat)
    return model


def train_grids(args, config: str, device_type: str) -> list[tuple[int, int]]:
    """The grids of a config's train steps: ``--grids`` for ``--config``'s, else the
    config's default (721 x 1440 for the production model, the device's layout for the
    small one)."""
    if config == args.config and args.grids:
        return _grids(args, device_type)
    return [(721, 1440)] if config == "production" else [LAYOUTS[device_type][1]]


def train_inputs(args, config: str, device_type: str, grid) -> "Batch":  # noqa: F821
    """The whole batch of a config's train steps on ``grid``, cropped to the patch: the main
    path's (``numpy_batch``, batch 1) for the production model, the JAX tool's draws (batch
    2, as float64 with ``--dtype float64``) for the small one."""
    if config == "production":
        from aurora_tpu_torch.tools import train_bench
        from aurora_tpu_torch.tools.perf_breakdown import numpy_batch

        cfg = train_bench.train_config()
        return numpy_batch(cfg, *grid, seed=args.seed).crop(cfg.patch_size)
    batch = make_inputs(device_type, args.seed, grid, batch=B)
    if args.dtype == "float64":
        batch = batch.astype(torch.float64)
    return batch.crop(4)


def _grid_key(batch) -> str:
    return "x".join(str(n) for n in batch.spatial_shape)


def run_spatial_train(device, mesh, args, folder: str, inputs: Optional[dict] = None) -> dict:
    """The train half of a ``(lat, lon)`` run (:func:`train_jobs`): per config, the LoRA,
    roll-out and stochastic steps on each of its grids under the mesh's ``(lat, lon)`` plane
    (``make_mesh(1, lat, lon)``; with ``data`` above 1 the planes take the grids in turn),
    then the full step on its first grid under the whole mesh, ``shard_params`` placing the
    parameters over ``data``, its training state saved in ``folder`` and restored under the
    mesh. Without a mesh (the launcher's reference) the same steps on the whole batch, in one
    process. ``inputs``: batches made ahead, by (config, grid)."""
    from aurora_tpu_torch.parallel import make_mesh

    if mesh is None:
        planes, g, D = [None], 0, 1
    else:
        D, A, O = (mesh.shape[a] for a in ("data", "lat", "lon"))
        planes = [mesh] if D == 1 else [
            make_mesh(1, A, O, devices=range(i * A * O, (i + 1) * A * O), device=args.device)
            for i in range(D)]
        g = mesh.axis_index("data")
    out: dict = {}
    if device.type == "cuda":  # what the serving half cached goes back to the card
        torch.cuda.empty_cache()
    for config, steps in train_jobs(args).items():
        res = out[config] = {"grids": {}}
        grids = train_grids(args, config, device.type)
        batches = [(inputs or {}).get((config, grid)) for grid in grids]
        batches = [b if b is not None else train_inputs(args, config, device.type, grid)
                   for b, grid in zip(batches, grids)]
        plane_steps = [t for t in steps if t != "full"]
        for i, batch in enumerate(batches):
            if plane_steps and i % D == g:
                model = build_train(device, args, config)
                res["grids"][_grid_key(batch)] = train_steps(
                    device, planes[g], model, batch, plane_steps, args.seed, config)
                del model
                if device.type == "cuda":
                    torch.cuda.empty_cache()
        if "full" in steps:
            model = build_train(device, args, config)
            ckpt = None if mesh is None else os.path.join(folder, f"train_state_{config}.pt")
            res["full"] = train_steps(device, mesh, model, batches[0], ("full",), args.seed,
                                      config, rebuild=lambda: build_train(device, args, config),
                                      ckpt=ckpt)
            res["full"]["grid"] = _grid_key(batches[0])
            res["full"]["ckpt"] = ckpt
    return out


def spawn_workers(n: int, folder: str, device: str, params: Optional[str] = None,
                  depths: Optional[int] = None, seed: int = 0, hold: bool = False,
                  extra: tuple = ()) -> list[subprocess.Popen]:
    """Start ``n`` worker processes on ``device`` ("cpu" or "cuda") whose process group
    meets in a ``FileStore`` under ``folder``; each writes ``rank<i>.pt`` there
    (:func:`collect`). With ``hold`` each makes its host side ready (:func:`ready_host`) and
    then waits for :func:`release` before it touches the device. ``n`` ranks of the data
    axis, or with ``extra`` the layout and options of a (lat, lon) run (``("--lat", "2",
    ...)``, ``n`` the product of the axes)."""
    env = dict(os.environ, OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "2"))
    store = os.path.join(folder, "store")
    cmd = [sys.executable, "-m", "aurora_tpu_torch.tools.multihost_sim", "--role", "worker",
           "--store", store, "--device", device, "--seed", str(seed)]
    cmd += list(extra) if extra else ["--data", str(n)]
    cmd += ["--params", params] if params else []
    cmd += ["--depths", str(depths)] if depths else []
    cmd += ["--hold"] if hold else []
    return [subprocess.Popen(cmd + ["--rank", str(i)], cwd=ROOT, env=env) for i in range(n)]


def release(folder: str) -> None:
    """Let the held workers of ``folder`` go on."""
    with open(os.path.join(folder, "go"), "w"):
        pass


def ready_host() -> None:
    """Do ahead the host-side work that a process's first train step does once: AdamW's
    first step imports torch's compiler stack (seconds of host time), here on a CPU
    tensor."""
    p = torch.zeros(1, requires_grad=True)
    p.grad = torch.zeros(1)
    torch.optim.AdamW([p]).step()


def collect(procs: list[subprocess.Popen], folder: str, timeout: float = 900) -> list[dict]:
    """Wait for the workers and read each rank's results; raise where one failed."""
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(rcs):
        raise RuntimeError(f"worker exit codes {rcs}")
    return [torch.load(os.path.join(folder, f"rank{i}.pt"), weights_only=False)
            for i in range(len(procs))]


def worker(rank: int, n: int, store: str, args) -> None:
    from aurora_tpu_torch.ops import _lib
    from aurora_tpu_torch.parallel import initialize, make_mesh, process_summary, replicate

    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "2")))
    spatial = args.lat > 1 or args.lon > 1
    inputs = train_in = None
    if args.hold:  # until released; a worker whose launcher is gone stops
        ready_host()  # the train steps' optimiser
        if spatial:  # the batches on the host, made while held
            cfg = spatial_config(args)
            inputs = {} if args.no_serve else {g: spatial_inputs(cfg, args.device, args, g)
                                               for g in _grids(args, args.device)}
            train_in = {(c, g): train_inputs(args, c, args.device, g) for c in train_jobs(args)
                        for g in train_grids(args, c, args.device)}
        go, parent = os.path.join(os.path.dirname(store), "go"), os.getppid()
        while not os.path.exists(go):
            if os.getppid() != parent:
                raise SystemExit("multihost_sim worker: the launcher is gone")
            time.sleep(0.05)
    initialize(coordinator_address=f"file://{store}", num_processes=n, process_id=rank)
    mesh = make_mesh(data=args.data, lat=args.lat, lon=args.lon, device=args.device)
    if spatial:
        out = {"grids": {}} if args.no_serve else run_spatial(mesh.device, mesh, args, inputs)
        if train_jobs(args):
            out["train"] = run_spatial_train(mesh.device, mesh, args, os.path.dirname(store),
                                             train_in)
        out["launches"] = {k: v for k, v in _lib.LAUNCHES.items() if v}
        if rank:  # the gathered predictions are the same on every rank; the first keeps them
            for g in out["grids"].values():
                for key in ("forward", "rollout", "scan"):
                    g.pop(key, None)
            out.get("deep", {}).pop("forward", None)
    else:
        out = run(mesh.device, mesh, args.params, args.depths, args.seed)
        # ``replicate`` broadcasts the first rank's values: every rank ends with rank 0's.
        mine = torch.full((4,), float(rank), device=mesh.device)
        out["replicated"] = replicate({"x": mine}, mesh)["x"].tolist()
        out["launches"] = {k: v for k, v in _lib.LAUNCHES.items() if v}
        if rank:  # the whole results are the same on every rank; the first one keeps them
            out = {k: out[k] for k in ("split", "summary", "backend", "seconds", "full_loss",
                                       "launches", "replicated") if k in out}
    out["summary"] = process_summary()
    out["backend"] = torch.distributed.get_backend()
    out["coords"] = mesh.coords
    torch.save(out, os.path.join(os.path.dirname(store), f"rank{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def _max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / (a.abs().max() + 1e-30))


def compare(ref: dict, ranks: list[dict]) -> dict:
    """The checks of the data-parallel results ``ranks`` (rank 0's whole, the others' split
    sizes) against the one-process run ``ref``."""
    got = ranks[0]
    n = len(ranks)
    fwd = max(_max_rel(ref[f][k], got[f][k]) for f in ("forward", "rollout_forward")
              for k in ref[f])

    def worst(step: str, kind: str = "grads") -> float:
        want = ref[f"{step}_grads"]
        return max(_max_rel(want[k], got[f"{step}_{kind}"][k]) for k in want)

    grad, rollout_grad = worst("lora"), worst("rollout")
    # AdamW's first update of an element is about lr * g / (|g| + 1e-8): where |g| is
    # rounding noise its sign is too, so the parameter check takes the elements whose
    # gradient is resolved (|g| >= RESOLVED in the one-process run).
    resolved = {k: ref["lora_grads"][k].abs() >= RESOLVED for k in ref["lora_grads"]}
    lora = max(_max_rel(ref["lora_params"][k] * m, got["lora_params"][k] * m)
               for k, m in resolved.items())
    lora_all = max(_max_rel(ref["lora_params"][k], got["lora_params"][k])
                   for k in ref["lora_params"])
    full = {k: _max_rel(ref["full_params"][k], got["full_params"][k])
            for k in ref["full_params"]}
    loss = {m: abs(got[m] - ref[m]) / abs(ref[m])
            for m in ("lora_loss", "rollout_loss", "full_loss")}
    split_ok = all(s["slice"] * n == s["param"] and all(m == s["slice"] for m in s["moments"])
                   for r in ranks for s in r["split"].values())
    losses_agree = all(r["full_loss"] == got["full_loss"] for r in ranks)
    replicated = all(r["replicated"] == [0.0] * 4 for r in ranks)
    ok = (fwd <= FORWARD_TOL and grad <= PARAM_TOL and lora <= PARAM_TOL
          and rollout_grad <= ROLLOUT_GRAD_TOL
          and full[PROBE] <= PARAM_TOL
          and max(loss.values()) <= LOSS_TOL and split_ok and losses_agree and replicated
          and len(got["split"]) > 0)
    return dict(forward_max_rel=fwd, lora_grad_max_rel=grad,
                rollout_grad_max_rel=rollout_grad,
                # What the gradient checks read had rank 0 skipped the average: a fault.
                lora_grad_unaveraged_max_rel=worst("lora", "local_grads"),
                rollout_grad_unaveraged_max_rel=worst("rollout", "local_grads"),
                lora_param_max_rel=lora,
                lora_param_max_rel_all=lora_all,
                lora_unresolved=sum(int((~m).sum()) for m in resolved.values()),
                full_param_max_rel=max(full.values()), probe=PROBE,
                probe_max_rel=full[PROBE], loss_rel=loss,
                losses=dict(lora=got["lora_loss"], rollout=got["rollout_loss"],
                            full=got["full_loss"]),
                split_params=len(got["split"]),
                split_fraction=sum(s["param"] for s in got["split"].values())
                / sum(v.numel() for v in ref["full_params"].values()),
                moments_are_slices=split_ok, ranks_agree_on_loss=losses_agree,
                replicate_from_rank0=replicated,
                tol=dict(forward=FORWARD_TOL, params=PARAM_TOL, loss=LOSS_TOL,
                         rollout_grads=ROLLOUT_GRAD_TOL), ok=ok)


def result(ref: dict, ranks: list[dict], device: str, seconds: float) -> dict:
    """The tool's JSON line: :func:`compare`'s checks and what each rank ran."""
    n = len(ranks)
    return dict(metric="multihost_sim", processes=n, mesh=dict(data=n, lat=1, lon=1),
                device=device, backend=ranks[0]["backend"],
                process_summary=ranks[0]["summary"], **compare(ref, ranks),
                launches_per_rank=[r["launches"] for r in ranks],
                seconds=dict(total=seconds, reference=ref["seconds"],
                             rank0=ranks[0]["seconds"]))


def _mean_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().mean() / (b.abs().mean() + 1e-30))


def geometry(reports: list[dict], mesh_shape: dict) -> dict:
    """What the ranks' blocks saw on one grid (their ``halo.report()``): the stages whose
    grid was over-padded (``extra``), the patch merges of a block of odd extent, the grids
    split unevenly (blocks of unequal extent), the shifted blocks whose halo crossed the
    ``lat`` and the ``lon`` lines, the encoders run whole (a pixel grid the mesh does not
    split into whole patches), and the bytes each rank sent per shifted block (the most)
    and over the run."""
    seen = [dict(s, rank=i) for i, r in enumerate(reports) for s in r["seen"]]
    blocks = [s for s in seen if s["kind"] == "block"]
    la, lo = mesh_shape["lat"], mesh_shape["lon"]

    def uneven(n, k):
        from aurora_tpu_torch.parallel.sharding import split_bounds

        return len({b - a for a, b in split_bounds(n, k)}) > 1

    shifted = [s for s in blocks if any(s["shift"])]
    return dict(
        overpadded=sorted({(tuple(s["res"]), tuple(s["extra"])) for s in blocks
                           if any(s["extra"])}),
        odd_merges=sorted({(tuple(s["res"]), tuple(s["rows"])) for s in seen
                           if s["kind"] == "merge" and s["odd"]}),
        uneven=sorted({tuple(s["res"]) for s in blocks
                       if uneven(s["res"][1], la) or uneven(s["res"][2], lo)}),
        shifted_lat=la > 1 and any(s["shift"][1] for s in shifted),
        shifted_lon=lo > 1 and any(s["shift"][2] for s in shifted),
        encoder_whole=any(s["kind"] == "encoder" and not s["local"] for s in seen),
        encoder_local=any(s["kind"] == "encoder" and s["local"] for s in seen),
        shifted_block_bytes=max((s["bytes"] for s in shifted), default=0),
        block_bytes=[sorted({(tuple(s["res"]), tuple(s["shift"]), s["bytes"]) for s in blocks
                             if s["rank"] == i}) for i in range(len(reports))],
        bytes_sent=[r["bytes_sent"] for r in reports],
        largest_sent=max(r["largest_sent"] for r in reports),
        collectives=[r["collectives"] for r in reports],
    )


def compare_spatial(ref: dict, ranks: list[dict], mesh_shape: dict,
                    production: bool = False) -> dict:
    """The checks of a (lat, lon) run: per grid, the gathered forward, each roll-out step
    and each host-offload step against the one-process run (max-rel within
    :data:`FORWARD_TOL`, mean-rel beside it; the production model: mean-rel per variable
    within :data:`PRODUCTION_TOL`), every rank's launches, and :func:`geometry`."""
    got = ranks[0]
    out, ok = {}, True
    for key, want in ref["grids"].items():
        g = got["grids"][key]
        parts = [("forward", want["forward"], g["forward"])]
        parts += [(f"rollout {i + 1}", w, h) for i, (w, h) in
                  enumerate(zip(want["rollout"], g["rollout"]))]
        parts += [(f"scan {i + 1}", w, h) for i, (w, h) in
                  enumerate(zip(want.get("scan", []), g.get("scan", [])))]
        max_rel = {n: max(_max_rel(h[k], w[k]) for k in w) for n, w, h in parts}
        mean_rel = {n: max(_mean_rel(h[k], w[k]) for k in w) for n, w, h in parts}
        shapes = all(h[k].shape == w[k].shape for _, w, h in parts for k in w)
        steps_ok = len(g["rollout"]) == len(want["rollout"])
        if production:
            worst = max(_mean_rel(h[k], w[k]) for _, w, h in parts for k in w)
            grid_ok = shapes and steps_ok and worst <= PRODUCTION_TOL
        else:
            grid_ok = shapes and steps_ok and max(max_rel.values()) <= FORWARD_TOL
        ok = ok and grid_ok
        out[key] = dict(max_rel=max_rel, mean_rel=mean_rel, ok=grid_ok,
                        geometry=geometry([r["grids"][key]["halo"] for r in ranks], mesh_shape),
                        launches_per_rank=[r["grids"][key]["launches"] for r in ranks],
                        step_s_per_rank=[r["grids"][key]["step_s"] for r in ranks],
                        forward_s_per_rank=[r["grids"][key]["forward_s"] for r in ranks],
                        reference_step_s=want["step_s"])
    res = dict(grids=out)
    if "deep" in ref:
        w, h = ref["deep"]["forward"], got["deep"]["forward"]
        deep = dict(grid=ref["deep"]["grid"], depth=ref["deep"]["depth"],
                    max_rel=max(_max_rel(h[k], w[k]) for k in w),
                    mean_rel=max(_mean_rel(h[k], w[k]) for k in w))
        deep["ok"] = (sorted(h) == sorted(w) and all(h[k].shape == w[k].shape for k in w)
                      and deep["max_rel"] <= FORWARD_TOL)
        ok = ok and deep["ok"]
        res["deep"] = deep
    return dict(res, ok=ok)


def result_spatial(ref: dict, ranks: list[dict], mesh_shape: dict, device: str,
                   seconds: float, checkpoints: Optional[dict] = None) -> dict:
    """The tool's JSON line of a (lat, lon) run: the serving half's checks
    (:func:`compare_spatial`) and the train half's (:func:`compare_train`, with the
    one-process restores of the saved states, ``checkpoints``)."""
    production = ref.get("config") == "production"
    tol = dict(mean_rel=PRODUCTION_TOL) if production else dict(forward=FORWARD_TOL)
    serve = compare_spatial(ref, ranks, mesh_shape, production)
    out = dict(metric="multihost_sim", processes=len(ranks), mesh=mesh_shape, device=device,
               backend=ranks[0]["backend"], process_summary=ranks[0]["summary"],
               tol=tol, **serve,
               seconds=dict(total=seconds, reference=ref.get("seconds"),
                            ranks=[r.get("seconds") for r in ranks]))
    if "train" in ref:
        train = compare_train(ref["train"], ranks, mesh_shape)
        train["checkpoint_one_process"] = checkpoints or {}
        train["tol"] = dict(small=TRAIN_TOL, production=PRODUCTION_TRAIN_TOL,
                            resolved=RESOLVED)
        out["train"] = train
        out["ok"] = serve["ok"] and train["ok"] and all(
            c["ok"] for c in (checkpoints or {}).values())
    return out


TRAIN_TOL = dict(loss=LOSS_TOL, lora=PARAM_TOL, stochastic=PARAM_TOL,
                 rollout=ROLLOUT_GRAD_TOL, probe=PARAM_TOL)  # the small model's, max-rel
# The production model's LoRA step (bf16 backbone) against one process: the loss relative
# and the concatenated LoRA gradient relative L2, the train phase's card-against-CPU bar.
PRODUCTION_TRAIN_TOL = dict(loss=1e-2, grads=5e-2)


def _masked_max_rel(got: dict, want: dict) -> float:
    """Max-rel over the elements whose reference gradient is resolved (``|g| >= RESOLVED``)."""
    out = 0.0
    for k, w in want.items():
        m = w.abs() >= RESOLVED
        if m.any():
            out = max(out, _max_rel(got[k][m], w[m]))
    return out


def _rel_l2(got: dict, want: dict) -> float:
    a = torch.cat([got[k].double().flatten() for k in want])
    b = torch.cat([want[k].double().flatten() for k in want])
    return float((a - b).norm() / b.norm())


def compare_step(want: dict, got: dict, step: str, production: bool = False) -> dict:
    """One train step of a rank against the one-process step: the loss, the gradients (the
    reduced ones, and this rank's own as the backward left it: what a check would read had
    it skipped the sums), the updated parameters where the gradient is resolved."""
    loss = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    row = dict(loss=got["loss"], loss_ref=want["loss"], loss_rel=loss,
               seconds=got["seconds"], bytes_sent=got["halo"]["bytes_sent"],
               collectives=got["halo"]["collectives"], launches=got["launches"])
    if step == "full":
        full = {k: _max_rel(got["params"][k], want["params"][k]) for k in want["params"]}
        row.update(param_max_rel=max(full.values()), param_mean_rel=max(
            _mean_rel(got["params"][k], want["params"][k]) for k in want["params"]))
        if PROBE in full:
            row["probe_max_rel"] = full[PROBE]
        row["ok"] = loss <= TRAIN_TOL["loss"] and full.get(PROBE, 0.0) <= TRAIN_TOL["probe"]
        return row
    g, w = got["grads"], want["grads"]
    row.update(grad_max_rel=max(_max_rel(g[k], w[k]) for k in w),
               grad_mean_rel=max(_mean_rel(g[k], w[k]) for k in w),
               grad_resolved_max_rel=_masked_max_rel(g, w),
               grad_rel_l2=_rel_l2(g, w),
               unreduced_grad_max_rel=max(_max_rel(got["local_grads"][k], w[k]) for k in w),
               unreduced_grad_rel_l2=_rel_l2(got["local_grads"], w),
               param_max_rel=max(_max_rel(got["params"][k] * (w[k].abs() >= RESOLVED),
                                          want["params"][k] * (w[k].abs() >= RESOLVED))
                                 for k in w),
               param_mean_rel=max(_mean_rel(got["params"][k], want["params"][k]) for k in w))
    if production:
        row["ok"] = (loss <= PRODUCTION_TRAIN_TOL["loss"]
                     and row["grad_rel_l2"] <= PRODUCTION_TRAIN_TOL["grads"])
    else:
        tol = TRAIN_TOL[step]
        grads = row["grad_max_rel"] if step == "rollout" else row["grad_resolved_max_rel"]
        row["ok"] = loss <= TRAIN_TOL["loss"] and grads <= tol and (
            step == "rollout" or row["param_max_rel"] <= PARAM_TOL)
    return row


def compare_forward(want: dict, got: list[dict], ref_row: dict, production: bool) -> dict:
    """The train half's forward on each rank of a plane (its block of the predictions)
    against the one-process predictions cut to that block."""
    from aurora_tpu_torch.parallel.sharding import split_bounds

    worst = 0.0
    for g in got:
        at = g["coords"]
        for k, w in want.items():
            (a, b), (c, e) = (split_bounds(w.shape[d], at["shape"][x])[at[x]]
                              for d, x in ((-2, "lat"), (-1, "lon")))
            err = (_mean_rel if production else _max_rel)(g["predictions"][k],
                                                          w[..., a:b, c:e])
            worst = max(worst, err)
    tol = PRODUCTION_TOL if production else FORWARD_TOL
    return dict(err=worst, measure="mean_rel" if production else "max_rel", tol=tol,
                ok=worst <= tol, seconds=[g["forward"]["seconds"] for g in got],
                collectives=[g["forward"]["halo"]["collectives"] for g in got])


def compare_train(ref: dict, ranks: list[dict], mesh_shape: dict) -> dict:
    """The train half of a ``(lat, lon)`` run against the one-process run: each step on
    each grid from the first rank of the plane that ran it (:func:`compare_step`), the
    full step from the first rank, every rank's launches of K1-K4 in each step, and the
    checkpoint's restore on every rank bit for bit."""
    D = mesh_shape["data"]
    per = len(ranks) // D
    out, ok = {}, True
    for config, want in ref.items():
        prod = config == "production"
        res = out[config] = {}
        for i, (key, w) in enumerate(want["grids"].items()):
            lead = (i % D) * per
            got = ranks[lead]["train"][config]["grids"][key]
            res[key] = {t: compare_step(w[t], got[t], t, prod) for t in TRAIN_STEPS
                        if t in w and t != "forward"}
            if "forward" in w:
                res[key]["forward"] = compare_forward(
                    w["predictions"], [r["train"][config]["grids"][key] for r in
                                       ranks[lead:lead + per]], w["forward"], prod)
            res[key]["launches_per_rank"] = {
                t: [r["train"][config]["grids"][key][t]["launches"]
                    for r in ranks[lead:lead + per]] for t in res[key]}
            ok = ok and all(v["ok"] for t, v in res[key].items() if t != "launches_per_rank")
        if "full" in want:
            got = ranks[0]["train"][config]["full"]
            row = res["full"] = compare_step(want["full"]["full"], got["full"], "full", prod)
            row["grid"] = got["grid"]
            row["checkpoint_restored_on_every_rank"] = all(
                r["train"][config]["full"].get("checkpoint", {}).get("bits_equal")
                for r in ranks)
            split = [r["train"][config]["full"].get("split", {}) for r in ranks]
            row["moments_are_slices"] = all(
                s["slice"] * D == s["param"] and all(m == s["slice"] for m in s["moments"])
                for r in split for s in r.values())
            row["split_params"] = len(split[0])
            ok = ok and row["ok"] and row["checkpoint_restored_on_every_rank"] and \
                row["moments_are_slices"] and (D == 1 or row["split_params"] > 0)
    return dict(configs=out, ok=ok)


def checkpoint_one_process(args, device, config: str, ranks: list[dict]) -> dict:
    """The training state the ranks saved (``save_train_state`` under the mesh) restored
    into one process: its parameters, and those of their ``save_params`` file, equal the
    ranks' gathered ones bit for bit, and saved again from the one process the file is the
    same, byte for byte."""
    from aurora_tpu_torch.checkpoint import restore_train_state, save_train_state
    from aurora_tpu_torch.training import adamw

    full = ranks[0]["train"][config]["full"]
    path = full["ckpt"]
    model = build_train(device, args, config)
    opt = adamw(recipe(config)["lr"]).init(model)
    step = restore_train_state(path, model, opt)
    want = full["full"]["params"]
    params_equal = all(torch.equal(p.detach().cpu(), want[n])
                       for n, p in model.named_parameters())
    saved = torch.load(path + ".params", map_location="cpu", weights_only=True)
    params_equal = params_equal and sorted(saved) == sorted(model.state_dict()) and all(
        torch.equal(saved[n], want[n]) for n in want)
    # The same name in another folder: ``torch.save`` names the archive's root after the file.
    os.makedirs(os.path.join(os.path.dirname(path), "one_process"), exist_ok=True)
    again = os.path.join(os.path.dirname(path), "one_process", os.path.basename(path))
    save_train_state(again, model, opt, step)
    with open(path, "rb") as f, open(again, "rb") as g:
        same_bytes = f.read() == g.read()
    return dict(step=step, params_equal=params_equal, file_bytes_equal=same_bytes,
                ok=params_equal and same_bytes and step == 1)


def layout(args) -> tuple[int, int, int]:
    """``(data, lat, lon)`` of the arguments: the JAX tool's ``(1, 2, 4)`` when none is
    given, else 1 for each not given."""
    given = (args.data, args.lat, args.lon)
    if all(v is None for v in given):
        return 1, 2, 4
    return tuple(1 if v is None else v for v in given)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--role", default="launcher", choices=["launcher", "worker"])
    ap.add_argument("--data", type=int, default=None, help="ranks of the batch axis")
    ap.add_argument("--lat", type=int, default=None, help="ranks of the grid's rows")
    ap.add_argument("--lon", type=int, default=None, help="ranks of the grid's columns")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--store", default="")
    ap.add_argument("--hold", action="store_true")
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"],
                    help="the card by default; cpu runs the kernels' plain versions")
    ap.add_argument("--seed", type=int, default=0, help="of the weights and the batch")
    ap.add_argument("--params", default=None, help="a save_params file of the model")
    ap.add_argument("--depths", type=int, default=None, help="blocks in every stage")
    ap.add_argument("--width", type=int, default=None, help="the small model's embed_dim")
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    ap.add_argument("--config", default="small", choices=["small", "production"])
    ap.add_argument("--grids", default=None, help="pixel grids HxW,... of a (lat, lon) run")
    ap.add_argument("--steps", type=int, default=SPATIAL_STEPS,
                    help="roll-out steps of a (lat, lon) run's serving half")
    ap.add_argument("--no-scan", action="store_true", help="no host-offload rollout_scan")
    ap.add_argument("--no-serve", action="store_true",
                    help="a (lat, lon) run without its serving half")
    ap.add_argument("--train", default="",
                    help="a (lat, lon) run's train steps, [config:]step,... of "
                         f"{','.join(TRAIN_STEPS)} (default: none)")
    ap.add_argument("--remat", default="full", choices=["full", "no_outer", "blocks", "none"],
                    help="the small model's remat scope in a (lat, lon) run's train steps")
    ap.add_argument("--train-depths", type=int, default=None,
                    help="blocks in every stage of the production model's train steps")
    ap.add_argument("--deep-params", default=None,
                    help="a save_params file of the small model with enc_depth = dec_depth = "
                         f"{DEEP_DEPTH}: a (lat, lon) run adds its forward on the first grid")
    ap.add_argument("--save", default=None, help="write every result to this file")
    args = ap.parse_args(argv)
    args.data, args.lat, args.lon = layout(args)

    if args.role == "worker":
        worker(args.rank, args.data * args.lat * args.lon, args.store, args)
        return {}
    return launch(args)


def launch(args) -> dict:
    t0 = time.perf_counter()
    device = resolve_device(args.device)
    spatial = args.lat > 1 or args.lon > 1
    if device.type == "cuda":
        from aurora_tpu_torch.ops import _lib

        _lib.build()  # once, before the workers load the libraries
    n = args.data * args.lat * args.lon
    extra = () if not spatial else tuple(_worker_flags(args))
    checkpoints = {}
    with tempfile.TemporaryDirectory(prefix="multihost_sim_") as folder:
        procs = spawn_workers(n, folder, device.type, args.params, args.depths, args.seed,
                              extra=extra)
        try:
            if spatial:
                ref = {"grids": {}} if args.no_serve else run_spatial(device, None, args)
                if train_jobs(args):
                    ref["train"] = run_spatial_train(device, None, args, folder)
            else:
                ref = run(device, None, args.params, args.depths, args.seed)
        finally:
            ranks = collect(procs, folder)
        if spatial:
            for config, steps in train_jobs(args).items():
                if "full" in steps:
                    checkpoints[config] = checkpoint_one_process(args, device, config, ranks)
    seconds = time.perf_counter() - t0
    if spatial:
        shape = dict(data=args.data, lat=args.lat, lon=args.lon)
        res = result_spatial(ref, ranks, shape, device.type, seconds, checkpoints)
    else:
        res = result(ref, ranks, device.type, seconds)
    if args.save:
        torch.save(dict(result=res, reference=ref, rank0=ranks[0],
                        ranks=ranks if spatial else None), args.save)
    print(json.dumps(res), flush=True)
    if not res["ok"]:
        raise SystemExit(f"multihost_sim: a check failed: {json.dumps(res)}")
    return res


def _worker_flags(args) -> list[str]:
    """The options a (lat, lon) run passes on to its workers."""
    out = ["--data", str(args.data), "--lat", str(args.lat), "--lon", str(args.lon),
           "--dtype", args.dtype, "--config", args.config, "--train", args.train or "",
           "--steps", str(args.steps)]
    out += ["--width", str(args.width)] if args.width else []
    out += ["--grids", args.grids] if args.grids else []
    out += ["--train-depths", str(args.train_depths)] if args.train_depths else []
    out += ["--remat", args.remat]
    out += ["--no-scan"] if args.no_scan else []
    out += ["--no-serve"] if args.no_serve else []
    out += ["--deep-params", args.deep_params] if args.deep_params else []
    return out


if __name__ == "__main__":
    main()
