"""Fine-tuning: AdamW, the latitude-weighted MAE loss and the train steps (port of
``aurora_tpu/training/train.py``).

A train step runs :meth:`Aurora.forward_core` with gradients, the loss, its backward and one
optimiser call, and updates the model and the optimiser in place: PyTorch's idiom for the
JAX step's donated ``(params, opt_state)``. On the card the forward launches the kernels and
the backward differentiates their plain math (:mod:`aurora_tpu_torch.ops.ad`). The
rematerialisation of ``cfg.remat`` / ``cfg.remat_scope`` happens inside ``forward_core``; the
roll-out train step rematerialises each roll-out step as well, as the JAX step's ``lax.scan``
body is. Both run with TF32 off (:func:`full_f32_products`), their backward included.

The JAX steps' ``rng`` is the steps' ``generator``: with ``cfg.drop_path`` / ``cfg.drop_rate``
above 0 it turns stochastic depth and dropout on. One seed is drawn from it a step, outside
every rematerialised region, and each mask derives from that seed and its place in the model
(:func:`aurora_tpu_torch.model.nn.keep_mask`), so a replay in the backward draws the forward's
masks. The roll-out step folds each step's index into the seed, as the JAX step folds it
into its key. Without a generator a step is deterministic.

Under a mesh (an entered :class:`~aurora_tpu_torch.parallel.Mesh` that splits ``data``,
``lat`` or ``lon``, or a model placed by :func:`~aurora_tpu_torch.parallel.shard_params`),
the counterpart of the JAX steps' SPMD run: each rank gathers its ZeRO-split parameters
once, takes the loss on its part of the batch (the inputs its slice of the batch and its
``(lat, lon)`` block of the grid; the targets and time encodings its part or the whole
batch's, cut here), runs the backward (through the halo moves' transposes under a ``(lat,
lon)`` split), sums the trainable gradients over the ``(lat, lon)`` plane and averages them
over ``data`` in float32 (one flat collective a bucket, the split ones reduce-scattered to
its slice), runs AdamW on what it holds and returns the whole loss. Under a ``(lat, lon)``
split :func:`mae_loss` gives each rank its block's share of the loss, and the stochastic
knobs' masks are each rank's part of the one-process draw. Without a mesh nothing of this
runs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from aurora_tpu_torch.model.aurora import full_f32_products
from aurora_tpu_torch.model.nn import checkpointed, draw_key
from aurora_tpu_torch.parallel.sharding import (
    average_gradients,
    gathered_params,
    global_grid,
    global_mean,
    shard_leading,
    spatial_mesh,
    split_bounds,
    train_mesh,
)
from aurora_tpu_torch.utils.profiling import span

__all__ = [
    "AdamW",
    "adamw",
    "lora_mask",
    "mae_loss",
    "make_rollout_train_step",
    "make_train_step",
]

Mask = Callable[[torch.nn.Module], dict]


def lora_mask(model: torch.nn.Module) -> dict[str, bool]:
    """Parameter name -> whether it belongs to a LoRA adapter bank (a ``lora_qkv`` /
    ``lora_proj`` module). With ``adamw(trainable=lora_mask)``: the LoRA-only recipe, the
    base model frozen."""
    return {name: any(part.startswith("lora_") for part in name.split("."))
            for name, _ in model.named_parameters()}


class AdamW:
    """optax's ``adamw`` (b1 0.9, b2 0.999, ``eps`` 1e-8 outside the square root,
    ``eps_root`` 0, decoupled weight decay) as ``torch.optim.AdamW`` over the trainable
    parameters, whose update is the same; the moments take the parameters' dtype, as optax's.

    ``accum_steps`` > 1 is ``optax.MultiSteps``: each call of :meth:`step` folds the
    gradients into their running mean, and every ``accum_steps``-th call applies AdamW to
    the mean and starts a new cycle; the calls between move nothing.

    Made unbound by :func:`adamw`; :meth:`init` binds it to a model (``optimizer.init(params)``
    in optax)."""

    def __init__(self, lr: float, weight_decay: float, accum_steps: int,
                 trainable: Optional[Mask]):
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.lr, self.weight_decay = lr, weight_decay
        self.accum_steps, self.trainable = accum_steps, trainable
        self.params: list[torch.nn.Parameter] = []
        self.opt: Optional[torch.optim.AdamW] = None
        self.acc: list[torch.Tensor] = []
        self.mini_step = 0

    def init(self, model: torch.nn.Module) -> "AdamW":
        """Freeze the parameters ``trainable`` leaves out (``requires_grad_(False)``, the
        JAX step's ``stop_gradient``: no gradient is computed for them, nor any backward that
        only they would need) and optimise those that still require a gradient. Returns the
        optimiser."""
        if self.trainable is not None:
            mask = self.trainable(model)
            for name, p in model.named_parameters():
                if not mask[name]:
                    p.requires_grad_(False)
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.opt = torch.optim.AdamW(self.params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=self.weight_decay)
        self.acc = [torch.zeros_like(p) for p in self.params] if self.accum_steps > 1 else []
        self.mini_step = 0
        return self

    @torch.no_grad()
    def step(self) -> None:
        """Apply the gradients the parameters hold, then clear them."""
        if self.opt is None:
            raise RuntimeError("AdamW.step before init(model)")
        if self.accum_steps > 1:
            n = self.mini_step
            for p, a in zip(self.params, self.acc):
                if p.grad is not None:
                    a.add_((p.grad - a) / (n + 1))  # optax's running mean
                p.grad = None
            self.mini_step = (n + 1) % self.accum_steps
            if self.mini_step:
                return
            for p, a in zip(self.params, self.acc):
                p.grad = a.clone()
                a.zero_()
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return {"adamw": self.opt.state_dict(), "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["adamw"])
        self.mini_step = int(state["mini_step"])
        for a, saved in zip(self.acc, state["acc"], strict=True):
            a.copy_(saved)


def adamw(lr: float = 3e-4, weight_decay: float = 0.0, accum_steps: int = 1,
          trainable: Optional[Mask] = None) -> AdamW:
    """The reference fine-tuning optimiser (AdamW, 3e-4). ``trainable``: a model -> {name:
    bool} callable (e.g. :func:`lora_mask`); only the marked parameters get optimiser state
    and updates, the others are frozen. ``accum_steps``: gradient accumulation as
    ``optax.MultiSteps``. Bind it with ``init(model)`` (the train steps do)."""
    return AdamW(lr, weight_decay, accum_steps, trainable)


def mae_loss(pred_surf, pred_atmos, tgt_surf, tgt_atmos, lat_weights=None) -> torch.Tensor:
    """Mean absolute error over all variables, optionally latitude-weighted (``lat_weights``
    of shape ``(H,)``), each variable's mean counting once.

    Under a ``(lat, lon)`` mesh the fields are the rank's block of the grid and the result
    is the rank's share of the loss: each variable's sum over the block divided by the
    whole grid's count (blocks are uneven, so a mean of the blocks' means would be wrong),
    which the train steps sum over the plane; ``lat_weights`` are the whole grid's, cut to
    the rank's rows."""
    mesh = spatial_mesh()
    if mesh is not None:
        h, w = next(iter({**pred_surf, **pred_atmos}.values())).shape[-2:]
        H, W = global_grid(h, w, mesh)
        if lat_weights is not None:
            if lat_weights.shape[0] != H:
                raise ValueError(f"lat_weights of {lat_weights.shape[0]} rows for a grid of "
                                 f"{H}: pass the whole grid's")
            a, b = split_bounds(H, mesh.shape["lat"])[mesh.axis_index("lat")]
            lat_weights = lat_weights[a:b]

    def mean(err):
        if mesh is None:
            return err.mean()
        return err.sum() / (err.numel() // (h * w) * H * W)

    total, count = 0.0, 0
    for preds, tgts in ((pred_surf, tgt_surf), (pred_atmos, tgt_atmos)):
        for k, p in preds.items():
            err = (p - tgts[k]).abs()
            if lat_weights is not None:
                err = err * lat_weights[:, None]
            total = total + mean(err)
            count += 1
    return total / count


def _local_targets(mesh, surf, tgt_surf, tgt_atmos, axis: int):
    """The targets cut to this rank's part: its slice of the batch (their ``axis``) where
    they hold the whole batch, and its ``(lat, lon)`` block of the grid (their last two
    axes, by :func:`~aurora_tpu_torch.parallel.sharding.split_bounds`) where they hold the
    whole grid; as they are without a mesh."""
    if mesh is None:
        return tgt_surf, tgt_atmos
    first = next(iter(surf.values()))
    local, (h, w) = first.shape[0], first.shape[-2:]

    def cut(v):
        if mesh.shape["data"] > 1:
            v = shard_leading(v.movedim(axis, 0), mesh, local).movedim(0, axis)
        for dim, n, name in ((-2, h, "lat"), (-1, w, "lon")):
            if v.shape[dim] != n:
                a, b = split_bounds(v.shape[dim], mesh.shape[name])[mesh.axis_index(name)]
                if b - a != n:
                    raise ValueError(f"targets of {v.shape[dim]} along {name}: neither this "
                                     f"rank's block ({n}) nor the whole grid's")
                v = v.narrow(dim, a, n)
        return v

    return ({k: cut(v) for k, v in tgt_surf.items()},
            {k: cut(v) for k, v in tgt_atmos.items()})


def make_train_step(model, optimizer: AdamW, atmos_levels, loss_fn=mae_loss):
    """A train step ``(surf, static, atmos, enc, rollout_step, tgt_surf, tgt_atmos,
    generator=None) -> loss`` of ``model`` (an :class:`Aurora`): the unnormalised inputs and
    targets as ``forward_core`` takes and returns them, ``enc`` from
    ``model.prepare_encodings``, ``generator`` the stochastic knobs' draws. It
    updates the model and ``optimizer`` in place and returns the loss, detached.
    ``optimizer.init(model)`` binds the optimiser here and freezes the parameters its
    ``trainable`` mask leaves out, so that their gradients are never computed (the JAX
    step's ``trainable`` argument)."""
    optimizer.init(model)
    levels = tuple(atmos_levels)

    def train_step(surf, static, atmos, enc, rollout_step, tgt_surf, tgt_atmos,
                   generator: Optional[torch.Generator] = None):
        mesh = train_mesh(model)
        tgt_surf, tgt_atmos = _local_targets(mesh, surf, tgt_surf, tgt_atmos, 0)
        with gathered_params(model), full_f32_products():
            with span("aurora:train.forward"):
                pred_surf, pred_atmos = model.forward_core(surf, static, atmos, enc,
                                                           int(rollout_step), levels,
                                                           generator=generator)
            with span("aurora:train.loss"):
                loss = loss_fn(pred_surf, pred_atmos, tgt_surf, tgt_atmos)
            with span("aurora:train.backward"):
                loss.backward()
            average_gradients(model, mesh)
        with span("aurora:train.adamw"):
            optimizer.step()
        return global_mean(loss.detach(), mesh)

    return train_step


def make_rollout_train_step(model, optimizer: AdamW, atmos_levels, steps: int,
                            loss_fn=mae_loss):
    """A train step that backpropagates through a ``steps``-step autoregressive roll-out,
    the regime that trains the per-roll-out-step LoRA banks (``lora_mode`` "all" /
    "from_second"): ``(surf, static, atmos, enc, abs_t_steps, rollout_step0,
    tgt_surf_steps, tgt_atmos_steps, dyn_steps=None, generator=None) -> loss``.

    The targets have a leading ``steps`` axis; ``abs_t_steps`` is ``(steps, B, D)``, each
    step's absolute-time encoding, and ``dyn_steps`` ``(steps, B, 6)`` the dynamic time
    features that ``dynamic_vars`` models need (both from ``model.step_encodings`` of each
    step's times; ``enc`` gives the grid's encodings). Each step feeds its prediction into
    the history, advances the roll-out step by one and is rematerialised as a whole, so
    the activations kept between steps are one step's inputs; the per-step losses are
    averaged. Updates the model and ``optimizer`` (bound and freezing as in
    :func:`make_train_step`) in place and returns the loss, detached."""
    optimizer.init(model)
    levels = tuple(atmos_levels)

    def body(surf_c, atmos_c, static, enc_i, step, tgt_s, tgt_a, key):
        with span("aurora:train.forward"):
            pred_s, pred_a = model.forward_core(surf_c, static, atmos_c, enc_i, step, levels,
                                                key=key)
        with span("aurora:train.loss"):
            loss_i = loss_fn(pred_s, pred_a, tgt_s, tgt_a)
        surf_n = {k: torch.cat([v[:, 1:], pred_s[k][:, None]], dim=1) for k, v in surf_c.items()}
        atmos_n = {k: torch.cat([v[:, 1:], pred_a[k][:, None]], dim=1)
                   for k, v in atmos_c.items()}
        return loss_i, surf_n, atmos_n

    def train_step(surf, static, atmos, enc, abs_t_steps, rollout_step0, tgt_surf_steps,
                   tgt_atmos_steps, dyn_steps=None, generator: Optional[torch.Generator] = None):
        if model.cfg.dynamic_vars and dyn_steps is None:
            raise ValueError(
                "cfg.dynamic_vars models need the per-step dynamic time features: "
                "pass dyn_steps of shape (steps, B, 6)."
            )
        root = None if generator is None else draw_key(generator)
        mesh = train_mesh(model)
        tgt_surf_steps, tgt_atmos_steps = _local_targets(mesh, surf, tgt_surf_steps,
                                                         tgt_atmos_steps, 1)
        with gathered_params(model), full_f32_products():
            losses = []
            for i in range(steps):
                key = None if root is None else root.fold(i)
                dyn = {} if dyn_steps is None else {"dynamic_scalars": dyn_steps[i]}
                enc_i = dataclasses.replace(enc, absolute_time=abs_t_steps[i], **dyn)
                tgt_s = {k: v[i] for k, v in tgt_surf_steps.items()}
                tgt_a = {k: v[i] for k, v in tgt_atmos_steps.items()}
                loss_i, surf, atmos = checkpointed(True, body, surf, atmos, static, enc_i,
                                                   int(rollout_step0) + i, tgt_s, tgt_a, key)
                losses.append(loss_i)
            loss = torch.stack(losses).mean()
            with span("aurora:train.backward"):
                loss.backward()
            average_gradients(model, mesh)
        with span("aurora:train.adamw"):
            optimizer.step()
        return global_mean(loss.detach(), mesh)

    return train_step
