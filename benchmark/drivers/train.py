"""Traffic of kind ``train``: the repo's LoRA fine-tune recipe, the step of the port's
``aurora_tpu_torch.training.make_train_step`` with ``mae_loss`` and ``adamw(lr)`` over the
adapters only (``lora_mask``), at the configuration's batch.

Traffic parameters (``benchmark/traffic/<name>.json``): ``pairs`` (the (input, target) pairs
made from the seed and held in pinned host memory, used in turn), ``lr``, ``remat``
(``remat_scope`` or false), ``checked_steps`` (the first steps, which set-up runs through
the window's own call and the reference follows).

Each step uploads the next pair, as a data loader would (the static fields stay on the
card), makes that step's time encodings and calls the train step. Set-up builds the model,
the optimiser and the step once, and runs the first ``checked_steps`` steps with it (the
warm-up), keeping the adapters before them, the AdamW first moments after the first and the
adapters after the last; the window continues the same object with the next pairs, until
``--seconds`` have passed and a synchronise.

Check (after the window, the program freed): the reference follows the same
``checked_steps`` steps on the same pairs from the same weights. Compared, over the adapter
leaves whose reference gradient is at least a thousandth of the median leaf's:
``loss_rel_gap`` (the worst step's ``|loss - reference| / |reference|``),
``grad_norm_gap`` (the first gradient as AdamW got it, from its first moment after one step
``m / (1 - b1)``) and ``update_norm_gap`` (the adapters' change over the checked steps),
each the worst leaf's ``| |program| - |reference| |`` over the larger of the reference's
norm of that leaf and of the median leaf.
"""

from __future__ import annotations

import contextlib
import time
from datetime import timedelta

import numpy as np
import torch

from aurora_tpu_torch.batch import Batch, Metadata
from aurora_tpu_torch.ops import _lib
from aurora_tpu_torch.training import adamw, lora_mask, make_train_step

from benchmark import data, program, weights
from benchmark.trace import Phases, span
from benchmark.reference.aurora import Reference, Step

PARTS = ("encoder", "backbone", "decoder")
METRIC = "train_step_s"
B1 = 0.9


class Train:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.grid = grid = data.Grid.of(cfg)
        self.crop = grid.H - grid.H % cfg["patch_size"]
        self.phases = Phases(torch.cuda.synchronize if device.type == "cuda" else lambda: None)
        if device.type == "cuda":
            _lib.build()
        self.phases.mark("kernels")
        remat = traffic["remat"]
        knobs = dict(remat=bool(remat), remat_scope=remat or "full")
        self.model = program.build(cfg, device, seed, **knobs)
        self.shapes = program.shapes(self.model)
        self.lr = float(traffic["lr"])
        self.phases.mark("model")
        gen = torch.Generator(device=device).manual_seed(data.derive(seed, 3))
        pin = device.type == "cuda"
        t0 = data.start_time(seed)
        self.pairs = []
        self.static = None
        for i in range(int(traffic["pairs"])):
            surf, static, atmos = data.fields(cfg, grid, gen, device, grid.history,
                                              static=self.static is None, H=self.crop)
            tsurf, _, tatmos = data.fields(cfg, grid, gen, device, 0, static=False, H=self.crop)
            if self.static is None:
                self.static = static
            host = [{k: v.cpu().pin_memory() if pin else v.cpu() for k, v in g.items()}
                    for g in (surf, atmos, tsurf, tatmos)]
            self.pairs.append((host, t0 + timedelta(hours=6 * i)))
            del surf, atmos, tsurf, tatmos
        self.meta = Metadata(lat=grid.lat[:self.crop], lon=grid.lon, time=(t0,),
                             atmos_levels=grid.levels)
        self.phases.mark("inputs")
        self.optimizer = adamw(self.lr, trainable=lora_mask)
        self.train_step = make_train_step(self.model, self.optimizer, grid.levels)
        self.adapters = [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]
        self.i = 0
        self.traced = False
        n_checked = int(traffic["checked_steps"])
        self.before = {n: p.detach().float().clone() for n, p in self.adapters}
        self.losses = []
        for j in range(n_checked):
            self.losses.append(float(self.step()))
            if j == 0:
                state = self.optimizer.opt.state
                self.first_grad = {
                    n: (state[p]["exp_avg"].float() if p in state else torch.zeros_like(
                        p, dtype=torch.float32)) / (1 - B1) for n, p in self.adapters}
        self.after = {n: p.detach().float().clone() for n, p in self.adapters}
        self.phases.mark("checked steps")

    def step(self) -> torch.Tensor:
        (surf, atmos, tsurf, tatmos), when = self.pairs[self.i % len(self.pairs)]
        self.i += 1
        dev = self.device

        def up(g):
            return {k: v.to(dev, non_blocking=True) for k, v in g.items()}

        md = Metadata(lat=self.meta.lat, lon=self.meta.lon, time=(when,) * self.grid.batch,
                      atmos_levels=self.grid.levels)
        enc = self.model.prepare_encodings(
            Batch(surf_vars={}, static_vars={}, atmos_vars={}, metadata=md), torch.float32)
        return self.train_step(up(surf), self.static, up(atmos), enc, 0, up(tsurf), up(tatmos))

    def hook(self, spans) -> None:
        """Spans around the model's parts and, in the window, around each step."""
        for p in PARTS:
            spans.hook(p, getattr(self.model, p))
        self.traced = True

    def window(self, seconds: float, sync) -> dict:
        t0 = time.perf_counter()
        n = 0
        while True:
            with span("step") if self.traced else contextlib.nullcontext():
                self.step()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        wall = time.perf_counter() - t0
        return {METRIC: wall / n, "steps": n, "window_s": wall}

    def release(self) -> None:
        del self.train_step, self.optimizer, self.model, self.adapters
        self.model = None

    def check(self, control: str | None = None) -> dict:
        """The compared numbers of the program (module docstring) under ``"program"``, and
        with ``control`` (a precision of :class:`Reference`) those of the reference in that
        precision put in the program's place, under ``"control"``."""
        cfg, dev = self.cfg, self.device
        w = weights.make(self.shapes, self.seed, dev)
        runs = {}
        for prec in ("f32",) + (() if control is None else (control,)):
            ref = Reference(cfg, w, precision=prec, checkpoint=True)
            state, losses, grads = {}, [], None
            before = {n: ref.w[n].clone() for n in ref.adapters()}
            for j in range(len(self.losses)):
                (surf, atmos, tsurf, tatmos), when = self.pairs[j % len(self.pairs)]
                st = Step({k: v.to(dev) for k, v in surf.items()}, self.static,
                          {k: v.to(dev) for k, v in atmos.items()}, self.meta.lat, self.meta.lon,
                          (when,) * self.grid.batch, self.grid.levels, 0)
                out = ref.train_step(st, {k: v.to(dev) for k, v in tsurf.items()},
                                     {k: v.to(dev) for k, v in tatmos.items()}, state, self.lr)
                losses.append(out["loss"])
                if j == 0:
                    grads = out["grads"]
            runs[prec] = (losses, grads, {n: ref.w[n] - before[n] for n in before})
            del ref, state
        got = (self.losses, self.first_grad,
               {n: self.after[n] - self.before[n] for n in self.before})
        out = {"program": numbers(got, runs["f32"])}
        if control is not None:
            out["control"] = numbers(runs[control], runs["f32"])
        return out


def _norms(tree: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.float())) for n, t in tree.items()}


def numbers(got, want) -> dict:
    """``loss_rel_gap``, ``grad_norm_gap`` and ``update_norm_gap`` of ``got`` against ``want``
    (each ``(losses, first gradients, changes)``), as the module docstring says."""
    losses, grads, change = got
    r_losses, r_grads, r_change = want
    if len(losses) != len(r_losses):
        raise ValueError(f"{len(losses)} losses against {len(r_losses)}")
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))
    rg = _norms(r_grads)
    med = float(np.median(list(rg.values())))
    kept = [n for n, v in rg.items() if v >= 1e-3 * med]
    if set(grads) != set(rg) or set(change) != set(r_change):
        raise ValueError("the program's adapters are not the reference's")

    def worst(a: dict, b: dict) -> float:
        na, nb = _norms({n: a[n] for n in kept}), _norms({n: b[n] for n in kept})
        m = float(np.median(list(nb.values())))
        return max(abs(na[n] - nb[n]) / max(nb[n], m) for n in kept)

    out = {"loss_rel_gap": loss_gap, "grad_norm_gap": worst(grads, r_grads),
           "update_norm_gap": worst(change, r_change)}
    out = {k: (v if np.isfinite(v) else float("inf")) for k, v in out.items()}
    out["loss_rel_gap_by_step"] = [abs(a - b) / abs(b) for a, b in zip(losses, r_losses)]
    return out


DRIVER = Train
