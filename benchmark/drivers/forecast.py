"""Traffic of kind ``forecast``: back-to-back roll-outs through the port's
``rollout_scan(model, initial_condition, steps, host_offload=True)``, each prediction fed
back and shipped to pinned host memory as it is made.

Traffic parameters (``benchmark/traffic/<name>.json``): ``steps`` a forecast, ``pool`` (the
initial conditions made from the seed in set-up and cycled), ``warmup_steps``.

Set-up: the model with the seed's weights, the pool (made on the card, copied out to host
arrays as a user hands them), one roll-out of ``warmup_steps`` steps, and the pinned host
buffers of one whole forecast allocated and released once, as a process that has served a
forecast holds them in PyTorch's host allocator cache.

Window: whole forecasts until ``--seconds`` have passed; it ends at the synchronise after
the last forecast's last step. Its metric is the wall time over the steps.

Check (after the window, the model freed): on the last forecast of the window, step 1 from
the initial condition and one step ``s`` in ``[2, steps]`` drawn from the seed, each by the
reference from the inputs that step had: the initial condition for step 1, and for step
``s`` the program's own fed-back predictions ``s - 2`` and ``s - 1`` (the initial
condition's last entry for ``s = 2``). The compared number, ``forecast_rel_l2``, is the worst
over the two steps and the variables of the relative L2 gap in normalised units,
``|(program - reference) / scale| / |(reference - loc) / scale|``.
"""

from __future__ import annotations

import dataclasses
import time
from datetime import timedelta

import numpy as np
import torch

from aurora_tpu_torch.batch import Batch, Metadata
from aurora_tpu_torch.ops import _lib
from aurora_tpu_torch.rollout import rollout_scan

from benchmark import data, program, weights
from benchmark.trace import Phases
from benchmark.reference.aurora import Reference, Step, stats

PARTS = ("encoder", "backbone", "decoder")
METRIC = "forecast_step_s"


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class Forecast:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.steps = int(traffic["steps"])
        self.grid = data.Grid.of(cfg)
        self.phases = Phases(torch.cuda.synchronize if device.type == "cuda" else lambda: None)
        if device.type == "cuda":
            _lib.build()
        self.phases.mark("kernels")
        self.model = program.build(cfg, device, seed)
        self.shapes = program.shapes(self.model)
        self.phases.mark("model")
        gen = torch.Generator(device=device).manual_seed(data.derive(seed, 1))
        t0 = data.start_time(seed)
        self.pool = []
        for i in range(int(traffic["pool"])):
            surf, static, atmos = data.fields(cfg, self.grid, gen, device, self.grid.history)
            self.pool.append(Batch(
                surf_vars={k: _host(v) for k, v in surf.items()},
                static_vars={k: _host(v) for k, v in static.items()},
                atmos_vars={k: _host(v) for k, v in atmos.items()},
                metadata=Metadata(lat=self.grid.lat, lon=self.grid.lon,
                                  time=(t0 + timedelta(days=i),) * self.grid.batch,
                                  atmos_levels=self.grid.levels)))
            del surf, static, atmos
        self.phases.mark("inputs")
        warm = self.forecast(self.pool[0], int(traffic["warmup_steps"]))
        self.phases.mark("warm-up")
        # The pinned buffers of one whole forecast, as rollout_scan allocates them.
        bufs = [torch.empty((self.steps, *v.shape), dtype=torch.float32,
                            pin_memory=device.type == "cuda")
                for group in (warm[0].surf_vars, warm[0].atmos_vars) for v in group.values()]
        del bufs, warm
        self.phases.mark("pinned buffers")
        self.last = None  # (pool index, predictions) of the window's last forecast

    def forecast(self, ic: Batch, steps: int):
        return rollout_scan(self.model, ic, steps, host_offload=True)

    def hook(self, spans) -> None:
        spans.hook("step", self.model)
        for p in PARTS:
            spans.hook(p, getattr(self.model, p))

    def window(self, seconds: float, sync) -> dict:
        t0 = time.perf_counter()
        n = i = 0
        while True:
            preds = self.forecast(self.pool[i % len(self.pool)], self.steps)
            n += self.steps
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
            del preds
        sync()
        wall = time.perf_counter() - t0
        self.last = ((i - 1) % len(self.pool), preds)
        return {METRIC: wall / n, "steps": n, "window_s": wall}

    def release(self) -> None:
        del self.model
        self.model = None

    def check(self, control: str | None = None) -> dict:
        """The compared numbers of the program (module docstring) under ``"program"``, and
        with ``control`` (a precision of :class:`Reference`) those of the reference in that
        precision put in the program's place, under ``"control"``."""
        cfg, dev = self.cfg, self.device
        idx, preds = self.last
        rng = np.random.default_rng(data.derive(self.seed, 2))
        s = int(rng.integers(2, self.steps + 1))
        ic = self.pool[idx]
        crop = self.grid.H - self.grid.H % cfg["patch_size"]

        def dev_t(a):
            return torch.as_tensor(np.asarray(a)[..., :crop, :], device=dev)

        with torch.no_grad():
            w = weights.make(self.shapes, self.seed, dev)
            ref = Reference(cfg, w)
            lower = None if control is None else Reference(cfg, w, precision=control)
            del w
            static = {k: dev_t(v) for k, v in ic.static_vars.items()}
            md = ic.metadata
            first = Step({k: dev_t(v) for k, v in ic.surf_vars.items()}, static,
                         {k: dev_t(v) for k, v in ic.atmos_vars.items()},
                         np.asarray(md.lat)[:crop], np.asarray(md.lon), tuple(md.time),
                         tuple(md.atmos_levels), 0)

            def history(j):  # the inputs of step j + 1 (0-based prediction index j)
                if j == 0:
                    return first
                if j == 1:
                    prev = {g: {k: dev_t(v)[:, -1:] for k, v in grp.items()}
                            for g, grp in (("s", ic.surf_vars), ("a", ic.atmos_vars))}
                else:
                    prev = {"s": {k: dev_t(v) for k, v in preds[j - 2].surf_vars.items()},
                            "a": {k: dev_t(v) for k, v in preds[j - 2].atmos_vars.items()}}
                last = preds[j - 1]
                return dataclasses.replace(
                    first,
                    surf={k: torch.cat([prev["s"][k], dev_t(v)], 1)
                          for k, v in last.surf_vars.items()},
                    atmos={k: torch.cat([prev["a"][k], dev_t(v)], 1)
                           for k, v in last.atmos_vars.items()},
                    times=tuple(t + timedelta(hours=cfg["timestep_hours"] * j) for t in md.time),
                    rollout_step=j)

            worst = dict(program=0.0, control=0.0)
            for j in (0, s - 1):
                st = history(j)
                want_s, want_a = ref.step(st)
                got = {"program": ({k: dev_t(v)[:, 0] for k, v in preds[j].surf_vars.items()},
                                   {k: dev_t(v)[:, 0] for k, v in preds[j].atmos_vars.items()})}
                if lower is not None:
                    got["control"] = lower.step(st)
                for who, (gs, ga) in got.items():
                    worst[who] = max(worst[who], _rel_l2(gs, ga, want_s, want_a, st.levels))
        out = {"program": {"forecast_rel_l2": worst["program"]}, "checked_steps": [1, s]}
        if lower is not None:
            out["control"] = {"forecast_rel_l2": worst["control"]}
        return out


def _rel_l2(got_s, got_a, want_s, want_a, levels) -> float:
    worst = 0.0
    for got, want, lv in ((got_s, want_s, None), (got_a, want_a, levels)):
        for k, w in want.items():
            loc, scale = stats(k, lv)
            if lv is not None:
                loc = torch.as_tensor(loc, dtype=w.dtype, device=w.device)[:, None, None]
                scale = torch.as_tensor(scale, dtype=w.dtype, device=w.device)[:, None, None]
            else:
                loc, scale = float(loc), float(scale)
            g = got[k].to(w.dtype)
            gap = torch.linalg.vector_norm((g - w) / scale)
            size = torch.linalg.vector_norm((w - loc) / scale)
            rel = float(gap / size)
            if not np.isfinite(rel):  # a NaN or an overflow fails the comparison
                return float("inf")
            worst = max(worst, rel)
    return worst


DRIVER = Forecast
