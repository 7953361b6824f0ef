"""The controls of ``benchmark/control.py`` at sizes a test run holds: the reference put in the
program's place in the precision below the configuration's has to come out as not correct
under the committed limits, where the program comes out correct.

On the CPU: the bfloat16 configuration's cells at the small configuration (float8 products).
On the card (TF32 does nothing on the CPU): the float32 configuration's control at its widths,
two blocks a stage, on a 120 x 240 grid, the reference alone."""

import math
from datetime import datetime

import numpy as np
import pytest
import torch

from aurora_tpu_torch.model.aurora import Aurora

from benchmark import control, program, run, weights
from benchmark.drivers.forecast import _rel_l2
from benchmark.reference.aurora import Reference, Step, stats
from benchmark.tests.small import SMALL, traffic_update

SP = run.spec()


def fails(numbers: dict, limits: dict) -> bool:
    return any(not (math.isfinite(numbers[k]) and numbers[k] <= v) for k, v in limits.items())


@pytest.mark.parametrize("name", [w["name"] for w in SP["workloads"]
                                  if run.config(SP, w["config"])["control"] == "fp8"])
def test_the_fp8_control_fails_where_the_program_passes(name):
    rows = control.readings(name, [11, 12], 0.0, torch.device("cpu"), cfg_update=SMALL,
                            traffic_update=traffic_update(name))
    limits = run.limits(name)
    for seed, program, ctrl in rows:
        assert not fails(program, limits), (seed, program)
        assert fails(ctrl, limits), (seed, ctrl)


@pytest.mark.card
def test_the_tf32_control_fails_on_the_card(card):
    name = next(w["name"] for w in SP["workloads"]
                if run.config(SP, w["config"])["control"] == "tf32")
    cfg = dict(run.config(SP, run.workload(SP, name)["config"]), encoder_depths=[2, 2, 2],
               decoder_depths=[2, 2, 2])
    meta = Aurora(program.port_config(cfg), device="meta", seed=None)
    w = weights.make(program.shapes(meta), 5, card)
    H, W, levels = 120, 240, tuple(cfg["grid"]["levels"])
    gen = torch.Generator(device=card).manual_seed(5)

    def field(name, lead, lv=None):
        loc, scale = stats(name, lv)
        z = torch.randn((*lead, H, W), generator=gen, device=card)
        if lv is None:
            return z * float(scale) + float(loc)
        return (z * torch.as_tensor(scale, device=card, dtype=z.dtype)[:, None, None]
                + torch.as_tensor(loc, device=card, dtype=z.dtype)[:, None, None])

    st = Step({k: field(k, (1, 2)) for k in cfg["surf_vars"]},
              {k: field(k, ()) for k in cfg["static_vars"]},
              {k: field(k, (1, 2, len(levels)), levels) for k in cfg["atmos_vars"]},
              np.linspace(90, -90, H + 1)[:H], np.linspace(0, 360, W, endpoint=False),
              (datetime(2020, 6, 1, 12),), levels, 0)
    with torch.no_grad():
        want = Reference(cfg, w).step(st)
        got = Reference(cfg, w, precision="tf32").step(st)
    reading = _rel_l2(*got, *want, levels)
    assert reading > run.limits(name)["forecast_rel_l2"], reading
