"""The reference against the port's plain route (its CPU path) at the small configuration in
float64: a forecast step, the step after it from the fed-back prediction, and the LoRA
fine-tune step's loss, first gradient and update. Only this test imports both."""

from datetime import datetime

import numpy as np
import pytest
import torch

from aurora_tpu_torch.batch import Batch, Metadata
from aurora_tpu_torch.training import adamw, lora_mask, make_train_step

from benchmark import program, run, weights
from benchmark.reference.aurora import Reference, Step, next_step, stats
from benchmark.tests.small import SMALL

SEED = 7
F64 = torch.float64


def port_model(cfg, dtype):
    return program.build(cfg, "cpu", SEED, dtype=dtype)


def inputs(cfg, dtype, seed=0):
    """A host batch of the small grid and the reference's step of its cropped fields."""
    g = cfg["grid"]
    H, W, levels = g["H"], g["W"], tuple(g["levels"])
    rng = np.random.default_rng(seed)

    def field(name, shape, lv=None):
        loc, scale = stats(name, lv)
        z = rng.standard_normal(shape)
        if lv is not None:
            loc, scale = loc[:, None, None], scale[:, None, None]
        return z * scale + loc

    surf = {k: field(k, (1, 2, H, W)) for k in cfg["surf_vars"]}
    static = {k: field(k, (H, W)) for k in cfg["static_vars"]}
    atmos = {k: field(k, (1, 2, len(levels), H, W), levels) for k in cfg["atmos_vars"]}
    lat, lon = np.linspace(90, -90, H), np.linspace(0, 360, W, endpoint=False)
    t = (datetime(2020, 6, 1, 12),)
    batch = Batch(surf_vars=surf, static_vars=static, atmos_vars=atmos,
                  metadata=Metadata(lat=lat, lon=lon, time=t, atmos_levels=levels))

    def crop(a):
        return torch.as_tensor(a[..., :H - H % cfg["patch_size"], :], dtype=dtype)

    st = Step({k: crop(v) for k, v in surf.items()}, {k: crop(v) for k, v in static.items()},
              {k: crop(v) for k, v in atmos.items()}, lat[:H - H % cfg["patch_size"]], lon, t,
              levels, 0)
    return batch, st


def cfg_of(name):
    return dict(run.config(run.spec(), name), **SMALL)


def _assert_close(got_s, got_a, want_s, want_a, tol):
    for got, want in ((got_s, want_s), (got_a, want_a)):
        for k, w in want.items():
            g = torch.as_tensor(np.asarray(got[k]), dtype=w.dtype)
            assert float((g - w).abs().max() / w.abs().max()) < tol, k


@pytest.mark.parametrize("name", ["aurora-0.25-f32", "aurora-0.25-prod"])
def test_a_forecast_step_and_the_next_are_the_port_s(name):
    """In float64; for the production configuration the port's backbone weights rounded to
    bf16 by hand, which the reference does by itself."""
    cfg = cfg_of(name)
    model = port_model(dict(cfg, autocast=False, agg_bf16=False, deagg_bf16=False), F64)
    if cfg["autocast"]:
        with torch.no_grad():
            for p in model.backbone.parameters():
                p.copy_(p.to(torch.bfloat16))
    ref = Reference(cfg, weights.make(program.shapes(model), SEED, "cpu"), dtype=F64)
    batch, st = inputs(cfg, F64)
    with torch.no_grad():
        p1 = model(batch)
        r1 = ref.step(st)
        _assert_close({k: v[:, 0] for k, v in p1.surf_vars.items()},
                      {k: v[:, 0] for k, v in p1.atmos_vars.items()}, *r1, 1e-12)
        fed = Batch(surf_vars={k: np.concatenate([batch.surf_vars[k][:, 1:, :-1], v.numpy()], 1)
                               for k, v in p1.surf_vars.items()},
                    static_vars={k: v[:-1] for k, v in batch.static_vars.items()},
                    atmos_vars={k: np.concatenate([batch.atmos_vars[k][:, 1:, :, :-1],
                                                   v.numpy()], 1)
                                for k, v in p1.atmos_vars.items()},
                    metadata=p1.metadata)
        p2 = model(fed)
        r2 = ref.step(next_step(st, *r1, cfg["timestep_hours"]))
        _assert_close({k: v[:, 0] for k, v in p2.surf_vars.items()},
                      {k: v[:, 0] for k, v in p2.atmos_vars.items()}, *r2, 1e-12)


def test_the_bf16_backbone_is_rounded_by_the_reference_itself():
    cfg = cfg_of("aurora-0.25-prod")
    w = {"backbone.x.weight": torch.tensor([1.0 + 2**-10]), "encoder.y": torch.tensor([1.0 + 2**-10])}
    ref = Reference(cfg, w)
    assert float(ref.w["backbone.x.weight"]) == 1.0
    assert float(ref.w["encoder.y"]) == 1.0 + 2**-10


def test_the_lora_step_is_the_port_s():
    cfg = cfg_of("aurora-0.25-f32")
    model = port_model(cfg, F64)
    shapes = program.shapes(model)
    batch, st = inputs(cfg, F64)
    _, tgt = inputs(cfg, F64, seed=1)
    tgt_s = {k: v[:, -1] for k, v in tgt.surf.items()}
    tgt_a = {k: v[:, -1] for k, v in tgt.atmos.items()}
    opt = adamw(3e-4, trainable=lora_mask)
    step = make_train_step(model, opt, st.levels)
    enc = model.prepare_encodings(batch.crop(cfg["patch_size"]), F64)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    before = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    losses = []
    for i in range(2):
        losses.append(float(step(st.surf, st.static, st.atmos, enc, 0, tgt_s, tgt_a)))
        if i == 0:
            first = {n: opt.opt.state[p]["exp_avg"] / 0.1 for n, p in model.named_parameters()
                     if p.requires_grad}
    params = dict(model.named_parameters())

    ref = Reference(cfg, weights.make(shapes, SEED, "cpu"), dtype=F64)
    assert sorted(ref.adapters()) == sorted(names)
    state = {}
    out = [ref.train_step(st, tgt_s, tgt_a, state, 3e-4) for _ in range(2)]
    for i in range(2):
        assert abs(losses[i] - out[i]["loss"]) < 1e-12 * abs(out[i]["loss"])
    for n in names:
        g = out[0]["grads"][n]
        assert float((first[n] - g).abs().max()) <= 1e-9 * float(g.abs().max()) + 1e-300, n
        want = out[1]["params"][n] - before[n]
        got = params[n].detach() - before[n]
        assert float((got - want).abs().max()) <= 1e-9 * float(want.abs().max()), n
