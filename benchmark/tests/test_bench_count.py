"""``benchmark/count`` against ``torch.utils.flop_counter.FlopCounterMode`` over the
reference at the small configuration: the forward's products and the LoRA step's backward,
both to the operation."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import run, weights
from benchmark.count import aurora as count
from benchmark.reference.aurora import Reference
from benchmark.tests.small import SMALL
from benchmark.tests.test_bench_reference import inputs, port_model


@pytest.fixture(scope="module")
def setup():
    cfg = dict(run.config(run.spec(), "aurora-0.25-prod"), **SMALL)
    model = port_model(cfg, torch.float32)
    from benchmark import program

    ref = Reference(cfg, weights.make(program.shapes(model), 7, "cpu"))
    _, st = inputs(cfg, torch.float32)
    return cfg, ref, st


def test_the_forward_count_is_the_reference_s(setup):
    cfg, ref, st = setup
    fc = FlopCounterMode(display=False)
    with fc, torch.no_grad():
        ref.step(st)
    H, W = next(iter(st.surf.values())).shape[-2:]
    parts = count.forward(cfg, H, W, len(st.levels))
    assert fc.get_total_flops() == sum(parts.values())


def test_the_backward_count_is_what_the_adapters_gradients_need(setup):
    cfg, ref, st = setup
    names = ref.adapters()
    for n in names:
        ref.w[n] = ref.w[n].detach().requires_grad_(True)
    surf, atmos = ref.step(st)
    loss = torch.stack([v.abs().mean() for v in [*surf.values(), *atmos.values()]]).mean()
    fc = FlopCounterMode(display=False)
    with fc:
        torch.autograd.grad(loss, [ref.w[n] for n in names])
    H, W = next(iter(st.surf.values())).shape[-2:]
    assert fc.get_total_flops() == count.train_backward(cfg, H, W, len(st.levels))


def test_the_backbone_bytes_count_its_weights_once():
    cfg = dict(run.config(run.spec(), "aurora-0.25-prod"), **SMALL)
    model = port_model(cfg, torch.float32)
    n = sum(p.numel() for p in model.backbone.parameters())
    assert count.backbone_params(cfg) == n
