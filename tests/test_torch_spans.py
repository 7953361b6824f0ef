"""The port's spans (``aurora_tpu_torch/utils/profiling.py``), the launch decorator that opens
the kernel spans and counts the launches (``ops/_lib.py::launch``), the gradient spans of
``ops/ad.py``, and the benchmark's readers of the spans (``benchmark/spans.py``,
``benchmark/metrics/``).

The CPU tests use synthetic spans and stores; the test marked ``card`` runs a short traced
step of the small model on the card (``python3 -m pytest --noconftest -m card
tests/test_torch_spans.py``) and skips without one."""

import ast
import pathlib
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import aurora_tpu_torch
from aurora_tpu_torch.ops import _lib, ad
from aurora_tpu_torch.utils import profiling
from aurora_tpu_torch.utils.profiling import recorded, span
from benchmark import run, spans

PORT = pathlib.Path(aurora_tpu_torch.__file__).resolve().parent


def session():
    """A CPU profiler session: ``torch.autograd.profiler.profile``, the session that
    ``torch.profiler.profile`` runs, without the latter's first-use imports of the compiler
    stack, which take seconds."""
    return torch.autograd.profiler.profile()


def parents(rec):
    return [(r.name, None if r.parent is None else rec.records[r.parent].name)
            for r in rec.records]


def test_without_a_session_a_span_opens_no_range_and_records_nothing(monkeypatch):
    with session():
        with span("aurora:first"):
            pass
    before = parents(recorded())

    def refuse(*args, **kwargs):
        raise AssertionError("a record_function was entered without a session")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with span("aurora:a"):
        with span("aurora:b"):
            pass
    assert parents(recorded()) == before == [("aurora:first", None)]


def test_names_nesting_and_parents_under_a_cpu_session():
    with session():
        with span("aurora:a"):
            with span("aurora:k.b"):
                with span("aurora:k.c"):
                    pass
            with span("aurora:k.b"):
                pass
        with span("aurora:d"):
            pass
    rec = recorded()
    assert parents(rec) == [("aurora:a", None), ("aurora:k.b", "aurora:a"),
                            ("aurora:k.c", "aurora:k.b"), ("aurora:k.b", "aurora:a"),
                            ("aurora:d", None)]
    assert set(rec) == {"aurora:a", "aurora:k.b", "aurora:k.c", "aurora:d"}
    assert rec["aurora:k.b"].calls == 2 and rec["aurora:a"].calls == 1
    assert rec["aurora:a"].host_s >= rec["aurora:k.b"].host_s > 0
    assert all(t.device_s is None for t in rec.values())  # no card, no device time
    assert rec.inside("aurora:k.*", "aurora:a") is None


def test_a_span_in_a_custom_backward_is_recorded_and_kernel_grads_are_named():
    class Double(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return 2 * x

        @staticmethod
        def backward(ctx, g):
            with span("aurora:grad.double"):
                return 2 * g

    def stand_in(x, w):  # a kernel's launch function, as ``_lib.launch`` marks one
        return x * w

    stand_in.launch_key = "mlp_fused"

    def grad_fn(x, w, part=None):
        return x * w

    x = torch.ones(3, requires_grad=True)
    w = torch.full((3,), 3.0, requires_grad=True)
    with session():
        with span("aurora:train.backward"):
            y = Double.apply(x) + ad.kernel_with_plain_grad(stand_in, grad_fn)(x, w)
            y.sum().backward()
    assert torch.equal(x.grad, torch.full((3,), 5.0)) and torch.equal(w.grad, x.detach())
    got = parents(recorded())
    assert ("aurora:grad.double", "aurora:train.backward") in got
    assert ("aurora:grad.mlp_fused", "aurora:train.backward") in got


def test_a_second_session_starts_empty():
    with session():
        with span("aurora:one"):
            pass
    with session():
        with span("aurora:two"):
            pass
    assert list(recorded()) == ["aurora:two"]


def _literal(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr) and node.values and isinstance(node.values[0],
                                                                      ast.Constant):
        return node.values[0].value
    return None


def test_every_span_name_in_the_port_is_aurora_and_none_is_bench():
    names = []
    for path in PORT.rglob("*.py"):
        text = path.read_text()
        if "span(" not in text and "bench:" not in text:
            continue
        tree = ast.parse(text)
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert not node.value.startswith("bench:"), path
            if isinstance(node, ast.Call) and node.args and (
                    getattr(node.func, "id", None) == "span"
                    or getattr(node.func, "attr", None) == "span"):
                names.append((path.name, _literal(node.args[0])))
    literal = [n for _, n in names if n is not None]
    assert len(literal) >= 15 and all(n.startswith(profiling.PREFIX) for n in literal), names
    assert profiling.PREFIX == "aurora:"


def test_the_launch_decorator_counts_as_before_and_names_the_span():
    key = "sdpa_windows"
    launches, by = dict(_lib.LAUNCHES), dict(_lib.LAUNCHES_BY)
    try:
        @_lib.launch(key)
        def stand_in(x):
            return x.to(torch.bfloat16)

        assert stand_in.launch_key == key and stand_in.__name__ == "stand_in"
        at = (key, "bfloat16", 24)
        n, m = _lib.LAUNCHES[key], _lib.LAUNCHES_BY.get(at, 0)
        with session():
            out = stand_in(torch.zeros(2, 24))
            stand_in(torch.zeros(5, 24))
        assert out.dtype == torch.bfloat16
        assert _lib.LAUNCHES[key] == n + 2 and _lib.LAUNCHES_BY[at] == m + 2
        assert recorded()[f"aurora:k.{key}"].calls == 2
        _lib.reset_launches()
        assert _lib.LAUNCHES[key] == 0 and _lib.LAUNCHES_BY[at] == m + 2
        with pytest.raises(KeyError, match="no launch counter"):
            _lib.launch("not_a_kernel")
    finally:
        _lib.LAUNCHES.update(launches)
        _lib.LAUNCHES_BY.clear()
        _lib.LAUNCHES_BY.update(by)


def _store(device: bool):
    """Two steps: each a backbone (a K3 launch with a K8 nested inside it, a K2 launch and a
    merge holding a K1 launch) and a backward (the gradients of K3, K2 and K4, and
    autograd's own work between them); device ms as given."""
    records = []

    def add(name, parent, ms):
        records.append(profiling.SpanRecord(name, parent, 1.0, ms * 1e-3 if device else None))
        return len(records) - 1

    for _ in range(2):
        bb = add("aurora:backbone", None, 200.0)
        enc = add("aurora:backbone.enc0", bb, 150.0)
        k3 = add("aurora:k.mlp_adaln_residual", enc, 100.0)
        add("aurora:k.mlp_fused", k3, 30.0)  # nested in a kernel span: not counted again
        add("aurora:k.window_attention", enc, 40.0)
        merge = add("aurora:backbone.merge0", bb, 8.0)
        add("aurora:k.roll3d", merge, 5.0)
        add("aurora:k.mlp_adaln_residual", None, 7.0)  # a decoder's K3, outside the backbone
        back = add("aurora:train.backward", None, 1000.0)
        add("aurora:grad.mlp_adaln_residual", back, 300.0)
        add("aurora:grad.window_attention", back, 400.0)
        add("aurora:grad.perceiver_core", back, 100.0)
        add("aurora:grad.window_attention", None, 50.0)  # outside the backward
    return profiling.Recorded(records)


READERS = {  # per step, from the store of :func:`_store` over 2 steps
    "k3_ms.forecast": 100.0, "k2_ms.forecast": 40.0,
    "backbone_glue_ms.forecast": 200.0 - 100.0 - 40.0 - 5.0,
    "grad_k3_ms.train": 300.0, "grad_k2_ms.train": 450.0, "grad_k4_ms.train": 100.0,
    "grad_autograd_ms.train": 1000.0 - 300.0 - 400.0 - 100.0,
}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_each_reader_reads_its_ms_per_step_from_a_store(metric, monkeypatch):
    r = types.SimpleNamespace(steps=2)
    monkeypatch.setattr(spans, "recorded", lambda: _store(True))
    assert run.reader(metric)(r) == pytest.approx(READERS[metric])
    monkeypatch.setattr(spans, "recorded", lambda: _store(False))
    assert run.reader(metric)(r) is None
    monkeypatch.setattr(spans, "recorded", lambda: None)  # a program without the spans
    assert run.reader(metric)(r) is None
    monkeypatch.setattr(spans, "recorded", lambda: profiling.Recorded([]))
    assert run.reader(metric)(r) is None


@pytest.mark.card
def test_a_traced_step_on_the_card_gives_device_seconds():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: a card test")
    import dataclasses
    from datetime import datetime

    import numpy as np

    from aurora_tpu_torch.batch import Batch, Metadata
    from aurora_tpu_torch.model.aurora import AuroraSmallPretrained

    cfg = dataclasses.replace(AuroraSmallPretrained.default_config(),
                              encoder_depths=(2, 2, 2), decoder_depths=(2, 2, 2))
    model = AuroraSmallPretrained(cfg, device="cuda")
    H, W = 121, 240
    rng = np.random.default_rng(0)

    def field(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    levels = (50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000)  # K4's 13
    batch = Batch(surf_vars={k: field(1, 2, H, W) for k in cfg.surf_vars},
                  static_vars={k: field(H, W) for k in cfg.static_vars},
                  atmos_vars={k: field(1, 2, len(levels), H, W) for k in cfg.atmos_vars},
                  metadata=Metadata(lat=np.linspace(90, -90, H), lon=np.linspace(0, 360, W,
                                                                               endpoint=False),
                                    time=(datetime(2020, 6, 1, 12),),
                                    atmos_levels=levels))
    model(batch)  # builds the kernels and warms the shapes
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        model(batch)
    rec = recorded()
    assert rec["aurora:backbone"].device_s > 0
    assert rec["aurora:k.mlp_adaln_residual"].device_s > 0
    inside = rec.inside("aurora:k.*", "aurora:backbone")
    assert 0 < inside < rec["aurora:backbone"].device_s
