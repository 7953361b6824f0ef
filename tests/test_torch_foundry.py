"""The port's serving stack (``aurora_tpu_torch.foundry``) against the JAX package's on the CPU.

* ``ServedModel.run`` of the port and of the JAX package on the same float64 weights and batch:
  mean relative error <= 1e-8 per variable, step by step.
* The port's ``submit`` through its ``InferenceServer`` and a ``LocalFileChannel`` returns
  ``run``'s bits with ``rollout_step`` 1..N; over real HTTP (``serve`` with the port's urllib
  ``FoundryClient``) too, with 401 on a bad token, a task that raises surfacing as
  ``SubmissionError`` with its status, an unknown model raising ``KeyError`` and a channel
  read timing out.
* Wire parity: the JAX package's ``FoundryClient`` + ``submit`` (``requests``) against the
  port's endpoint returns the port's predictions.
* ``ServedModel._load_params`` from a reference ``.ckpt`` and from a ``save_params`` file: a bf16
  backbone and an f32 encoder under ``autocast``.
* The registry's entry builds its facade's default config, as the JAX registry does: from one
  reference-format ``.ckpt`` the port's served predictions hold the JAX registry's within
  float32 rounding (float32 all through on both sides).
* The registry's names, the blob channel's URLs and SAS check, ``channel_from_spec`` and
  ``field_data_url`` as the JAX package's.

The model: a tiny matched pair (widths of 64, one block a stage) from
``tests/test_torch_support.py::seeded_matched_models``, served on ``device="cpu"``.
"""

import dataclasses
import urllib.error

import numpy as np
import pytest
import torch

import aurora_tpu.foundry.models as j_models
import aurora_tpu_torch.foundry.models as t_models
from aurora_tpu.foundry import client as j_client
from aurora_tpu.foundry import channel as j_channel
from aurora_tpu.foundry.models import ServedModel as JServedModel
from aurora_tpu_torch.checkpoint import save_params
from aurora_tpu_torch.foundry import (
    BlobStorageChannel,
    InferenceServer,
    LocalFileChannel,
    SubmissionError,
    submit,
)
from aurora_tpu_torch.foundry.channel import channel_from_spec
from aurora_tpu_torch.foundry.client import FoundryClient
from aurora_tpu_torch.foundry.http_server import serve
from aurora_tpu_torch.foundry.models import ServedModel
from aurora_tpu_torch.model.aurora import Aurora
from aurora_tpu_torch.model.config import AuroraConfig
from tests.conftest import make_batch
from tests.test_torch_support import (
    batch_errors,
    reference_state_dict,
    seeded_matched_models,
    torch_batch,
)

TINY = dict(embed_dim=64, num_heads=4, encoder_depths=(1, 1), encoder_num_heads=(2, 4),
            decoder_depths=(1, 1), decoder_num_heads=(4, 2), window_size=(2, 4, 4),
            latent_levels=2, use_lora=False)
NAME = "tiny-test-model"
STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, the caller's count restored after (the suite runs six workers
    at once; see ``tests/test_torch_training.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """The JAX model, its float64 parameters and the port model holding them."""
    return seeded_matched_models(TINY)


@pytest.fixture(scope="module")
def batch():
    """The JAX package's float64 batch (16 x 32, two levels)."""
    return make_batch(H=16, W=32, levels=(500.0, 850.0))


@pytest.fixture
def registered(pair):
    """The tiny pair in both registries under one name (the JAX ``submit`` checks the name
    against the JAX registry); the served models share the already built weights."""
    jmodel, params, tmodel = pair

    class TinyJax(JServedModel):
        name, model_cls = NAME, None

        def __init__(self):
            self.model, self.params = jmodel, params

    class TinyPort(ServedModel):
        name, model_cls = NAME, None

        def __init__(self, device=None):
            assert torch.device(device) == tmodel.device
            self.model = tmodel

    j_models.models[NAME], t_models.models[NAME] = TinyJax, TinyPort
    yield TinyJax, TinyPort
    del j_models.models[NAME], t_models.models[NAME]


@pytest.fixture(scope="module")
def port_preds(pair, batch):
    """The port's ``ServedModel.run`` predictions (host arrays)."""
    return list(ServedModel.run(_holder(pair[2]), torch_batch(batch), STEPS))


def _holder(model):
    served = ServedModel.__new__(ServedModel)
    served.model = model
    return served


class _DirectClient:
    """Drives the port's ``InferenceServer`` in process instead of over HTTP."""

    def __init__(self, server):
        self.server = server

    def submit_task(self, data):
        return self.server.handle({"type": "submission", "msg": data})

    def get_progress(self, task_id):
        return self.server.handle({"type": "task_info", "msg": {"task_id": task_id}})


def _same_bits(got: list, want: list) -> None:
    assert len(got) == len(want) == STEPS
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.metadata.rollout_step == w.metadata.rollout_step == i + 1
        assert tuple(g.metadata.time) == tuple(w.metadata.time)
        for group in ("surf_vars", "atmos_vars", "static_vars"):
            gv, wv = getattr(g, group), getattr(w, group)
            assert list(gv) == list(wv)
            for k in wv:
                a, b = np.asarray(gv[k]), np.asarray(wv[k])
                assert a.dtype == b.dtype and np.array_equal(a, b), (i, group, k)


def test_served_run_matches_jax(pair, batch, port_preds):
    jmodel, params, _ = pair
    jax_served = JServedModel.__new__(JServedModel)
    jax_served.model, jax_served.params = jmodel, params
    want = list(jax_served.run(batch, STEPS))
    assert len(port_preds) == len(want) == STEPS
    for got, ref in zip(port_preds, want):
        assert got.metadata.rollout_step == ref.metadata.rollout_step
        assert all(isinstance(v, np.ndarray) and v.dtype == np.float64
                   for v in {**got.surf_vars, **got.atmos_vars}.values())
        errs = batch_errors(got, ref)
        assert max(errs.values()) <= 1e-8, errs


def test_submit_in_process_returns_run_bits(registered, batch, port_preds, tmp_path):
    server = InferenceServer(device="cpu")
    try:
        got = list(submit(torch_batch(batch), NAME, STEPS, LocalFileChannel(tmp_path / "comm"),
                          _DirectClient(server)))
        (task,) = server.tasks.values()
    finally:
        server.shutdown()
    _same_bits(got, port_preds)
    assert task.task_info.status == "Successfully completed"
    assert task.task_info.progress_percentage == 100
    assert len(task.timings["steps"]) == STEPS and task.timings["load_s"] >= 0


def test_submit_over_http(registered, batch, port_preds, tmp_path):
    with serve(token="secret", device="cpu") as handle:
        client = FoundryClient(endpoint=handle.url, token="secret")
        got = list(submit(torch_batch(batch), NAME, STEPS, LocalFileChannel(tmp_path / "comm"),
                          client))
        with pytest.raises(urllib.error.HTTPError) as e:
            FoundryClient(endpoint=handle.url, token="wrong").submit_task({})
        assert e.value.code == 401
        # A malformed request is a 500 with the error's message.
        with pytest.raises(urllib.error.HTTPError) as e:
            client._req({"type": "nonsense", "msg": {}})
        assert e.value.code == 500
    _same_bits(got, port_preds)


def test_task_failure_surfaces_over_http(registered, batch, tmp_path, monkeypatch):
    def boom(self, batch, num_steps):
        raise RuntimeError("synthetic rollout failure")

    monkeypatch.setattr(registered[1], "run", boom)
    with serve(token="secret", device="cpu") as handle:
        client = FoundryClient(endpoint=handle.url, token="secret")
        with pytest.raises(SubmissionError, match="Exception: synthetic rollout failure"):
            list(submit(torch_batch(batch), NAME, STEPS, LocalFileChannel(tmp_path / "comm"),
                        client))


def test_unknown_model_and_channel_timeout(tmp_path):
    server = InferenceServer(device="cpu")
    try:
        with pytest.raises(KeyError):
            list(submit(torch_batch(make_batch()), "not-a-model", 1,
                        LocalFileChannel(tmp_path / "comm"), _DirectClient(server)))
    finally:
        server.shutdown()
    with pytest.raises(TimeoutError):
        LocalFileChannel(tmp_path / "comm").read("no-such-task", "input.nc.ack", timeout=0.5)


def test_jax_client_against_the_port_endpoint(registered, batch, port_preds, tmp_path):
    """The JAX package's client and ``submit`` (``requests``, its own channel and netCDF
    reader) against the port's endpoint: the port's predictions come back."""
    with serve(token="secret", device="cpu") as handle:
        client = j_client.FoundryClient(endpoint=handle.url, token="secret")
        got = list(j_client.submit(batch, NAME, STEPS, j_channel.LocalFileChannel(tmp_path / "c"),
                                   client))
    _same_bits([torch_batch(g).to_numpy() for g in got], port_preds)


def test_server_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="No CUDA device"):
        InferenceServer()
    with pytest.raises(RuntimeError, match="No CUDA device"):
        serve()
    with pytest.raises(RuntimeError, match="No CUDA device"):
        t_models.models["aurora-0.25-small-pretrained"]()
    InferenceServer(device="cpu").shutdown()


AUTOCAST = dict(TINY, autocast=True, agg_bf16=True, deagg_bf16=True)


@pytest.mark.parametrize("kind", ["ckpt", "save_params"])
def test_load_params_casts_the_backbone_under_autocast(pair, kind, tmp_path):
    """A reference ``.ckpt`` (converted) or a ``save_params`` file: the served model holds its
    weights, the backbone stored in bf16 and the encoder in f32 (the JAX package's serving
    layout)."""
    want = Aurora(AuroraConfig(**AUTOCAST), device="cpu", seed=3)
    if kind == "ckpt":
        path = tmp_path / "tiny.ckpt"
        # The JAX tree of the pair, rounded to f32, in the reference's checkpoint format.
        sd = reference_state_dict(pair[1])
        torch.save({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}, path)
        want = _rounded(pair[2])
    else:
        path = tmp_path / "tiny.pt"
        save_params(want, path)

    class Served(ServedModel):
        name, model_cls = "tiny-autocast", None

        def __init__(self, device=None):
            self.model = Aurora(AuroraConfig(**AUTOCAST), device=device, seed=None)
            self._load_params()

    t_models.ARTIFACTS["tiny-autocast"] = str(path)
    try:
        served = Served(device="cpu")
    finally:
        del t_models.ARTIFACTS["tiny-autocast"]
    got = served.model.state_dict()
    assert next(served.model.backbone.parameters()).dtype == torch.bfloat16
    assert next(served.model.encoder.parameters()).dtype == torch.float32
    for k, v in want.state_dict().items():
        expect = v.to(got[k].dtype)
        assert torch.equal(got[k], expect), k
    pred = next(served.run(torch_batch(make_batch(H=16, W=32, levels=(500.0, 850.0),
                                                  dtype=np.float32)), 1))
    assert all(np.isfinite(v).all() for v in pred.surf_vars.values())


def test_registry_serves_the_default_config_as_jax(pair, tmp_path, monkeypatch):
    """``aurora-0.25-small-pretrained`` in both registries, its facade's default config cut to
    the test's tiny widths, one reference-format ``.ckpt`` (float32) as its artifact: the
    port's model is float32 all through (no ``autocast``, no bf16 values or weights) and its
    ``STEPS`` predictions hold the JAX registry's within float32 rounding (mean relative error
    <= 1e-5 per variable; a bf16 value or product anywhere gives 1e-3 and more)."""
    from aurora_tpu.model import aurora as j_aurora
    from aurora_tpu.model.config import AuroraConfig as JaxConfig
    from aurora_tpu_torch.model import aurora as t_aurora

    name = "aurora-0.25-small-pretrained"
    monkeypatch.setattr(j_aurora.AuroraSmallPretrained, "default_config",
                        classmethod(lambda cls: JaxConfig(**TINY)))
    monkeypatch.setattr(t_aurora.AuroraSmallPretrained, "default_config",
                        classmethod(lambda cls: AuroraConfig(**TINY)))
    path = tmp_path / "small.ckpt"
    torch.save({k: torch.from_numpy(np.asarray(v, np.float32))
                for k, v in reference_state_dict(pair[1]).items()}, path)
    monkeypatch.setitem(t_models.ARTIFACTS, name, str(path))
    monkeypatch.setitem(j_models.ARTIFACTS, name, str(path))
    served = t_models.models[name](device="cpu")
    cfg = served.model.cfg
    assert not (cfg.autocast or cfg.agg_bf16 or cfg.deagg_bf16)
    assert {p.dtype for p in served.model.parameters()} == {torch.float32}
    batch = make_batch(H=16, W=32, levels=(500.0, 850.0), dtype=np.float32)
    got = list(served.run(torch_batch(batch), STEPS))
    want = list(j_models.models[name]().run(batch, STEPS))
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        assert g.metadata.rollout_step == w.metadata.rollout_step
        assert all(v.dtype == np.float32 for v in {**g.surf_vars, **g.atmos_vars}.values())
        errs = batch_errors(g, w)
        assert max(errs.values()) <= 1e-5, errs


def _rounded(model64):
    """``model64``'s weights rounded to f32 in a model of the autocast config."""
    out = Aurora(AuroraConfig(**AUTOCAST), device="cpu", seed=None)
    out.load_state_dict({k: v.float() for k, v in model64.state_dict().items()})
    return out


def test_registry_and_channels_match_jax():
    assert list(t_models.models) == list(j_models.models)
    for name, cls in t_models.models.items():
        assert cls.name == name and cls.model_cls.__name__ == j_models.models[name].model_cls.__name__
    url = "https://acct.blob.core.windows.net/container/folder/?sv=2024&sig=abc"
    ours, theirs = BlobStorageChannel(url), j_channel.BlobStorageChannel(url)
    for name in ("task/input.nc", "/task/prediction-000.nc.finished"):
        assert ours._blob_url(name) == theirs._blob_url(name)
    assert ours.to_spec() == theirs.to_spec() == url
    with pytest.raises(ValueError, match="SAS token"):
        BlobStorageChannel("https://acct.blob.core.windows.net/container/folder")
    for spec in (url, "file:///tmp/comm-folder"):
        a, b = channel_from_spec(spec), j_channel.channel_from_spec(spec)
        assert type(a).__name__ == type(b).__name__ and a.to_spec() == b.to_spec()


def test_field_data_url_is_the_jax_packages():
    pytest.importorskip("matplotlib")
    from aurora_tpu.foundry.demo.interactive import field_data_url as j_url
    from aurora_tpu_torch.foundry.demo.interactive import field_data_url

    H, W = 18, 36
    lon = np.linspace(0, 360, W, endpoint=False)
    field = np.random.default_rng(0).standard_normal((H, W))
    got = field_data_url(field, lon, "viridis", -2, 2, dpi=50)
    assert got.startswith("data:image/png;base64,") and got == j_url(field, lon, "viridis",
                                                                      -2, 2, dpi=50)


def test_a_float32_prediction_keeps_its_bits_over_the_channel(tmp_path):
    """A float32 host batch sent over the channel comes back float32, the same bits, with its
    metadata."""
    pred = torch_batch(make_batch(dtype=np.float32)).to_numpy()
    pred = pred.replace(metadata=dataclasses.replace(pred.metadata, rollout_step=3))
    ch = LocalFileChannel(tmp_path / "comm")
    ch.send(pred, "t", "prediction-000.nc")
    back = ch.receive("t", "prediction-000.nc", timeout=1)
    assert back.metadata.rollout_step == 3 and back.metadata.time == pred.metadata.time
    for group in ("surf_vars", "atmos_vars", "static_vars"):
        for k, v in getattr(pred, group).items():
            a = np.asarray(getattr(back, group)[k])
            assert a.dtype == v.dtype == np.float32 and np.array_equal(a, v), (group, k)


def test_library_builds_are_serialised_across_threads(monkeypatch):
    """A served task's first kernel launch comes from the server's worker thread, while
    others may launch too: ``_lib.build`` runs one build at a time, and the native library's
    first use builds it once, whichever threads arrive together (builds replaced by fakes)."""
    import sys
    import threading
    import time
    from concurrent.futures import ThreadPoolExecutor

    from aurora_tpu_torch import native
    from aurora_tpu_torch.ops import _lib

    active, most, built = [0], [0], []

    def fake_kernel_build(force):
        active[0] += 1
        most[0] = max(most[0], active[0])
        time.sleep(0.005)
        active[0] -= 1
        return 0.0

    def fake_native_build():
        time.sleep(0.005)
        built.append(1)
        return object()

    monkeypatch.setattr(_lib, "_build", fake_kernel_build)
    monkeypatch.setattr(native, "_build", fake_native_build)
    monkeypatch.setattr(native, "_LIB", [])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=_lib.build) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        with ThreadPoolExecutor(16) as pool:
            seen = list(pool.map(lambda _: native.available(), range(32), timeout=10))
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert most[0] == 1 and built == [1] and all(seen)
