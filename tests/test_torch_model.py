"""The whole slice of the port against ``aurora_tpu.Aurora`` on the CPU, and the port's rules.

* float64, gates open: one forward step and a 2-step ``rollout`` at mean relative error
  <= 1e-8 per variable. The 73 x 144 grid gives full shifted windows at stage 1, padding
  at stage 2 and shrunk windows at stage 3. The forward also under the backbone's other
  routes (``attention_impl``, ``mlp_impl``): W (pallas_windowed, fused), P (pallas,
  pallas), X (xla, fused) and (xla, xla), each against the one JAX reference, with the
  block-level wrappers each route calls counted.
* The production knobs (bf16 backbone under ``autocast`` with bf16-stored weights, bf16
  values in the level aggregation and de-aggregation) against the JAX package under the
  same knobs. The two round at different points: the JAX CPU route takes its XLA path
  (bf16 logits, the shifted-variance bf16 LayerNorm in every block), the port the kernels'
  order (f32 logits, f32 LayerNorm statistics). Both are then one bf16 rounding chain away
  from the f32 model, so the test holds the port to: mean relative error <= 2e-2 per
  variable against the JAX production output, and an error against the JAX f32 model no
  worse than 1.25x the JAX production path's own (+1e-4).
* Rules: the package and ``chip_smoke.py`` load no JAX module; ``Aurora`` without
  ``device=`` raises when there is no card; the kernel modules import without ``nvcc``
  and ``triton``.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_batch
from tests.test_torch_support import (
    matched_models,
    mean_rel,
    numpy_tree,
    open_gates,
    torch_batch,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(
    embed_dim=64, num_heads=4, encoder_depths=(2, 2, 2), decoder_depths=(2, 2, 2),
    encoder_num_heads=(2, 4, 8), decoder_num_heads=(8, 4, 2), use_lora=True,
)
LEVELS = (100, 250, 500, 850)


def _errors(pred, ref) -> dict:
    out = {f"surf {k}": mean_rel(pred.surf_vars[k], v) for k, v in ref.surf_vars.items()}
    out.update({f"atmos {k}": mean_rel(pred.atmos_vars[k], v) for k, v in ref.atmos_vars.items()})
    return out


@pytest.fixture(scope="module")
def f64_pair():
    jm, params, tm = matched_models(CFG)
    return jm, params, tm, make_batch(H=73, W=144, levels=LEVELS)


def test_forward_matches_f64(f64_pair):
    jm, params, tm, jb = f64_pair
    want = jm.forward(params, jb)
    got = tm(torch_batch(jb))
    errs = _errors(got, want)
    assert max(errs.values()) <= 1e-8, errs
    assert got.metadata.rollout_step == 1
    assert got.metadata.time == want.metadata.time
    assert tuple(got.atmos_vars["z"].shape) == (1, 1, len(LEVELS), 72, 144)


@pytest.fixture(scope="module")
def f64_reference(f64_pair):
    jm, params, _, jb = f64_pair
    return jm.forward(params, jb)


# Calls per forward of the wrappers a Swin block routes to: 12 blocks in CFG.
ROUTE_CALLS = {
    ("pallas_windowed", "fused"): {"window_attention_windowed": 12, "mlp_adaln_residual": 12},
    ("pallas", "pallas"): {"window_attention_tail": 12, "mlp_fused": 12},
    ("xla", "fused"): {"linear_adaln_residual": 12, "mlp_adaln_residual": 12},
    ("xla", "xla"): {},
}


@pytest.mark.parametrize("route", list(ROUTE_CALLS), ids=["-".join(r) for r in ROUTE_CALLS])
def test_routes_forward_match_f64(f64_pair, f64_reference, route, monkeypatch):
    from aurora_tpu_torch.convert import params_from_numpy
    from aurora_tpu_torch.model import swin3d
    from aurora_tpu_torch.model.config import AuroraConfig

    _, params, _, jb = f64_pair
    names = ("window_attention_tail", "window_attention_windowed", "linear_adaln_residual",
             "mlp_adaln_residual", "mlp_fused")
    calls = dict.fromkeys(names, 0)
    for n in names:
        def spy(*a, _n=n, _f=getattr(swin3d, n), **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(swin3d, n, spy)
    cfg = AuroraConfig(**CFG, attention_impl=route[0], mlp_impl=route[1])
    tm = params_from_numpy(numpy_tree(params), cfg, device="cpu", dtype=torch.float64)
    got = tm(torch_batch(jb))
    errs = _errors(got, f64_reference)
    assert max(errs.values()) <= 1e-8, errs
    assert calls == {n: ROUTE_CALLS[route].get(n, 0) for n in names}


def test_rollout_matches_f64(f64_pair):
    from aurora_tpu.rollout import rollout as j_rollout
    from aurora_tpu_torch import rollout as t_rollout

    jm, params, tm, jb = f64_pair
    want = list(j_rollout(jm, params, jb, steps=2))
    got = list(t_rollout(tm, torch_batch(jb), steps=2))
    assert len(got) == 2
    for step, (g, w) in enumerate(zip(got, want)):
        errs = _errors(g, w)
        assert max(errs.values()) <= 1e-8, (step, errs)
        assert g.metadata.rollout_step == step + 1


def test_forward_returns_the_callers_static_vars(f64_pair, f64_reference):
    """The static fields of a prediction are the caller's cropped arrays, as
    ``aurora_tpu/model/aurora.py:556`` returns them, not the model's cast copies: a float32
    model given float64 inputs returns them float64, with the JAX forward's values."""
    from aurora_tpu_torch.convert import params_from_numpy
    from aurora_tpu_torch.model.config import AuroraConfig

    _, params, _, jb = f64_pair
    tm32 = params_from_numpy(numpy_tree(params), AuroraConfig(**CFG), device="cpu")
    assert tm32.encoder.surf_level_encoding.dtype == torch.float32
    got = tm32(torch_batch(jb))
    assert set(got.static_vars) == set(f64_reference.static_vars)
    for k, want in f64_reference.static_vars.items():
        want = np.asarray(want)
        assert want.dtype == np.float64 and got.static_vars[k].dtype == torch.float64, k
        assert np.array_equal(np.asarray(got.static_vars[k]), want), k


def _with_2t_doubled(batch):
    return dataclasses.replace(
        batch, surf_vars={**batch.surf_vars, "2t": 2 * batch.surf_vars["2t"]})


def _hooked_model(params, hook):
    """The port model of ``params`` whose ``batch_transform_hook`` is ``hook``."""
    from aurora_tpu_torch import Aurora
    from aurora_tpu_torch.convert import load_numpy_params
    from aurora_tpu_torch.model.config import AuroraConfig

    class Hooked(Aurora):
        def batch_transform_hook(self, batch):
            return hook(batch)

    model = Hooked(AuroraConfig(**CFG), device="cpu", dtype=torch.float64, seed=None)
    return load_numpy_params(model, numpy_tree(params))


def test_batch_transform_hook_runs_first_in_forward(f64_pair):
    """``forward`` applies the hook before anything else (``aurora_tpu/model/aurora.py:526``):
    a hook that doubles ``2t`` gives the base model's prediction on the doubled batch. The
    port against itself, on the small 17 x 32 batch."""
    _, params, tm, _ = f64_pair
    batch = torch_batch(make_batch(levels=LEVELS))
    got = _hooked_model(params, _with_2t_doubled)(batch)
    want = tm(_with_2t_doubled(batch))
    for k in want.surf_vars:
        assert torch.equal(got.surf_vars[k], want.surf_vars[k]), k
    for k in want.atmos_vars:
        assert torch.equal(got.atmos_vars[k], want.atmos_vars[k]), k
    assert not torch.equal(want.surf_vars["2t"], tm(batch).surf_vars["2t"])


def test_rollout_applies_the_hook_before_its_history(f64_pair):
    """``rollout`` hands the caller's batch, uncropped, to the hook once before the first
    step (``aurora_tpu/rollout.py:26``); ``forward`` applies it again."""
    from aurora_tpu_torch import rollout

    _, params, _, _ = f64_pair
    seen = []
    model = _hooked_model(params, lambda b: seen.append(b.spatial_shape) or b)
    preds = list(rollout(model, torch_batch(make_batch(levels=LEVELS)), steps=1))
    assert len(preds) == 1 and preds[0].metadata.rollout_step == 1
    assert seen == [(17, 32), (16, 32)]


def test_production_knobs_match_jax_production():
    from aurora_tpu.model.aurora import Aurora as JaxAurora
    from aurora_tpu.model.aurora import cast_backbone_params as j_cast
    from aurora_tpu.model.config import AuroraConfig as JaxConfig
    from aurora_tpu_torch import cast_backbone_params as t_cast
    from aurora_tpu_torch.convert import params_from_numpy
    from aurora_tpu_torch.model.config import AuroraConfig

    prod = dict(CFG, autocast=True, agg_bf16=True, deagg_bf16=True)
    jm, jm32 = JaxAurora(JaxConfig(**prod)), JaxAurora(JaxConfig(**CFG))
    p32 = open_gates(jm.init(jax.random.PRNGKey(0), dtype=jnp.float32))
    tm = t_cast(params_from_numpy(numpy_tree(p32), AuroraConfig(**prod), device="cpu"))
    assert tm.backbone.encoder_layers[0].blocks[0].mlp.fc1.weight.dtype == torch.bfloat16
    jb = make_batch(H=73, W=144, levels=LEVELS, dtype=np.float32)

    ref32 = jm32.forward(p32, jb)
    want = jm.forward(j_cast(p32), jb)
    got = tm(torch_batch(jb))
    vs_jax = _errors(got, want)
    assert max(vs_jax.values()) <= 2e-2, vs_jax
    port_err, jax_err = _errors(got, ref32), _errors(want, ref32)
    for k in port_err:
        assert port_err[k] <= 1.25 * jax_err[k] + 1e-4, (k, port_err[k], jax_err[k])


def _run(code: str, env=None) -> str:
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        check=True, timeout=120,
    ).stdout


def test_no_jax_or_jax_package_is_loaded():
    """Importing every module of the port and ``chip_smoke`` loads no ``jax``/``jax.*`` and
    no ``aurora_tpu``/``aurora_tpu.*`` module (``aurora_tpu_torch`` itself shares the
    prefix, so names are matched exactly or by the ``aurora_tpu.`` prefix), and none of
    pandas, xarray, matplotlib and requests, which the card's machine does not have."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import aurora_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(aurora_tpu_torch.__path__, 'aurora_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n in ('jax', 'aurora_tpu')\n"
        "       or n.startswith(('jax.', 'aurora_tpu.', 'jaxlib'))\n"
        "       or n.split('.')[0] in ('pandas', 'xarray', 'matplotlib', 'requests')]\n"
        "new = ['ops.probes', 'tools', 'tools.backbone_ablate', 'tools.gemm_probe',\n"
        "       'tools.smem_probe', 'tools.kernel_ablate', 'checkpoint',\n"
        "       'tools.variant_bench', 'tools.highres_bench', 'rollout', 'tools.bench',\n"
        "       'ops.ad', 'training', 'training.train', 'tools.train_bench',\n"
        "       'tools.rollout_train_bench', 'native', 'metrics', 'tracker', 'foundry',\n"
        "       'foundry.channel', 'cli', '__main__', 'plot', 'utils', 'utils.profiling',\n"
        "       'tools.rollout_bench', 'tools.train_speed_probe', 'foundry.models',\n"
        "       'foundry.server', 'foundry.http_server', 'foundry.client', 'foundry.demo',\n"
        "       'foundry.demo.interactive', 'foundry.demo.hres_t0_data', 'parallel',\n"
        "       'parallel.distributed', 'parallel.mesh', 'parallel.sharding',\n"
        "       'tools.multihost_sim']\n"
        "assert all('aurora_tpu_torch.' + n in sys.modules for n in new), new\n"
        "print(len([n for n in sys.modules if n.startswith('aurora_tpu_torch')]), bad)\n"
    )
    count, bad = _run(code).strip().split(" ", 1)
    assert int(count) >= 25
    assert bad == "[]"


def test_aurora_without_device_raises_when_no_card(monkeypatch):
    from aurora_tpu_torch import SMALL_CONFIG, Aurora

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Aurora(SMALL_CONFIG)
    Aurora(SMALL_CONFIG.replace(encoder_depths=(2, 2, 2), decoder_depths=(2, 2, 2)),
           device="cpu")


def test_kernel_modules_import_without_nvcc_or_triton():
    """With no ``nvcc`` on the PATH and ``triton`` unimportable, every kernel module
    imports and each wrapper runs its plain version on CPU tensors; nothing is built."""
    code = (
        "import sys; sys.modules['triton'] = None\n"
        "import torch\n"
        "from aurora_tpu_torch.ops import _lib, mlp, probes, resampler, roll, window_attention\n"
        "x = torch.randn(1, 2, 6, 12, 8)\n"
        "assert torch.equal(roll.roll3d(x, (1, 2, 3)), torch.roll(x, (1, 2, 3), (1, 2, 3)))\n"
        "assert sum(_lib.LAUNCHES.values()) == 0 and not _lib._libs\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH="/usr/bin:/bin")
    assert _run(code, env=env).strip() == "ok"
