"""Float32 training (the default config's train steps) on the CPU against
``aurora_tpu.training``'s float32 steps.

* ``make_train_step`` (LoRA only) and ``make_rollout_train_step`` (K = 2, ``lora_mode="all"``)
  at the small config's widths, two blocks a stage (the second shifted), LoRA banks per
  roll-out step, gates open, a 17 x 32 grid, one float32 tree from a numpy seed in both
  packages: the loss within LOSS_TOL relative; each LoRA leaf's gradient within GRAD_TOL
  (mean relative error); the adapters after ``adamw(1e-3)`` within UPDATE_TOL (mean relative
  error of the update ``after - before`` against the JAX package's update, which is AdamW of
  the JAX gradient). The JAX step's gradients are its optimiser state after the step, for an
  optimiser that keeps them (``_Keep``); AdamW is applied to them apart.
* ``tools.train_bench`` / ``tools.rollout_train_bench --default-config``: the float32 default
  config (no ``autocast``, float32 aggregation values, nothing cast to bf16), and the launches
  of a step that ``expected_launches`` derives equal the kernel wrappers' calls, each on
  float32 tokens, as ``tests/test_torch_training.py`` holds them for the production knobs.
"""

import collections
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aurora_tpu.model.aurora import Aurora as JaxAurora
from aurora_tpu.model.config import AuroraConfig as JaxConfig
from aurora_tpu.training.train import adamw as j_adamw
from aurora_tpu.training.train import lora_mask as j_lora_mask
from aurora_tpu.training.train import make_rollout_train_step as j_make_rollout_train_step
from aurora_tpu.training.train import make_train_step as j_make_train_step
from aurora_tpu_torch.convert import load_numpy_params
from aurora_tpu_torch.model import aurora as port_aurora
from aurora_tpu_torch.model import perceiver, swin3d
from aurora_tpu_torch.model.config import AuroraConfig
from aurora_tpu_torch.tools import rollout_train_bench, train_bench
from aurora_tpu_torch.tools.multihost_sim import RecordingAdamW
from aurora_tpu_torch.tools.perf_breakdown import config_form
from aurora_tpu_torch.training import lora_mask, make_rollout_train_step, make_train_step
from tests.conftest import make_batch
from tests.test_torch_grad import targets
from tests.test_torch_support import _seeded_tree, mean_rel, torch_batch, tree_name


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


F32 = torch.float32
CFG = dict(embed_dim=256, num_heads=8, encoder_depths=(2, 2, 2), decoder_depths=(2, 2, 2),
           encoder_num_heads=(4, 8, 16), decoder_num_heads=(16, 8, 4), use_lora=True,
           lora_mode="all", lora_steps=3)
LR = 1e-3
LOSS_TOL = 1e-5  # relative
# Mean relative error of each LoRA leaf's gradient and of its AdamW update: two float32
# programs that sum in their own orders. AdamW's first update is about lr * sign(gradient),
# so an element whose gradient is rounding noise may move the other way; the mean error of
# the update holds such elements, the gradient's does not.
GRAD_TOL = 1e-5
UPDATE_TOL = 5e-4


def _flat(tree) -> dict:
    return {tree_name(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


class _Keep:
    """An optax transformation that leaves the parameters and keeps the gradient as its
    state: the JAX step's gradients, exactly."""

    @staticmethod
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    @staticmethod
    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads


@pytest.fixture(scope="module")
def pair():
    jm = JaxAurora(JaxConfig(**CFG))
    tm = port_aurora.Aurora(AuroraConfig(**CFG), device="cpu", dtype=F32, seed=None)
    params, _ = _seeded_tree(jm, tm, 0, jnp.float32)
    jb = make_batch(H=17, W=32, dtype=np.float32).crop(jm.cfg.patch_size)
    levels = tuple(float(x) for x in jb.metadata.atmos_levels)
    ts, ta = ({k: v.astype(np.float32) for k, v in d.items()} for d in targets(jm.cfg, T=2))
    return dict(jm=jm, params=params, batch=jb, levels=levels, targets=(ts, ta))


def _port(pair):
    tm = port_aurora.Aurora(AuroraConfig(**CFG), device="cpu", dtype=F32, seed=None)
    return load_numpy_params(tm, jax.tree_util.tree_map(np.asarray, pair["params"]))


def _jax_adamw(params, grads):
    """The JAX package's LoRA AdamW applied once to ``grads``: the updated tree."""
    tx = j_adamw(LR, trainable=j_lora_mask)
    updates, _ = jax.jit(tx.update)(grads, tx.init(params), params)
    return optax.apply_updates(params, updates)


def _check(pair, jloss, jgrads, loss, model, opt):
    before = _flat(pair["params"])
    after = _flat(_jax_adamw(pair["params"], jgrads))
    jg = _flat(jgrads)
    names = {p: n for n, p in model.named_parameters()}
    got = {names[p]: g for p, g in opt.grads.items()}
    assert sorted(got) == sorted(n for n, m in lora_mask(model).items() if m)
    assert abs(loss - jloss) <= LOSS_TOL * abs(jloss), (loss, jloss)
    moved = dict(model.named_parameters())
    for n, g in got.items():
        assert np.abs(jg[n]).max() > 0, n
        assert mean_rel(g, jg[n]) <= GRAD_TOL, (n, mean_rel(g, jg[n]))
        step = moved[n].detach().double().numpy() - before[n]
        assert mean_rel(step, after[n] - before[n]) <= UPDATE_TOL, n
    return got


def test_f32_lora_train_step_matches_jax(pair):
    jm, params, levels, jb = pair["jm"], pair["params"], pair["levels"], pair["batch"]
    as_j = lambda d: {k: jnp.asarray(np.asarray(v)) for k, v in d.items()}  # noqa: E731
    ts, ta = ({k: v[:, 0] for k, v in d.items()} for d in pair["targets"])
    enc = jm.prepare_encodings(jb, dtype=jnp.float32)
    step = j_make_train_step(jm.cfg, _Keep, levels, trainable=j_lora_mask)
    copy = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), params)  # donated
    _, jgrads, jloss = step(copy, _Keep.init(copy), as_j(jb.surf_vars), as_j(jb.static_vars),
                            as_j(jb.atmos_vars), enc, jnp.asarray(0, jnp.int32), as_j(ts),
                            as_j(ta))

    model = _port(pair)
    opt = RecordingAdamW(LR, 0.0, 1, lora_mask)
    pstep = make_train_step(model, opt, levels)
    tb = torch_batch(jb)
    tenc = model.prepare_encodings(tb, F32)
    loss = pstep(tb.surf_vars, tb.static_vars, tb.atmos_vars, tenc, 0,
                 {k: torch.from_numpy(v) for k, v in ts.items()},
                 {k: torch.from_numpy(v) for k, v in ta.items()})
    assert loss.dtype == F32 and all(p.dtype == F32 for p in model.parameters())
    _check(pair, float(jloss), jgrads, loss.item(), model, opt)


def test_f32_rollout_train_step_matches_jax(pair):
    """K = 2: each roll-out step trains its own bank."""
    K = 2
    jm, params, levels, jb = pair["jm"], pair["params"], pair["levels"], pair["batch"]
    as_j = lambda d: {k: jnp.asarray(np.asarray(v)) for k, v in d.items()}  # noqa: E731
    ts, ta = ({k: np.moveaxis(v, 1, 0) for k, v in d.items()} for d in pair["targets"])
    enc = jm.prepare_encodings(jb, dtype=jnp.float32)
    abs_t = jnp.stack([jm.prepare_encodings(dataclasses.replace(jb, metadata=dataclasses.replace(
        jb.metadata, time=tuple(t + i * jm.cfg.timestep for t in jb.metadata.time))),
        dtype=jnp.float32).absolute_time for i in range(K)])
    step = j_make_rollout_train_step(jm.cfg, _Keep, levels, K, trainable=j_lora_mask)
    copy = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), params)
    _, jgrads, jloss = step(copy, _Keep.init(copy), as_j(jb.surf_vars), as_j(jb.static_vars),
                            as_j(jb.atmos_vars), enc, abs_t, jnp.asarray(0, jnp.int32),
                            as_j(ts), as_j(ta))

    model = _port(pair)
    opt = RecordingAdamW(LR, 0.0, 1, lora_mask)
    pstep = make_rollout_train_step(model, opt, levels, K)
    tb = torch_batch(jb)
    tenc = model.prepare_encodings(tb, F32)
    abs_p = torch.stack([model.step_encodings(
        [t + i * model.cfg.timestep for t in tb.metadata.time], F32)[0] for i in range(K)])
    loss = pstep(tb.surf_vars, tb.static_vars, tb.atmos_vars, tenc, abs_p, 0,
                 {k: torch.from_numpy(v) for k, v in ts.items()},
                 {k: torch.from_numpy(v) for k, v in ta.items()})
    got = _check(pair, float(jloss), jgrads, loss.item(), model, opt)
    for n, g in got.items():
        assert g[:K].abs().amax(dim=tuple(range(1, g.dim()))).min() > 0, n
        assert not g[K:].any(), n


# ------------------------------------------------------------------------------ the tools

TINY = AuroraConfig(embed_dim=64, num_heads=4, encoder_depths=(2, 4, 2), decoder_depths=(2, 4, 2),
                    encoder_num_heads=(2, 4, 8), decoder_num_heads=(8, 4, 2), use_lora=True)
_KEYS = {"roll3d": "roll3d", "window_attention_tail": "window_attention",
         "mlp_adaln_residual": "mlp_adaln_residual", "perceiver_core": "perceiver_core"}


def test_default_config_is_float32_all_through():
    cfg = train_bench.train_config(default=True)
    assert config_form(cfg) == "default" and cfg.use_lora and cfg.remat
    assert not (cfg.autocast or cfg.agg_bf16 or cfg.deagg_bf16)
    assert config_form(train_bench.train_config()) == "production"
    model = train_bench.build(train_bench.train_config(TINY, default=True), "cpu", "lora")
    assert {p.dtype for p in model.parameters()} == {F32}


@pytest.mark.parametrize("K,mode,scope", [(0, "lora", "full"), (0, "lora", "blocks"),
                                          (0, "full", "full"), (2, "lora", "full")])
def test_f32_expected_launches_are_the_wrappers_calls(K, mode, scope, monkeypatch):
    """The tools with ``--default-config`` on the CPU (depths of 2 and 4 a stage): the
    forward calls of each kernel wrapper in a timed update (a warm-up and one timed update,
    counted together and halved) equal ``expected_launches`` but ``roll3d_bwd``, and every
    call takes float32 tokens, so no backward launches K3's hand-written input gradient."""
    counts, dtypes = collections.Counter(), set()
    for module, name in [(swin3d, "roll3d"), (swin3d, "window_attention_tail"),
                         (swin3d, "mlp_adaln_residual"), (perceiver, "perceiver_core"),
                         (perceiver, "mlp_adaln_residual")]:
        def counted(x, *a, _f=getattr(module, name), _k=_KEYS[name], **kw):
            counts[_k] += 1
            dtypes.add(x.dtype)
            return _f(x, *a, **kw)

        monkeypatch.setattr(module, name, counted)
    knobs = {"lora_mode": "all", "lora_steps": 4} if K else {}
    cfg = train_bench.train_config(TINY, remat_scope=scope, default=True, **knobs)
    model = train_bench.build(cfg, torch.device("cpu"), mode)
    argv = ["--device", "cpu", "--H", "17", "--W", "32", "--steps", "1"]
    with contextlib.redirect_stdout(io.StringIO()):
        if K:
            out = rollout_train_bench.main(argv + ["--K", str(K), "--remat-scope", scope],
                                           model=model)
        else:
            out = train_bench.main(argv + ["--mode", mode], model=model)
    want = dict(out["expected_launches"])
    depths = TINY.encoder_depths + TINY.decoder_depths
    assert want.pop("roll3d_bwd") == 2 * sum(d // 2 for d in depths) * max(K, 1)
    assert want.pop("mlp_adaln_residual_grad") == 0
    assert {k: v // 2 for k, v in counts.items()} == want
    assert dtypes == {F32} and out["config"] == "default"
    assert all(np.isfinite(out["losses"]))
