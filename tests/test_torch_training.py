"""The port's training path (``aurora_tpu_torch/training``, train-state checkpoints, the
training tools) on the CPU in float64 against ``aurora_tpu.training``.

* ``adamw`` is optax's ``adamw`` (and, with ``accum_steps``, ``optax.MultiSteps``) on the
  same parameters and gradients;
* ``make_train_step`` against the JAX step's arithmetic: ``tests/test_torch_grad.py`` (it
  shares that file's compiled JAX gradient);
* ``make_rollout_train_step`` with K = 2 and ``lora_mode="all"``: the loss and each roll-out
  step's LoRA bank gradient against the JAX package's ``make_rollout_train_step``;
* the three ``remat_scope`` values give ``remat=False``'s gradients (<= 1e-12);
* ``save_train_state`` / ``restore_train_state`` resume bit for bit, in the middle of an
  accumulation cycle;
* the launches a train step makes on the card, as
  :func:`tools.train_bench.expected_launches` derives them for its check there (a
  rematerialised region replays its forward inside each replay around it, up to the last
  tensor it saves): the tools' CPU runs call each kernel wrapper as often, for every
  ``remat_scope``, both modes and a K = 2 roll-out;
* building a model leaves the caller's TF32 switches alone; the model's own calls switch
  TF32 off and restore the caller's setting.

The model is the small config's widths at two blocks a stage (the second shifted), LoRA
banks per roll-out step, a 17 x 32 grid, gates open, inputs from numpy seeds.
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

from aurora_tpu.training.train import adamw as j_adamw
from aurora_tpu.training.train import lora_mask as j_lora_mask
from aurora_tpu.training.train import make_rollout_train_step as j_make_rollout_train_step
from aurora_tpu_torch.checkpoint import restore_train_state, save_train_state
from aurora_tpu_torch.convert import params_from_numpy
from aurora_tpu_torch.model import aurora as port_aurora
from aurora_tpu_torch.model import perceiver, swin3d
from aurora_tpu_torch.model.config import AuroraConfig
from aurora_tpu_torch.tools import rollout_train_bench, train_bench
from aurora_tpu_torch.training import (
    adamw,
    lora_mask,
    mae_loss,
    make_rollout_train_step,
    make_train_step,
)
from tests.conftest import make_batch
from tests.test_torch_grad import targets
from tests.test_torch_support import mean_rel, seeded_matched_models, torch_batch, tree_name


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's tests, the caller's count restored after. The
    suite runs in six worker processes at once (``-n 6``); with PyTorch's default of a thread
    per core, each small op of these tests waited on the other workers' threads (40-100x
    slower than alone in a run of the whole suite). Two threads cost nothing alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


F64 = torch.float64
CFG = dict(embed_dim=256, num_heads=8, encoder_depths=(2, 2, 2), decoder_depths=(2, 2, 2),
           encoder_num_heads=(4, 8, 16), decoder_num_heads=(16, 8, 4), use_lora=True,
           lora_mode="all", lora_steps=3)
LR = 1e-3


def _flat(tree) -> dict:
    return {tree_name(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ------------------------------------------------------------------------------ the optimiser


@pytest.mark.parametrize("accum", [1, 2])
def test_adamw_is_optax_adamw(accum):
    """Three updates (``accum`` calls each) with weight decay, float64."""
    rng = np.random.default_rng(accum)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 2)}
    params = {k: rng.standard_normal(s) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s) for k, s in shapes.items()} for _ in range(3 * accum)]
    tx = j_adamw(1e-2, weight_decay=0.1, accum_steps=accum)
    state, jp = tx.init(params), {k: jnp.asarray(v) for k, v in params.items()}
    module = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                     for k, v in params.items()})
    opt = adamw(1e-2, weight_decay=0.1, accum_steps=accum).init(module)
    update = jax.jit(lambda g, s, p: (lambda u, s: (optax.apply_updates(p, u), s))(
        *tx.update(g, s, p)))
    for g in grads:
        jp, state = update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, p in module.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-12,
                                       atol=1e-14)


def test_lora_mask_marks_the_adapter_banks():
    model = port_aurora.Aurora(AuroraConfig(**CFG), device="meta", seed=None)
    mask = lora_mask(model)
    marked = sorted(n for n, m in mask.items() if m)
    assert marked and all(".lora_qkv." in n or ".lora_proj." in n for n in marked)
    assert len(marked) == 4 * 12  # A and B of two adapters in each of the 12 blocks


# ------------------------------------------------------------------------------ the train step


@pytest.fixture(scope="module")
def pair():
    """The JAX package's model and parameters, the batch, its encodings and the targets."""
    jm, params, _ = seeded_matched_models(CFG)
    jb = make_batch(H=17, W=32).crop(jm.cfg.patch_size)
    enc = jm.prepare_encodings(jb, dtype=jnp.float64)
    levels = tuple(float(x) for x in jb.metadata.atmos_levels)
    ts, ta = targets(jm.cfg, T=2)
    as_j = lambda d: {k: jnp.asarray(np.asarray(v)) for k, v in d.items()}  # noqa: E731
    return dict(jm=jm, params=params, batch=jb, enc=enc, levels=levels, targets=(ts, ta),
                as_j=as_j)


def _port(pair, **knobs):
    tree = jax.tree_util.tree_map(np.asarray, pair["params"])
    return params_from_numpy(tree, AuroraConfig(**CFG, **knobs), device="cpu", dtype=F64)


def _port_loss(pair, **knobs):
    """The port model on the pair's weights with ``knobs`` and a function that runs
    forward_core and the loss."""
    model = _port(pair, **knobs)
    tb = torch_batch(pair["batch"])
    enc = model.prepare_encodings(tb, F64)
    ts, ta = ({k: torch.from_numpy(v[:, 0]) for k, v in d.items()} for d in pair["targets"])

    def run():
        s, a = model.forward_core(tb.surf_vars, tb.static_vars, tb.atmos_vars, enc, 0,
                                  pair["levels"])
        return mae_loss(s, a, ts, ta)

    return model, run


def test_remat_scopes_give_the_same_gradients(pair):
    grads = {}
    for scope, remat in (("full", False), ("full", True), ("no_outer", True), ("blocks", True)):
        model, run = _port_loss(pair, remat=remat, remat_scope=scope)
        run().backward()
        grads[scope, remat] = {n: p.grad for n, p in model.named_parameters()}
    want = grads.pop(("full", False))
    for key, got in grads.items():
        for n, g in got.items():
            err = ((g - want[n]).abs().max() / (want[n].abs().max() + 1e-300)).item()
            assert err <= 1e-12, (key, n, err)



class _Capture:
    """An optimiser that keeps the gradients of one call: the step's own gradients. Its
    ``init`` freezes what ``trainable`` leaves out, as ``adamw``'s does."""

    def __init__(self, trainable=lora_mask):
        self.trainable = trainable

    def init(self, model):
        mask = self.trainable(model)
        for n, p in model.named_parameters():
            if not mask[n]:
                p.requires_grad_(False)
        self.params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        return self

    def step(self):
        self.grads = {n: p.grad.clone() for n, p in self.params.items()}


def test_rollout_train_step_matches_jax(pair):
    """K = 2, ``lora_mode="all"``: the loss and each step's LoRA bank gradient. The JAX
    step's gradients are ``params - params'`` after its step with ``optax.sgd(1.0)``."""
    K = 2
    jm, params, levels, as_j = pair["jm"], pair["params"], pair["levels"], pair["as_j"]
    jb, enc = pair["batch"], pair["enc"]
    ts, ta = ({k: np.moveaxis(v, 1, 0) for k, v in d.items()} for d in pair["targets"])
    abs_t = jnp.stack([jm.prepare_encodings(dataclasses.replace(jb, metadata=dataclasses.replace(
        jb.metadata, time=tuple(t + i * jm.cfg.timestep for t in jb.metadata.time))),
        dtype=jnp.float64).absolute_time for i in range(K)])
    sgd = optax.sgd(1.0)
    step = j_make_rollout_train_step(jm.cfg, sgd, levels, K, trainable=j_lora_mask)
    copy = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), params)  # donated
    new, _, jloss = step(copy, sgd.init(copy), as_j(jb.surf_vars), as_j(jb.static_vars),
                         as_j(jb.atmos_vars), enc, abs_t, jnp.asarray(0, jnp.int32),
                         as_j(ts), as_j(ta))
    before, after = _flat(params), _flat(new)

    model = _port(pair)
    capture = _Capture()
    pstep = make_rollout_train_step(model, capture, levels, K)
    tb = torch_batch(jb)
    tenc = model.prepare_encodings(tb, F64)
    abs_p = torch.stack([model.step_encodings(
        [t + i * model.cfg.timestep for t in tb.metadata.time], F64)[0] for i in range(K)])
    torch.testing.assert_close(abs_p, torch.from_numpy(np.array(abs_t)), rtol=0, atol=0)
    loss = pstep(tb.surf_vars, tb.static_vars, tb.atmos_vars, tenc, abs_p, 0,
                 {k: torch.from_numpy(v) for k, v in ts.items()},
                 {k: torch.from_numpy(v) for k, v in ta.items()})
    assert abs(loss.item() - float(jloss)) <= 1e-10 * abs(float(jloss))
    assert sorted(capture.grads) == sorted(n for n, m in lora_mask(model).items() if m)
    for n, g in capture.grads.items():
        want = before[n] - after[n]
        for bank in range(model.cfg.lora_steps):
            if bank < K:  # each roll-out step trains its own bank
                assert np.abs(want[bank]).max() > 0, (n, bank)
                assert mean_rel(g[bank], want[bank]) <= 1e-8, (n, bank)
            else:
                assert not g[bank].any() and not want[bank].any(), (n, bank)
        assert not torch.equal(g[0], g[1]), n


def test_rollout_train_step_needs_dyn_steps_for_dynamic_vars():
    from aurora_tpu_torch import AuroraAirPollution
    from tests.test_torch_support import SMALL_ARCH

    model = AuroraAirPollution(device="cpu", seed=None, **SMALL_ARCH)
    step = make_rollout_train_step(model, _Capture(), (100.0,), 2)
    with pytest.raises(ValueError, match="dyn_steps"):
        step({}, {}, {}, None, None, 0, {}, {})


# ------------------------------------------------------------------------------ resume


def test_resume_is_bit_for_bit(tmp_path):
    """Three calls of a LoRA step with ``accum_steps=2``, saved in the middle of a cycle,
    then two more; restored into a fresh model and optimiser, the same two calls give the
    same bits in every parameter and in the optimiser's state."""
    cfg = dict(CFG, embed_dim=64, num_heads=4, encoder_num_heads=(2, 4, 8),
               decoder_num_heads=(8, 4, 2))

    def fresh():
        model = port_aurora.Aurora(AuroraConfig(**cfg), device="cpu", seed=3)
        with torch.no_grad():
            g = torch.Generator().manual_seed(4)
            for n, p in model.named_parameters():
                if "modulation" in n or n.endswith(".B"):
                    p.copy_(0.05 * torch.randn(p.shape, generator=g))
        opt = adamw(LR, accum_steps=2, trainable=lora_mask)
        return model, opt, make_train_step(model, opt, (100.0, 250.0, 500.0, 850.0))

    jb = make_batch(H=17, W=32)
    model, opt, step = fresh()
    tb = torch_batch(jb).crop(model.cfg.patch_size)
    enc = model.prepare_encodings(tb, torch.float32)
    b = tb.to("cpu", torch.float32)
    ts = {k: v[:, -1] for k, v in b.surf_vars.items()}
    ta = {k: v[:, -1] for k, v in b.atmos_vars.items()}

    def call(step, i):
        return step(b.surf_vars, b.static_vars, b.atmos_vars, enc, i, ts, ta)

    for i in range(3):
        call(step, i)
    save_train_state(tmp_path / "state.pt", model, opt, step=3)
    for i in (3, 4):
        call(step, i)
    model2, opt2, step2 = fresh()
    assert restore_train_state(tmp_path / "state.pt", model2, opt2) == 3
    for i in (3, 4):
        call(step2, i)
    for (n, p), p2 in zip(model.named_parameters(), model2.parameters()):
        assert torch.equal(p, p2), n
    s, s2 = opt.state_dict(), opt2.state_dict()
    assert s["mini_step"] == s2["mini_step"] == 1
    for a, a2 in zip(s["acc"], s2["acc"]):
        assert torch.equal(a, a2)
    for k, st in s["adamw"]["state"].items():
        for name, v in st.items():
            assert torch.equal(v, s2["adamw"]["state"][k][name]), (k, name)


# ------------------------------------------------------------------------------ launches

TINY = AuroraConfig(embed_dim=64, num_heads=4, encoder_depths=(2, 4, 2), decoder_depths=(2, 4, 2),
                    encoder_num_heads=(2, 4, 8), decoder_num_heads=(8, 4, 2), use_lora=True)
_KEYS = {"roll3d": "roll3d", "window_attention_tail": "window_attention",
         "mlp_adaln_residual": "mlp_adaln_residual", "perceiver_core": "perceiver_core"}


@pytest.mark.parametrize("K,mode,scope,remat", [
    (0, "lora", "full", True), (0, "lora", "no_outer", True), (0, "lora", "blocks", True),
    (0, "lora", "full", False), (0, "full", "full", True), (0, "full", "no_outer", True),
    (2, "lora", "full", True), (2, "lora", "blocks", True)])
def test_expected_launches_are_the_wrappers_calls(K, mode, scope, remat, monkeypatch):
    """The tools on the CPU (depths of 2 and 4 a stage): the forward calls of each kernel
    wrapper in a timed update (a warm-up and one timed update, counted together and halved)
    equal ``expected_launches`` but ``roll3d_bwd`` and ``mlp_adaln_residual_grad``, which the
    plain versions have no launch for: K3's hand-written input gradient once for each K3 call
    of a LoRA step (every block, the decoder's and, from a roll-out's second step, the
    encoder's perceiver), none in a full fine-tune."""
    counts = collections.Counter()
    for module, name in [(swin3d, "roll3d"), (swin3d, "window_attention_tail"),
                         (swin3d, "mlp_adaln_residual"), (perceiver, "perceiver_core"),
                         (perceiver, "mlp_adaln_residual")]:
        def counted(*a, _f=getattr(module, name), _k=_KEYS[name], **kw):
            counts[_k] += 1
            return _f(*a, **kw)

        monkeypatch.setattr(module, name, counted)
    knobs = {"lora_mode": "all", "lora_steps": 4} if K else {}
    cfg = train_bench.train_config(TINY, remat=remat, remat_scope=scope, **knobs)
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
    k3_grads = (sum(depths) + 1) * max(K, 1) + max(K - 1, 0) if mode == "lora" else 0
    assert want.pop("mlp_adaln_residual_grad") == k3_grads
    assert {k: v // 2 for k, v in counts.items()} == want
    assert all(np.isfinite(out["losses"])) and out["device"] == "cpu"


def test_check_launches_raises_on_the_card_where_a_step_differs():
    want = {"roll3d": 4, "window_attention": 6, "roll3d_bwd": 2, "perceiver_core": 0}
    steps = [{"roll3d": 4, "window_attention": 6, "roll3d_bwd": 2},
             {"roll3d": 4, "window_attention": 7, "roll3d_bwd": 2},
             {"roll3d": 4, "window_attention": 6, "roll3d_bwd": 2, "mlp_adaln_residual": 1}]
    assert train_bench.launch_mismatches(steps, want) == [1, 2]
    out = {"device": "cuda", "launches_per_step": steps, "expected_launches": want}
    with pytest.raises(AssertionError, match=r"steps \[1, 2\]"):
        train_bench.check_launches(out)
    train_bench.check_launches(dict(out, launches_per_step=steps[:1]))
    train_bench.check_launches(dict(out, device="cpu"))  # the plain versions count nothing


# ------------------------------------------------------------------------------ TF32


def test_tf32_is_switched_off_only_inside_the_model(monkeypatch):
    seen = []
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        model = port_aurora.Aurora(TINY, device="cpu", seed=None)
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        forward = model.encoder.forward

        def spy(*a, **kw):
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
            return forward(*a, **kw)

        monkeypatch.setattr(model.encoder, "forward", spy)
        model(torch_batch(make_batch(H=17, W=32)))
        assert seen == [(False, False)]
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def test_tf32_is_off_in_the_encoder_decoder_and_breakdown_parts(monkeypatch):
    """The breakdown tools call the encoder and the decoder outside ``forward_core``: each
    enters the TF32-off scope itself, and ``time_parts`` runs every part inside it, so a row
    does the arithmetic of the step it breaks down."""
    from aurora_tpu_torch.tools import perf_breakdown

    seen = []

    def flags():
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))

    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        model = port_aurora.Aurora(TINY, device="cpu", seed=None)
        for module, name in [(model.encoder.surf_token_embeds, "forward"),
                             (model.decoder, "_deaggregate")]:
            inner = getattr(module, name)
            monkeypatch.setattr(module, name, lambda *a, _f=inner, **kw: (flags(), _f(*a, **kw))[1])
        parts = perf_breakdown.step_parts(model, torch_batch(make_batch(H=17, W=32)))
        seen.clear()
        parts["encoder"]()
        parts["decoder"]()
        assert seen == [(False, False)] * 2
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        seen.clear()
        perf_breakdown.time_parts({"probe": flags}, torch.device("cpu"), 1)
        assert seen and set(seen) == {(False, False)}
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
