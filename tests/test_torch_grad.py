"""Gradients of the port (``aurora_tpu_torch/ops/ad.py``, the kernel wrappers' backward, the
model's ``forward_core``) on the CPU in float64.

* ``ops/ad.py`` with a detached stand-in kernel: the ``Function``'s gradients equal autograd
  of the plain math, chunked and unchunked; inputs that need no gradient (``needs_input_grad``)
  get none, and the backward is not asked for them; arguments that are not tensors pass
  through to both functions.
* Each kernel K1-K8 through its wrapper's differentiable path (``_*_differentiable``, with
  the chunk plan of the card and a chunk budget small enough for several ragged chunks), the
  kernel replaced by its plain version: the output and every input's gradient equal
  autograd of the plain version (float64: the bf16 products of the backward's forms are
  float64 products here). Each wrapper's CUDA branch goes through that path under grad
  mode, and its forward never calls the backward's form.
* The model: the loss and every parameter's gradient of one step against ``jax.grad`` of
  the JAX package's ``forward_core`` + ``mae_loss`` (mean relative error <= 1e-8), a full
  fine-tune and LoRA-only (the base frozen: no gradient computed for it), on routes main, W,
  P and X.
* ``make_train_step``: the parameters after two AdamW steps of a full fine-tune, and after
  two updates of a LoRA-only step with ``accum_steps=2`` (four calls, ``optax.MultiSteps``),
  against the JAX step's arithmetic (the jitted value-and-gradient above, the frozen leaves'
  gradients stopped, the JAX package's ``adamw``), mean relative error <= 1e-8.

The model is the small config's widths at two blocks a stage (the second shifted) on a
17 x 32 grid, gates open, inputs from numpy seeds.
"""

import ast
import inspect
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aurora_tpu.model.aurora import forward_core as j_forward_core
from aurora_tpu.training.train import adamw as j_adamw
from aurora_tpu.training.train import lora_mask as j_lora_mask
from aurora_tpu.training.train import mae_loss as j_mae_loss
from aurora_tpu_torch.convert import params_from_numpy
from aurora_tpu_torch.model.config import AuroraConfig
from aurora_tpu_torch.ops import ad, mlp, resampler, roll, window_attention
from aurora_tpu_torch.ops.masks import window_group_ids
from aurora_tpu_torch.training import adamw, lora_mask, mae_loss, make_train_step
from tests.conftest import make_batch
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


# ------------------------------------------------------------------------------ ops/ad.py


def _math(x, w, b, part=None):
    return torch.nn.functional.gelu(x @ w + b)


def _stand_in(x, w, b):
    """A kernel's stand-in: the same values, no graph (the Function runs it under no_grad)."""
    assert not torch.is_grad_enabled()
    return _math(x, w, b)


def _leaves(rng, *shapes):
    return [torch.from_numpy(rng.standard_normal(s)).requires_grad_() for s in shapes]


@pytest.mark.parametrize("chunks", [None, ad.Chunks((0, None, None), 0, ((0, 3), (3, 7), (7, 10)))],
                         ids=["unchunked", "chunked"])
def test_function_gradients_equal_plain_autograd(chunks):
    rng = np.random.default_rng(0)
    x, w, b = _leaves(rng, (10, 6), (6, 5), (5,))
    out = ad.kernel_with_plain_grad(_stand_in, _math, chunks=chunks)(x, w, b)
    assert out.grad_fn is not None
    assert torch.equal(out, _math(x, w, b))
    g = torch.from_numpy(rng.standard_normal((10, 5)))
    got = torch.autograd.grad(out, (x, w, b), g)
    want = torch.autograd.grad(_math(x, w, b), (x, w, b), g)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("chunks", [None, ad.Chunks((0, None, None), 0, ((0, 4), (4, 10)))],
                         ids=["unchunked", "chunked"])
def test_needs_input_grad_skips_the_weight_gradients(chunks):
    rng = np.random.default_rng(1)
    x, w, b = _leaves(rng, (10, 6), (6, 5), (5,))
    w.requires_grad_(False)
    b.requires_grad_(False)
    asked = []

    def grad_fn(x, w, b, part=None):
        asked.append((x.requires_grad, w.requires_grad, b.requires_grad, part))
        return _math(x, w, b)

    out = ad.kernel_with_plain_grad(_stand_in, grad_fn, chunks=chunks)(x, w, b)
    out.sum().backward()
    parts = [None] if chunks is None else [slice(*p) for p in chunks.bounds]
    assert asked == [(True, False, False, p) for p in parts]
    torch.testing.assert_close(x.grad, torch.autograd.grad(_math(x, w, b).sum(), x)[0])
    assert w.grad is None and b.grad is None


def test_non_tensor_arguments_pass_through_and_get_no_gradient():
    rng = np.random.default_rng(2)
    x, w = _leaves(rng, (4, 3), (3, 2))
    seen = []

    def kernel(x, w, scale, flag):
        seen.append(("kernel", scale, flag))
        return _math(x, w, 0.0) * scale

    def grad_fn(x, w, scale, flag, part=None):
        seen.append(("grad", scale, flag))
        return _math(x, w, 0.0) * scale

    out = ad.kernel_with_plain_grad(kernel, grad_fn)(x, w, 2.5, "tail")
    out.sum().backward()
    assert seen == [("kernel", 2.5, "tail"), ("grad", 2.5, "tail")]
    want = torch.autograd.grad((_math(x, w, 0.0) * 2.5).sum(), [x, w])
    torch.testing.assert_close(x.grad, want[0], rtol=1e-13, atol=1e-13)
    torch.testing.assert_close(w.grad, want[1], rtol=1e-13, atol=1e-13)


def test_no_function_without_grad_mode_or_a_tensor_that_needs_one():
    x = torch.ones(2, requires_grad=True)
    assert ad.needs_grad(x, 3, None)
    assert not ad.needs_grad(x.detach(), 3)
    with torch.no_grad():
        assert not ad.needs_grad(x)


@pytest.mark.parametrize("n,step", [(10, 3), (10, 10), (10, 40), (7, 1)])
def test_chunk_bounds_cover_each_index_once(n, step):
    b = ad.chunk_bounds(n, step)
    assert [i for a, e in b for i in range(a, e)] == list(range(n))
    assert all(e - a <= step for a, e in b)


# ------------------------------------------------------------- the wrappers' backward paths

F64 = torch.float64


def _t(rng, *shape, std=1.0):
    return (torch.from_numpy(rng.standard_normal(shape)) * std).requires_grad_()


def _roll_case(rng, monkeypatch):
    monkeypatch.setattr(roll, "_roll3d_launch", lambda x, s, key: roll.roll3d_plain(x, s))
    x = _t(rng, 2, 4, 6, 12, 8)
    return (lambda x: roll._Roll.apply(x, (-1, 3, -6)), (x,),
            lambda x: roll.roll3d_plain(x, (-1, 3, -6)), 1 << 30)


def _k3_case(rng, monkeypatch):
    monkeypatch.setattr(mlp, "_mlp_adaln_residual_launch", mlp.mlp_adaln_residual_plain)
    a = (_t(rng, 2, 40, 16), _t(rng, 16, 32, std=0.3), _t(rng, 32), _t(rng, 32, 16, std=0.3),
         _t(rng, 16), _t(rng, 2, 16), _t(rng, 2, 16), 1.0, 1e-5)
    return mlp._mlp_adaln_residual_differentiable, a, mlp.mlp_adaln_residual_plain, 4 * 32 * 2 * 7


def _k8_case(rng, monkeypatch):
    monkeypatch.setattr(mlp, "_mlp_fused_launch", mlp.mlp_fused_plain)
    a = (_t(rng, 50, 16), _t(rng, 16, 32, std=0.3), _t(rng, 32), _t(rng, 32, 16, std=0.3),
         _t(rng, 16))
    return mlp._mlp_fused_differentiable, a, mlp.mlp_fused_plain, 4 * 32 * 9


def _k5_case(rng, monkeypatch):
    monkeypatch.setattr(mlp, "_linear_adaln_residual_launch", mlp.linear_adaln_residual_plain)
    a = (_t(rng, 2, 30, 16), _t(rng, 16, 16, std=0.3), _t(rng, 16), _t(rng, 2, 30, 16),
         _t(rng, 2, 16), _t(rng, 2, 16), 0.5)
    return (mlp._linear_adaln_residual_differentiable, a, mlp.linear_adaln_residual_plain,
            4 * 32 * 2 * 8)


def _k4_plain(ctx, wk, wv, qh, wout, l1w, l1b, q, scale, eps, vb, lw, lb):
    return resampler.perceiver_core_plain(ctx, wk, wv, qh, wout, l1w, l1b, q, scale=scale,
                                          ln_eps=eps, value_bf16=vb,
                                          lnk=None if lw is None else (lw, lb))


def _k4_case(rng, monkeypatch, lnk):
    monkeypatch.setattr(resampler, "_perceiver_core_launch", _k4_plain)
    K, M, D, Q, h, dh, Do = 3, 25, 16, 5, 2, 4, 12
    ln = (_t(rng, h * dh), _t(rng, h * dh)) if lnk else (None, None)
    a = (_t(rng, K, M, D), _t(rng, D, h * dh, std=0.3), _t(rng, D, h * dh, std=0.3),
         _t(rng, Q, h, dh), _t(rng, h * dh, Do, std=0.3), _t(rng, Do), _t(rng, Do),
         _t(rng, Q, Do), dh**-0.5, 1e-5, False, *ln)
    per_col = 4 * (K * (D + 2 * h * dh + 2 * Q * h) + Q * (h * dh + 2 * Do))
    return resampler._perceiver_core_differentiable, a, _k4_plain, per_col * 6


WS, SS = (2, 6, 12), (1, 3, 6)


def _attn_args(rng, masked, tail, xshape):
    D, heads = 16, 2
    groups = window_group_ids(4, 12, 24, WS, SS) if masked else None
    t = (_t(rng, D, D, std=0.3), _t(rng, D), _t(rng, 1, D), _t(rng, 1, D)) if tail else (None,) * 4
    return _t(rng, *xshape), _t(rng, D, 3 * D, std=0.3), _t(rng, 3 * D), groups, heads, t


def _k2_case(rng, monkeypatch, masked, tail):
    def plain(xp, wqkv, bqkv, groups, ws, heads, wproj, bproj, shift, scale, eps):
        t = None if wproj is None else (wproj, bproj, shift, scale)
        return window_attention.window_attention_tail_plain(xp, wqkv, bqkv, groups, ws, heads,
                                                            t, eps)

    monkeypatch.setattr(window_attention, "_window_attention_tail_launch", plain)
    xp, wqkv, bqkv, groups, heads, t = _attn_args(rng, masked, tail, (1, 4, 12, 24, 16))
    a = (xp, wqkv, bqkv, groups, WS, heads, *t, 1e-5)
    row = heads * 144 * 144 * 4 * 2 * 2  # one row of windows a chunk: two chunks
    return window_attention._window_attention_tail_differentiable, a, plain, row


def _k6_case(rng, monkeypatch, masked, tail):
    def plain(xw, wqkv, bqkv, groups, heads, wproj, bproj, shift, scale, eps):
        t = None if wproj is None else (wproj, bproj, shift, scale)
        return window_attention.window_attention_windowed_plain(xw, wqkv, bqkv, groups, heads,
                                                                t, eps)

    monkeypatch.setattr(window_attention, "_window_attention_windowed_launch", plain)
    xw, wqkv, bqkv, groups, heads, t = _attn_args(rng, masked, tail, (1, 8, 144, 16))
    a = (xw, wqkv, bqkv, groups, heads, *t, 1e-5)
    return (window_attention._window_attention_windowed_differentiable, a, plain,
            3 * heads * 144 * 144 * 4)


def _k7_case(rng, monkeypatch, masked):
    monkeypatch.setattr(window_attention, "_sdpa_windows_launch",
                        window_attention.sdpa_windows_plain)
    groups = window_group_ids(4, 12, 24, WS, SS) if masked else None
    a = (_t(rng, 1, 8, 144, 48), groups, 2)
    return (window_attention._sdpa_windows_differentiable, a,
            window_attention.sdpa_windows_plain, 3 * 2 * 144 * 144 * 4)


CASES = {
    "K1 roll3d": _roll_case,
    "K2 masked, tail": lambda r, m: _k2_case(r, m, True, True),
    "K2 unmasked, no tail": lambda r, m: _k2_case(r, m, False, False),
    "K3 mlp_adaln_residual": _k3_case,
    "K4 perceiver_core": lambda r, m: _k4_case(r, m, False),
    "K4 perceiver_core, ln_k": lambda r, m: _k4_case(r, m, True),
    "K5 linear_adaln_residual": _k5_case,
    "K6 masked, tail": lambda r, m: _k6_case(r, m, True, True),
    "K6 unmasked, no tail": lambda r, m: _k6_case(r, m, False, False),
    "K7 sdpa_windows, masked": lambda r, m: _k7_case(r, m, True),
    "K8 mlp_fused": _k8_case,
}


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_backward_equals_plain_autograd(name, monkeypatch):
    """The wrapper's differentiable path, its kernel replaced by the plain version: the
    output is the plain version's and every gradient is autograd's of the plain version,
    over several ragged chunks."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    fn, args, plain, budget = CASES[name](rng, monkeypatch)
    monkeypatch.setattr(ad, "GRAD_CHUNK_BYTES", budget)
    out = fn(*args)
    want = plain(*args)
    assert out.grad_fn is not None and torch.equal(out, want.detach())
    g = torch.from_numpy(rng.standard_normal(out.shape))
    leaves = [a for a in args if isinstance(a, torch.Tensor)]
    got = torch.autograd.grad(out, leaves, g)
    ref = torch.autograd.grad(want, leaves, g)
    # Against the largest gradient of the call: ln_k's bias adds a constant over the levels
    # to the logits, which the softmax over the levels removes, so its gradient is zero and
    # both sides hold rounding noise.
    scale = max(e.abs().max().item() for e in ref)
    for i, (a, e) in enumerate(zip(got, ref)):
        err = (a - e).abs().max().item() / max(e.abs().max().item(), 1e-3 * scale)
        assert err <= 1e-12, (i, err)


WRAPPERS = {
    "roll3d": (roll.roll3d, "_Roll"),
    "window_attention_tail": (window_attention.window_attention_tail,
                              "_window_attention_tail_differentiable"),
    "window_attention_windowed": (window_attention.window_attention_windowed,
                                  "_window_attention_windowed_differentiable"),
    "sdpa_windows": (window_attention.sdpa_windows, "_sdpa_windows_differentiable"),
    "mlp_adaln_residual": (mlp.mlp_adaln_residual, "_mlp_adaln_residual_differentiable"),
    "mlp_fused": (mlp.mlp_fused, "_mlp_fused_differentiable"),
    "linear_adaln_residual": (mlp.linear_adaln_residual, "_linear_adaln_residual_differentiable"),
    "perceiver_core": (resampler.perceiver_core, "_perceiver_core_differentiable"),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_cuda_branch_goes_through_the_function_under_grad(name):
    """After the CPU branch, a call whose inputs need a gradient under grad mode returns the
    differentiable path; the backward's form is handed to ``ad`` and never called by the
    wrapper, its differentiable path or its launch."""
    fn, path = WRAPPERS[name]
    body = ast.parse(inspect.getsource(fn)).body[0].body
    i = next(i for i, n in enumerate(body) if isinstance(n, ast.If)
             and 'device.type == "cpu"' in ast.unparse(n.test).replace("'", '"'))
    gate = next(n for n in body[i + 1:] if isinstance(n, ast.If))
    assert isinstance(gate.body[-1], ast.Return)
    test = ast.unparse(gate.test)
    assert "needs_grad" in test or "requires_grad" in test, test
    assert path in ast.unparse(gate.body[-1])
    module = inspect.getmodule(fn)
    grads = [n for n in vars(module) if n.startswith("_") and n.endswith("_grad")]
    called = set()
    for f in [fn] + [getattr(module, n) for n in vars(module)
                     if n.endswith(("_differentiable", "_launch"))]:
        for node in ast.walk(ast.parse(inspect.getsource(f))):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                called.add(node.func.id)
    assert not called & set(grads), called & set(grads)


# ------------------------------------------------------------------------------ the model

LR = 1e-3


def _flat(tree) -> dict:
    return {tree_name(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


CFG = dict(embed_dim=256, num_heads=8, encoder_depths=(2, 2, 2), decoder_depths=(2, 2, 2),
           encoder_num_heads=(4, 8, 16), decoder_num_heads=(16, 8, 4), use_lora=True)
ROUTES = {"main": {}, "W": dict(attention_impl="pallas_windowed", mlp_impl="fused"),
          "P": dict(attention_impl="pallas", mlp_impl="pallas"),
          "X": dict(attention_impl="xla", mlp_impl="fused")}


def targets(cfg, seed=1, T=1):
    """Seeded targets of plausible magnitudes: a batch's last ``T`` frames, as numpy."""
    b = make_batch(H=17, W=32, T=T, seed=seed).crop(cfg.patch_size)
    return ({k: np.asarray(v)[:, -T:] for k, v in b.surf_vars.items()},
            {k: np.asarray(v)[:, -T:] for k, v in b.atmos_vars.items()})


@pytest.fixture(scope="module")
def reference():
    """The JAX package's loss and gradients (every leaf) of one step, and its jitted
    value-and-gradient."""
    jm, params, _ = seeded_matched_models(CFG)
    jb = make_batch(H=17, W=32).crop(jm.cfg.patch_size)
    enc = jm.prepare_encodings(jb, dtype=jnp.float64)
    levels = tuple(float(x) for x in jb.metadata.atmos_levels)
    ts, ta = targets(jm.cfg)
    as_j = lambda d: {k: jnp.asarray(np.asarray(v)) for k, v in d.items()}  # noqa: E731

    def loss(p):
        s, a = j_forward_core(p, as_j(jb.surf_vars), as_j(jb.static_vars), as_j(jb.atmos_vars),
                              enc, jnp.asarray(0, jnp.int32), levels, jm.cfg)
        return j_mae_loss(s, a, {k: v[:, 0] for k, v in as_j(ts).items()},
                          {k: v[:, 0] for k, v in as_j(ta).items()})

    vg = jax.jit(jax.value_and_grad(loss))
    value, grads = vg(params)
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    return dict(params=params, vg=vg, tree=jax.tree_util.tree_map(np.asarray, params),
                batch=jb, levels=levels, targets=(ts, ta), loss=float(value),
                grads={tree_name(p): np.asarray(g) for p, g in flat})


def port_loss(ref, **knobs):
    """The port model on the reference's weights with ``knobs``, its inputs, and a function
    that runs forward_core and the loss."""
    model = params_from_numpy(ref["tree"], AuroraConfig(**CFG, **knobs), device="cpu",
                              dtype=F64)
    tb = torch_batch(ref["batch"])
    enc = model.prepare_encodings(tb, F64)
    ts, ta = ({k: torch.from_numpy(v[:, 0]) for k, v in d.items()} for d in ref["targets"])

    def run():
        s, a = model.forward_core(tb.surf_vars, tb.static_vars, tb.atmos_vars, enc, 0,
                                  ref["levels"])
        return mae_loss(s, a, ts, ta)

    return model, run


@pytest.mark.parametrize("mode", ["full", "lora"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_gradients_match_jax(reference, route, mode):
    model, run = port_loss(reference, **ROUTES[route])
    if mode == "lora":
        mask = lora_mask(model)
        for n, p in model.named_parameters():
            p.requires_grad_(mask[n])
    loss = run()
    loss.backward()
    assert abs(loss.item() - reference["loss"]) <= 1e-10 * abs(reference["loss"])
    errs, checked = {}, 0
    for n, p in model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None, n
            continue
        errs[n] = mean_rel(p.grad, reference["grads"][n])
        checked += 1
    assert max(errs.values()) <= 1e-8, sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    if mode == "lora":
        assert checked == sum(lora_mask(model).values()) == 4 * 12
    else:
        assert checked == len(reference["grads"])


@pytest.mark.parametrize("mode,accum", [("full", 1), ("lora", 2)])
def test_params_after_two_adamw_updates_match_jax(reference, mode, accum):
    lora = mode == "lora"
    calls = 2 * accum
    # The JAX step: value_and_grad of compute_loss (frozen leaves' gradients stopped), the
    # optimiser's update, apply_updates.
    tx = j_adamw(LR, accum_steps=accum, trainable=j_lora_mask if lora else None)

    @jax.jit
    def update(g, state, params):
        if lora:
            g = jax.tree_util.tree_map(lambda x, m: x if m else jnp.zeros_like(x), g,
                                       j_lora_mask(params))
        updates, state = tx.update(g, state, params)
        return optax.apply_updates(params, updates), state

    params = reference["params"]
    state, jl = tx.init(params), []
    for _ in range(calls):
        value, g = reference["vg"](params)
        params, state = update(g, state, params)
        jl.append(float(value))
    want = _flat(params)

    model = params_from_numpy(reference["tree"], AuroraConfig(**CFG), device="cpu",
                              dtype=F64)
    mask = lora_mask if lora else None
    step = make_train_step(model, adamw(LR, accum_steps=accum, trainable=mask),
                           reference["levels"])
    tb = torch_batch(reference["batch"])
    enc = model.prepare_encodings(tb, F64)
    ts, ta = ({k: torch.from_numpy(v[:, 0]) for k, v in d.items()} for d in reference["targets"])
    losses = [step(tb.surf_vars, tb.static_vars, tb.atmos_vars, enc, 0, ts, ta).item()
              for _ in range(calls)]
    np.testing.assert_allclose(losses, jl, rtol=1e-10)
    moved, start = 0, dict(_flat(reference["params"]))
    for n, p in model.named_parameters():
        assert p.requires_grad == (not lora or lora_mask(model)[n]), n
        err = mean_rel(p, want[n])
        assert err <= 1e-8, (n, err)
        moved += not np.array_equal(p.detach().numpy(), start[n])
    assert moved == (4 * 12 if lora else len(want))
