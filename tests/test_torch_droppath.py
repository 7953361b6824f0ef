"""The port's stochastic training knobs (``drop_path``, ``drop_rate``) on the CPU in float64
against the JAX package.

* Under the JAX run's own masks: JAX's run is left as it is, with its key; the test derives
  each of its masks from that key by ``fold_in`` / ``split`` as ``swin3d.py:1126,1596,1743,
  1756`` do and hands it to the port through its one draw function,
  :func:`aurora_tpu_torch.model.nn.keep_mask`, whose ``path`` names the draw. The port's
  backbone then equals ``swin3d.backbone_apply(..., rng=key)``, and a small model's LoRA
  train step the loss and the LoRA gradients of ``jax.value_and_grad`` of the JAX step's
  loss with ``rng`` (mean relative error <= 1e-8).
* Rate 0 with a generator is the deterministic step: the same bits and the kernels' routing
  (each kernel wrapper called as often).
* With real draws, the same seed gives the same gradients with ``remat_scope="full"`` as
  without remat: a replay in the backward draws the forward's masks (<= 1e-12). The roll-out
  train step draws one seed and puts each step's draws under the step's index.
* The draws: the kept fraction of many draws within binomial bounds, a fresh mask per path
  and seed, the same mask for the same ones; inverted dropout's expectation and values
  (``tests/test_droppath.py:96``).
* The launches of a stochastic step as ``tools.train_bench.expected_launches`` derives them:
  the wrappers' calls of the tool's CPU run.
"""

import collections
import contextlib
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.model import swin3d as j_swin3d
from aurora_tpu.model.aurora import forward_core as j_forward_core
from aurora_tpu.training.train import mae_loss as j_mae_loss
from aurora_tpu_torch.convert import load_numpy_params, params_from_numpy
from aurora_tpu_torch.model import nn, perceiver, swin3d
from aurora_tpu_torch.model.config import AuroraConfig, BackboneConfig
from aurora_tpu_torch.tools import train_bench
from aurora_tpu_torch.training import lora_mask, mae_loss, make_train_step
from tests.conftest import make_batch
from tests.test_torch_grad import targets
from tests.test_torch_support import mean_rel, seeded_matched_models, torch_batch


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, the caller's count restored after (the suite runs six workers
    at once; see ``tests/test_torch_training.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


F64 = torch.float64
BACKBONE = dict(embed_dim=64, encoder_depths=(2, 2), encoder_num_heads=(2, 4),
                decoder_depths=(2, 2), decoder_num_heads=(4, 2), window_size=(2, 4, 4),
                use_lora=True, drop_path=0.3, drop_rate=0.2)
MODEL = dict(embed_dim=64, num_heads=4, encoder_depths=(2, 2), decoder_depths=(2, 2),
             encoder_num_heads=(2, 4), decoder_num_heads=(4, 2), use_lora=True)


def jax_masks(key, calls: list):
    """A stand-in for ``nn.keep_mask`` that returns the JAX run's mask of each draw: the key
    folded with every index of ``path`` but the last, split in five, the last picking one."""

    def keep_mask(shape, keep, seed, path, device):
        k = key
        for i in path[:-1]:
            k = jax.random.fold_in(k, i)
        k = jax.random.split(k, 5)[path[-1]]
        calls.append(path)
        return torch.from_numpy(np.array(jax.random.bernoulli(k, keep, shape))).to(device)

    return keep_mask


def test_backbone_matches_jax_under_its_masks(monkeypatch):
    """Two stages (a patch merge and split), stage ids 0, 1, 100, 101; both knobs on."""
    jcfg = j_swin3d.BackboneConfig(**BACKBONE)
    params = j_swin3d.backbone_init(jax.random.PRNGKey(0), jcfg, dtype=jnp.float64)
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_unflatten(
        tree, [v + 0.05 * rng.standard_normal(v.shape) for v in leaves])
    res = (2, 8, 12)
    x = rng.standard_normal((2, 2 * 8 * 12, 64))
    lead = rng.standard_normal(64)
    key = jax.random.PRNGKey(7)
    run = jax.jit(functools.partial(j_swin3d.backbone_apply, patch_res=res, cfg=jcfg))
    want = np.asarray(run(params, jnp.asarray(x), jnp.asarray(lead), jnp.asarray(1), rng=key))

    bb = swin3d.Backbone(BackboneConfig(**BACKBONE), device="cpu", dtype=F64)
    load_numpy_params(bb, jax.tree_util.tree_map(np.asarray, params))
    det = bb(torch.from_numpy(x), torch.from_numpy(lead), 1, res)
    calls = []
    monkeypatch.setattr(nn, "keep_mask", jax_masks(key, calls))
    got = bb(torch.from_numpy(x), torch.from_numpy(lead), 1, res, key=nn.DrawKey(123))
    assert mean_rel(got, want) <= 1e-8
    assert mean_rel(det, want) > 1e-2  # the masks matter
    # Every block but the two at rate 0 draws (dropout on all of them): 4 stages x 2 blocks.
    assert {p[:2] for p in calls} == {(s, b) for s in (0, 1, 100, 101) for b in (0, 1)}
    assert len(calls) == 8 * 3 + 6 * 2


@pytest.fixture(scope="module")
def lora_pair():
    jm, params, _ = seeded_matched_models(MODEL)
    jb = make_batch(H=17, W=32).crop(jm.cfg.patch_size)
    return dict(jm=jm, params=params, batch=jb,
                levels=tuple(float(x) for x in jb.metadata.atmos_levels),
                targets=targets(jm.cfg))


class _Capture:
    """An optimiser that keeps one call's LoRA gradients; its ``init`` freezes the rest."""

    def init(self, model):
        mask = lora_mask(model)
        for n, p in model.named_parameters():
            p.requires_grad_(mask[n])
        self.params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        return self

    def step(self):
        self.grads = {n: p.grad.clone() for n, p in self.params.items()}


def test_lora_train_step_matches_jax_under_its_masks(lora_pair, monkeypatch):
    knobs = dict(drop_path=0.4, drop_rate=0.1)
    jb, levels, params = lora_pair["batch"], lora_pair["levels"], lora_pair["params"]
    jcfg = lora_pair["jm"].cfg.replace(**knobs)
    enc = lora_pair["jm"].prepare_encodings(jb, dtype=jnp.float64)
    ts, ta = ({k: jnp.asarray(v[:, 0]) for k, v in d.items()} for d in lora_pair["targets"])
    as_j = lambda d: {k: jnp.asarray(np.asarray(v)) for k, v in d.items()}  # noqa: E731
    key = jax.random.PRNGKey(11)

    def loss(p):
        s, a = j_forward_core(p, as_j(jb.surf_vars), as_j(jb.static_vars), as_j(jb.atmos_vars),
                              enc, jnp.asarray(0, jnp.int32), levels, jcfg, rng=key)
        return j_mae_loss(s, a, ts, ta)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(params)
    jflat = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(g)
             for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}

    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              AuroraConfig(**MODEL, **knobs), device="cpu", dtype=F64)
    tb = torch_batch(jb)
    tenc = model.prepare_encodings(tb, F64)
    capture = _Capture()
    step = make_train_step(model, capture, levels)
    calls = []
    monkeypatch.setattr(nn, "keep_mask", jax_masks(key, calls))
    got = step(tb.surf_vars, tb.static_vars, tb.atmos_vars, tenc, 0,
               *({k: torch.from_numpy(v[:, 0]) for k, v in d.items()}
                 for d in lora_pair["targets"]),
               generator=torch.Generator().manual_seed(0))
    assert calls
    assert abs(got.item() - float(jloss)) <= 1e-10 * abs(float(jloss))
    assert sorted(capture.grads) == sorted(n for n, m in lora_mask(model).items() if m)
    for n, g in capture.grads.items():
        assert mean_rel(g, jflat[n]) <= 1e-8, n


def test_rollout_train_step_folds_the_step_index(lora_pair, monkeypatch):
    """K = 2: each roll-out step's draws sit under the step's index, as
    ``aurora_tpu/training/train.py:190`` folds it into the key; the seed is drawn once."""
    from aurora_tpu_torch.training import make_rollout_train_step

    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, lora_pair["params"]),
                              AuroraConfig(**MODEL, drop_path=0.3),
                              device="cpu", dtype=F64)
    tb = torch_batch(lora_pair["batch"])
    enc = model.prepare_encodings(tb, F64)
    abs_t = torch.stack([model.step_encodings(
        [t + i * model.cfg.timestep for t in tb.metadata.time], F64)[0] for i in range(2)])
    ts, ta = ({k: torch.from_numpy(np.stack([v[:, 0]] * 2)) for k, v in d.items()}
              for d in lora_pair["targets"])
    seen = []
    draw = nn.keep_mask

    def recorded(shape, keep, seed, path, device):
        seen.append((seed, path))
        return draw(shape, keep, seed, path, device)

    monkeypatch.setattr(nn, "keep_mask", recorded)
    step = make_rollout_train_step(model, _Capture(), lora_pair["levels"], 2)
    step(tb.surf_vars, tb.static_vars, tb.atmos_vars, enc, abs_t, 0, ts, ta,
         generator=torch.Generator().manual_seed(1))
    assert len({seed for seed, _ in seen}) == 1
    by_step = {i: {p[1:] for _, p in seen if p[0] == i} for i in (0, 1)}
    assert {p[0] for _, p in seen} == {0, 1} and by_step[0] == by_step[1]


def _port_loss(lora_pair, **knobs):
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, lora_pair["params"]),
                              AuroraConfig(**MODEL, **knobs), device="cpu", dtype=F64)
    tb = torch_batch(lora_pair["batch"])
    enc = model.prepare_encodings(tb, F64)
    ts, ta = ({k: torch.from_numpy(v[:, 0]) for k, v in d.items()}
              for d in lora_pair["targets"])

    def run(generator=None):
        s, a = model.forward_core(tb.surf_vars, tb.static_vars, tb.atmos_vars, enc, 0,
                                  lora_pair["levels"], generator=generator)
        return mae_loss(s, a, ts, ta)

    return model, run


def _counting(monkeypatch) -> collections.Counter:
    """Count the calls of the kernel wrappers the model makes (on the CPU each runs its
    plain version)."""
    counts = collections.Counter()
    for module, name in [(swin3d, "roll3d"), (swin3d, "window_attention_tail"),
                         (swin3d, "mlp_adaln_residual"), (perceiver, "perceiver_core"),
                         (perceiver, "mlp_adaln_residual")]:
        def counted(*a, _f=getattr(module, name), _k=name, **kw):
            counts[_k] += 1
            return _f(*a, **kw)

        monkeypatch.setattr(module, name, counted)
    return counts


def test_rate_zero_with_a_generator_is_the_deterministic_step(lora_pair, monkeypatch):
    counts = _counting(monkeypatch)
    _, run = _port_loss(lora_pair)
    det = run()
    det_counts = dict(counts)
    counts.clear()
    sto = run(torch.Generator().manual_seed(3))
    assert torch.equal(det, sto)
    assert dict(counts) == det_counts and det_counts["window_attention_tail"] == 8


def test_a_remat_replay_draws_the_forward_masks(lora_pair):
    knobs = dict(drop_path=0.5, drop_rate=0.2)
    grads = {}
    for remat in (False, True):
        model, run = _port_loss(lora_pair, remat=remat, remat_scope="full", **knobs)
        run(torch.Generator().manual_seed(5)).backward()
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
    _, run = _port_loss(lora_pair, **knobs)
    other = run(torch.Generator().manual_seed(6))
    assert not torch.equal(other, run(torch.Generator().manual_seed(5)))  # a seed matters
    for n, g in grads[True].items():
        want = grads[False][n]
        err = ((g - want).abs().max() / (want.abs().max() + 1e-300)).item()
        assert err <= 1e-12, (n, err)


def test_draws_keep_their_rate_and_dropout_its_expectation():
    n, keep = 10_000, 0.7
    sd = (keep * (1 - keep) / n) ** 0.5
    mask = nn.keep_mask((n,), keep, 1, (0, 0, 1), "cpu")
    assert abs(mask.double().mean().item() - keep) <= 5 * sd
    # drop_path: one flag per batch element, the same for the whole element.
    x = torch.ones(n, 3, 2, dtype=F64)
    y = nn.drop_path(x, 1 - keep, nn.DrawKey(2, (1,)))
    flags = y[:, 0, 0]
    assert torch.equal(y, flags[:, None, None].expand_as(y))
    assert abs((flags > 0).double().mean().item() - keep) <= 5 * sd
    assert set(flags.unique().tolist()) == {0.0, 1 / keep}
    # A draw is a function of its seed and path alone.
    assert torch.equal(mask, nn.keep_mask((n,), keep, 1, (0, 0, 1), "cpu"))
    for seed, path in ((2, (0, 0, 1)), (1, (0, 0, 2)), (1, (0, 1, 1)), (1, (100, 0, 1))):
        assert not torch.equal(mask, nn.keep_mask((n,), keep, seed, path, "cpu"))
    # Inverted dropout (tests/test_droppath.py:96).
    y = nn.dropout(torch.ones(200, 200, dtype=F64), 0.3, nn.DrawKey(0))
    assert abs(y.mean().item() - 1.0) < 0.02
    np.testing.assert_allclose(np.unique(y.numpy()), [0.0, 1 / 0.7], rtol=1e-6)
    # The division happens in x.dtype, and without a key or at rate 0 nothing changes.
    assert nn.dropout(torch.ones(4, dtype=torch.bfloat16), 0.5, nn.DrawKey(0)).dtype == \
        torch.bfloat16
    x = torch.randn(4, 5)
    assert nn.dropout(x, 0.5, None) is x and nn.drop_path(x, 0.0, nn.DrawKey(0)) is x


TINY = AuroraConfig(embed_dim=64, num_heads=4, encoder_depths=(2, 4, 2), decoder_depths=(2, 4, 2),
                    encoder_num_heads=(2, 4, 8), decoder_num_heads=(8, 4, 2), use_lora=True)


@pytest.mark.parametrize("scope,drop_rate", [("full", 0.0), ("blocks", 0.0), ("full", 0.1)])
def test_expected_launches_of_a_stochastic_step_are_the_wrappers_calls(scope, drop_rate,
                                                                         monkeypatch):
    """The tool's CPU run with ``--drop-path`` (a warm-up and one timed step, counted together
    and halved): at ``drop_rate`` 0 the two blocks at rate 0 keep K2 and K3, the others run
    plain; with dropout every block does. K1 is called in every shifted block."""
    counts = _counting(monkeypatch)
    cfg = train_bench.train_config(TINY, remat_scope=scope, drop_path=0.2, drop_rate=drop_rate)
    model = train_bench.build(cfg, torch.device("cpu"), "lora")
    argv = ["--device", "cpu", "--H", "17", "--W", "32", "--steps", "1"]
    with contextlib.redirect_stdout(io.StringIO()):
        out = train_bench.main(argv, model=model)
    want = dict(out["expected_launches"])
    assert want == train_bench.expected_launches(cfg, lora=True, stochastic=True)
    depths = TINY.encoder_depths + TINY.decoder_depths
    assert want.pop("roll3d_bwd") == 2 * sum(d // 2 for d in depths)
    # K3's input gradient: the blocks that keep K3 and the decoder's perceiver.
    assert want.pop("mlp_adaln_residual_grad") == (2 if drop_rate == 0 else 0) + 1
    got = {k: v // 2 for k, v in counts.items()}
    got["window_attention"] = got.pop("window_attention_tail", 0)
    got["mlp_adaln_residual"] = got.get("mlp_adaln_residual", 0)
    assert got == want
    fused = want["window_attention"]
    assert (fused > 0) == (drop_rate == 0)
    deterministic = train_bench.expected_launches(cfg, lora=True)
    assert want["roll3d"] == deterministic["roll3d"]
    assert fused < deterministic["window_attention"]
