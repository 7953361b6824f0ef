"""The backbone's routing knobs (``attention_impl`` x ``mlp_impl``) in the port against the
JAX package on the CPU.

* ``SwinBlock`` under each route, shifted and unshifted, against ``swin3d.swin_block_apply``
  with the same route. The JAX side runs its Pallas kernels in interpret mode
  (``AURORA_PALLAS_INTERPRET=1``, as tests/test_block_routing.py sets it), the port its
  kernels' plain versions. FiLM gates and LoRA ``B`` are open. Tolerance, max |error| over
  max |reference|: 2e-5 in f32 (the JAX kernels' f32 erf polynomial, 2.8e-5 from float64 at
  the MLP's output, is damped by the block's residual); 2e-2 in bf16. In bf16 each side
  rounds the residual stream twice, at outputs up to ~6.3 where one ulp is 4.9e-3 of the
  largest output, and the JAX side's plain elementwise chains keep f32 precision inside
  XLA's fusions where the port rounds after each op, as the JAX code is written. Measured
  on this test's inputs: JAX 6.3e-3 to 9.4e-3 and the port 7.5e-3 to 1.64e-2 from the float64
  block, and 2 to 3 ulps (up to 1.49e-2) apart.
* ``lora_apply``, the unfused LoRA side path, against the JAX one in float64.
* The config knobs: the same values and meanings as the JAX package's, passed through the
  ``backbone`` property; an unknown value raises.

The whole model under each route against the JAX model in float64 is in
tests/test_torch_model.py, beside the model fixture it shares.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.model import swin3d as j_swin
from aurora_tpu_torch.convert import load_numpy_params
from aurora_tpu_torch.model import config as t_config
from aurora_tpu_torch.model.swin3d import SwinBlock
from tests.test_torch_support import max_rel, mean_rel, numpy_tree

ROUTES = [
    (a, m) for a in ("pallas", "pallas_windowed", "xla") for m in ("fused", "pallas", "xla")
] + [("auto", "auto")]
BLOCK = dict(
    embed_dim=64, encoder_depths=(2,), encoder_num_heads=(4,), decoder_depths=(2,),
    decoder_num_heads=(4,), window_size=(2, 4, 4), use_lora=True, lora_steps=4,
)
DTYPES = {
    "f32": (jnp.float32, torch.float32, 2e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)
}


def _block_params(cfg, D: int):
    """JAX block parameters with the FiLM modulations and LoRA ``B`` filled with seeded
    noise (at init both are zero and the block is an identity)."""
    p = j_swin.swin_block_init(jax.random.PRNGKey(2), D, cfg, dtype=jnp.float32)
    rng = np.random.default_rng(11)
    for norm in ("norm1", "norm2"):
        for leaf in ("weight", "bias"):
            shape = p[norm]["modulation"][leaf].shape
            p[norm]["modulation"][leaf] = jnp.asarray(
                0.1 * rng.standard_normal(shape), jnp.float32
            )
    for name in ("lora_qkv", "lora_proj"):
        shape = p["attn"][name]["B"].shape
        p["attn"][name]["B"] = jnp.asarray(0.1 * rng.standard_normal(shape), jnp.float32)
    return p


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("route", ROUTES, ids=["-".join(r) for r in ROUTES])
def test_swin_block_route_matches_jax(monkeypatch, route, shifted, dtype):
    aimpl, mimpl = route
    jdt, tdt, tol = DTYPES[dtype]
    res, D, heads, step = (2, 8, 12), 64, 4, 1  # W=12 pads to 16: pad tokens in every route
    shift = (1, 2, 2) if shifted else (0, 0, 0)
    kw = dict(BLOCK, attention_impl=aimpl, mlp_impl=mimpl)
    jcfg = j_swin.BackboneConfig(**kw)
    params = _block_params(jcfg, D)
    rng = np.random.default_rng(12)
    x, c = rng.standard_normal((2, *res, D)), rng.standard_normal((2, D))

    monkeypatch.setenv("AURORA_PALLAS_INTERPRET", "1")
    want = j_swin.swin_block_apply(
        params, jnp.asarray(x, jdt), jnp.asarray(c, jdt), res, shift, heads,
        jnp.asarray(step, jnp.int32), jcfg,
    )
    block = SwinBlock(D, t_config.BackboneConfig(**kw), device="cpu")
    load_numpy_params(block, numpy_tree(params))
    with torch.no_grad():
        got = block(
            torch.from_numpy(x).to(tdt), torch.from_numpy(c).to(tdt), res, shift, heads, step
        )
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    assert max_rel(got, want) < tol


@pytest.mark.parametrize("mode", ["single", "from_second", "all"])
@pytest.mark.parametrize("step", [0, 1, 40, 45])
def test_lora_apply_matches(mode, step):
    from aurora_tpu.model.lora import lora_apply as j_apply
    from aurora_tpu_torch.model.lora import lora_apply as t_apply

    rng = np.random.default_rng(13)
    n = 40 if mode == "all" else 1
    A, B = rng.standard_normal((n, 8, 24)), rng.standard_normal((n, 8, 36))
    x = rng.standard_normal((5, 24))
    kw = dict(r=8, alpha=4, max_steps=40, mode=mode)
    bank = {"A": jnp.asarray(A), "B": jnp.asarray(B)}
    want = np.asarray(j_apply(bank, jnp.asarray(x), jnp.asarray(step), **kw))
    got = t_apply(torch.from_numpy(A), torch.from_numpy(B), torch.from_numpy(x), step, **kw)
    assert tuple(got.shape) == (5, 36) and got.dtype == torch.float64
    if not want.any():
        assert not got.numpy().any()
    else:
        assert mean_rel(got, want) <= 1e-8


def test_route_knobs_match_the_jax_config():
    from aurora_tpu.model.config import AuroraConfig as JaxConfig

    kw = dict(attention_impl="pallas_windowed", mlp_impl="pallas", use_lora=True)
    t_bb, j_bb = t_config.AuroraConfig(**kw).backbone, JaxConfig(**kw).backbone
    assert (t_bb.attention_impl, t_bb.mlp_impl) == (j_bb.attention_impl, j_bb.mlp_impl)
    assert t_bb.routes() == ("pallas_windowed", "pallas")
    assert t_config.AuroraConfig().backbone.routes() == ("pallas", "fused")
    with pytest.raises(ValueError, match="attention_impl"):
        t_config.AuroraConfig(attention_impl="cuda")
    with pytest.raises(ValueError, match="mlp_impl"):
        t_config.BackboneConfig(mlp_impl="fast")
