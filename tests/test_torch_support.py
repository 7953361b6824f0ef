"""Shared helpers of the port's tests (``tests/test_torch_*.py``): matched JAX / port
models built from one numpy-seeded parameter tree, and error measures.

The JAX package runs on the CPU through its XLA route; the port runs its kernels' plain
versions on CPU tensors. Inputs and weights pass between the two as numpy arrays.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import torch


def mean_rel(ours, ref) -> float:
    """Mean absolute error over mean absolute reference (the bar of test_parity_torch)."""
    ours, ref = _np(ours), _np(ref)
    return float(np.abs(ours - ref).mean() / (np.abs(ref).mean() + 1e-30))


def max_rel(ours, ref) -> float:
    """Max absolute error over max absolute reference (the KERNEL_ONCHIP.json measure)."""
    ours, ref = _np(ours), _np(ref)
    return float(np.abs(ours - ref).max() / (np.abs(ref).max() + 1e-30))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float64).cpu().numpy()
    return np.asarray(a).astype(np.float64)


def open_gates(params, std: float = 0.05, seed: int = 0):
    """Fill every FiLM modulation weight and LoRA ``B`` with seeded noise.

    At fresh init both are zero, which makes every Swin block an identity: the kernels'
    outputs would never reach the prediction. The noise of each leaf is seeded from a CRC
    of its path, so the same tree comes out in every process.
    """

    def visit(path, v):
        ks = jax.tree_util.keystr(path)
        if ("modulation" in ks and ks.endswith("['weight']")) or ks.endswith("['B']"):
            rng = np.random.default_rng(zlib.crc32(ks.encode()) + seed)
            return jnp.asarray(std * rng.standard_normal(v.shape), v.dtype)
        return v

    return jax.tree_util.tree_map_with_path(visit, params)


def numpy_tree(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), params)


def matched_models(cfg_kwargs: dict, seed: int = 0):
    """The JAX model and parameters and the port model with the same float64 weights."""
    from aurora_tpu.model.aurora import Aurora as JaxAurora
    from aurora_tpu.model.config import AuroraConfig as JaxConfig
    from aurora_tpu_torch.convert import params_from_numpy
    from aurora_tpu_torch.model.config import AuroraConfig

    jcfg = JaxConfig(**cfg_kwargs)
    jmodel = JaxAurora(jcfg)
    params = open_gates(jmodel.init(jax.random.PRNGKey(seed), dtype=jnp.float64))
    tmodel = params_from_numpy(
        numpy_tree(params), AuroraConfig(**cfg_kwargs), device="cpu", dtype=torch.float64
    )
    return jmodel, params, tmodel


def tree_name(path) -> str:
    """A JAX tree path as the port's parameter name (``a.b.0.c``)."""
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def seeded_matched_models(cfg_kwargs: dict, seed: int = 0):
    """As :func:`matched_models`, without the JAX init's run (ten seconds and more at the
    small config's widths, as long again for the port's own seeded init): the tree's
    structure comes from ``jax.eval_shape`` of the JAX init, its leaves from a numpy seed
    (LayerNorms at weight 1 and bias 0, everything else N(0, 0.02)), then the gates are
    opened as by :func:`open_gates`; the port model holds the same values."""
    from aurora_tpu.model.aurora import Aurora as JaxAurora
    from aurora_tpu.model.config import AuroraConfig as JaxConfig
    from aurora_tpu_torch.model.aurora import Aurora
    from aurora_tpu_torch.model.config import AuroraConfig

    jmodel = JaxAurora(JaxConfig(**cfg_kwargs))
    tmodel = Aurora(AuroraConfig(**cfg_kwargs), device="cpu", dtype=torch.float64, seed=None)
    return (jmodel, *_seeded_tree(jmodel, tmodel, seed, jnp.float64))


def seeded_matched_variant(jax_cls, port_cls, seed: int = 0, dtype=jnp.float64, **overrides):
    """:func:`seeded_matched_models` for a facade of both packages (its hooks and default
    config, with ``overrides``) in ``dtype``: ``(jmodel, params, tmodel)``."""
    jmodel = jax_cls(**overrides)
    tdtype = {jnp.float64: torch.float64, jnp.float32: torch.float32}[dtype]
    tmodel = port_cls(port_config(jmodel.cfg), device="cpu", dtype=tdtype, seed=None)
    return (jmodel, *_seeded_tree(jmodel, tmodel, seed, dtype))


def _seeded_tree(jmodel, tmodel, seed: int, dtype):
    """The numpy-seeded, gates-open tree of ``jmodel``'s structure in ``dtype``, and
    ``tmodel`` holding it."""
    from aurora_tpu_torch.convert import load_numpy_params
    from aurora_tpu_torch.model.nn import LayerNorm

    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(seed), dtype=dtype))
    layernorms = {f"{m_name}.{k}" for m_name, m in tmodel.named_modules()
                  if isinstance(m, LayerNorm) for k in ("weight", "bias")}
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = tree_name(path)
        if name in layernorms:
            return jnp.full(s.shape, 1.0 if name.endswith("weight") else 0.0, s.dtype)
        return jnp.asarray(0.02 * rng.standard_normal(s.shape), s.dtype)

    params = open_gates(jax.tree_util.tree_map_with_path(leaf, shapes), seed=seed)
    return params, load_numpy_params(tmodel, numpy_tree(params))


def torch_batch(jbatch):
    """The port's Batch holding the same arrays as a JAX-package Batch."""
    from aurora_tpu_torch.batch import Batch, Metadata

    md = jbatch.metadata
    return Batch(
        surf_vars={k: torch.from_numpy(np.array(v)) for k, v in jbatch.surf_vars.items()},
        static_vars={k: torch.from_numpy(np.array(v)) for k, v in jbatch.static_vars.items()},
        atmos_vars={k: torch.from_numpy(np.array(v)) for k, v in jbatch.atmos_vars.items()},
        metadata=Metadata(
            lat=np.asarray(md.lat), lon=np.asarray(md.lon), time=md.time,
            atmos_levels=md.atmos_levels, rollout_step=md.rollout_step,
        ),
    )


def port_config(jcfg):
    """The port's config with the fields of a JAX-package config (the port has every field
    but ``agg_chunk_size``)."""
    import dataclasses

    from aurora_tpu_torch.model.config import AuroraConfig

    fields = {f.name for f in dataclasses.fields(AuroraConfig)}
    return AuroraConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})


def matched_variant(jax_cls, port_cls, seed: int = 0, **overrides):
    """A JAX-package facade, its float64 parameters (gates open) and the port's facade of the
    same class name holding them: ``(jmodel, params, tmodel)``."""
    from aurora_tpu_torch.convert import load_numpy_params

    jmodel = jax_cls(**overrides)
    params = open_gates(jmodel.init(jax.random.PRNGKey(seed), dtype=jnp.float64))
    tmodel = port_cls(port_config(jmodel.cfg), device="cpu", dtype=torch.float64, seed=None)
    return jmodel, params, load_numpy_params(tmodel, numpy_tree(params))


_SLOT = {"attn": "0", "mlp": "1", "ln1": "2", "ln2": "3"}


def reference_state_dict(params) -> dict[str, np.ndarray]:
    """A parameter tree of the JAX package written in the reference's checkpoint format: the
    inverse of ``aurora_tpu.checkpoint.convert_torch_state_dict`` (torch names, ``(out, in)``
    linear weights, ``(D, 1, T, P, P)`` patch kernels, one LoRA module per step)."""
    import re

    from aurora_tpu_torch.convert import flatten_tree

    sd = {}
    for path, v in flatten_tree(numpy_tree(params)).items():
        v = np.asarray(v)
        k = re.sub(r"(level_agg|level_decoder_alternate|level_decoder)\.layers\.(\d+)\."
                   r"(attn|mlp|ln1|ln2)\.", lambda m: f"{m[1]}.layers.{m[2]}.{_SLOT[m[3]]}.", path)
        if k.startswith("backbone."):
            k = k.replace("time_mlp.fc1.", "time_mlp.0.").replace("time_mlp.fc2.", "time_mlp.2.")
            k = k.replace(".modulation.", ".ln_modulation.1.")
        else:  # Perceiver-style MLPs are Sequentials.
            k = k.replace(".fc1.", ".net.0.").replace(".fc2.", ".net.2.")
        m = re.search(r"(lora_qkv|lora_proj)\.(A|B)$", k)
        if m:
            for step, w in enumerate(v):  # (r, in) A; (r, out) B -> (out, r)
                name = f"{k[:m.start()]}{m[1]}.loras.{step}.lora_{m[2]}"
                sd[name] = np.array(w if m[2] == "A" else w.T, order="C")
            continue
        if v.ndim == 4:  # (T, P, P, D) -> (D, 1, T, P, P)
            v = np.transpose(v, (3, 0, 1, 2))[:, None]
        elif v.ndim == 2 and k.endswith("weight"):
            v = v.T
        sd[k] = np.array(v, order="C")  # a writable copy: torch.from_numpy shares it
    return sd


# The variants' small architecture and levels (``tests/test_parity_variants.py:29-41``).
SMALL_ARCH = dict(
    embed_dim=64, num_heads=4, encoder_depths=(1, 2), encoder_num_heads=(2, 4),
    decoder_depths=(2, 1), decoder_num_heads=(4, 2), latent_levels=2,
)
VARIANT_LEVELS = (100.0, 250.0, 500.0, 850.0)


def make_pollution_batch(H=13, W=24, seed=0):
    """The air-pollution model's raw batch, chemistry fields positive
    (``tests/test_parity_variants.py:66-84``)."""
    import dataclasses

    from tests.conftest import make_batch

    surf = ("2t", "10u", "10v", "msl", "pm1", "pm2p5", "pm10", "tcco", "tc_no", "tcno2",
            "gtco3", "tcso2")
    static = (("lsm", "z", "slt")
              + ("static_ammonia", "static_ammonia_log", "static_co", "static_co_log")
              + ("static_nox", "static_nox_log", "static_so2", "static_so2_log"))
    atmos = ("z", "u", "v", "t", "q", "co", "no", "no2", "go3", "so2")
    b = make_batch(H=H, W=W, levels=VARIANT_LEVELS, surf_vars=surf, static_vars=static,
                   atmos_vars=atmos, seed=seed)
    s = {k: (np.abs(v) if k not in ("2t", "10u", "10v", "msl") else v)
         for k, v in b.surf_vars.items()}
    a = {k: (np.abs(v) if k in ("co", "no", "no2", "go3", "so2") else v)
         for k, v in b.atmos_vars.items()}
    return dataclasses.replace(b, surf_vars=s, atmos_vars=a)


def make_wave_batch(H=17, W=36, seed=0):
    """The wave model's raw batch (``dwi`` and ``wind``, angles in degrees), with tiny wave
    heights on the first two rows so the NaN masking engages
    (``tests/test_parity_variants.py:120-147``)."""
    import dataclasses

    from tests.conftest import make_batch

    wave_in = (("swh", "mwd", "mwp", "pp1d", "shww", "mdww", "mpww", "shts", "mdts", "mpts")
               + ("swh1", "mwd1", "mwp1", "swh2", "mwd2", "mwp2", "wind", "dwi"))
    b = make_batch(H=H, W=W, levels=VARIANT_LEVELS, surf_vars=("2t", "10u", "10v", "msl")
                   + wave_in, static_vars=("lsm", "z", "slt", "wmb", "lat_mask"), seed=seed)
    rng = np.random.default_rng(seed + 1)
    surf = dict(b.surf_vars)
    for k in wave_in:
        if k.startswith("mwd") or k in ("mdww", "mdts", "dwi"):
            surf[k] = rng.uniform(0, 360, surf[k].shape)
        else:
            surf[k] = np.abs(surf[k]) + 0.1
    for k in ("swh", "shww", "shts", "swh1", "swh2"):
        x = np.array(surf[k])
        x[..., :2, :] = 1e-6
        surf[k] = x
    static = dict(b.static_vars)
    static["wmb"] = (rng.uniform(-1, 1, static["wmb"].shape) > 0).astype(np.float64)
    return dataclasses.replace(b, surf_vars=surf, static_vars=static)


def batch_errors(got, want) -> dict:
    """Mean relative error per output variable where the reference is finite; the NaN masks
    of the two must be equal and the variable sets the same."""
    out = {}
    for group in ("surf_vars", "atmos_vars"):
        g, w = getattr(got, group), getattr(want, group)
        assert set(g) == set(w), sorted(set(g) ^ set(w))
        for k in w:
            gn, wn = _np(g[k]), _np(w[k])
            assert gn.shape == wn.shape, (k, gn.shape, wn.shape)
            assert np.array_equal(np.isnan(gn), np.isnan(wn)), k
            finite = ~np.isnan(wn)
            out[k] = mean_rel(gn[finite], wn[finite])
    return out
