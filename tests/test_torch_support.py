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
