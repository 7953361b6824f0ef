"""``aurora_tpu_torch/tools/kernel_slate.py`` on the CPU: the rehearsal's rows and labels (the
JAX tool's), its floors from the counted work, and each part's callable against the JAX
function of the same label in float64 (``level_patch_embed_apply`` for both embeddings,
``patch_merge_apply``, ``patch_split_apply``), at a mean relative error of at most 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.model.patchembed import level_patch_embed_apply
from aurora_tpu.model.swin3d import patch_merge_apply, patch_split_apply
from aurora_tpu_torch.model.config import LARGE_CONFIG
from aurora_tpu_torch.tools import HBM, PEAK_BF16, PEAK_F32, kernel_slate
from tests.test_torch_support import mean_rel

LABELS = ["patch-embed surf (7 vars)", "patch-embed atmos (5 vars x 13 levels)",
          "patch-merge s0->s1", "patch-split s1->s0"]


def test_rehearsal_rows_and_floors(capsys):
    rows = kernel_slate.main(["--device", "cpu", "--steps", "1", "--H", "48", "--W", "96"])
    assert [r["label"] for r in rows] == LABELS
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("device cpu") and len(lines) == 1 + len(rows)
    work = kernel_slate.slate_work(LARGE_CONFIG, 48, 96)
    for r in rows:
        flops, nbytes, f32 = work[r["label"]]
        assert r["ms"] > 0 and r["launches"] == {} and r["device"] == "cpu"
        floor = 1e3 * max(flops / (PEAK_F32 if f32 else PEAK_BF16), nbytes / HBM)
        assert r["bound_ms"] == pytest.approx(floor)
        assert r["of_floor"] == pytest.approx(r["bound_ms"] / r["ms"])
    # The JAX tool's counts (tools/kernel_slate.py:99-153) at 48 x 96, D 512, P 4.
    assert work[LABELS[0]][:2] == (2 * 12 * 24 * (7 * 2 * 16) * 512,
                                   (2 * 7 * 48 * 96 + 12 * 24 * 512) * 4)
    assert work[LABELS[2]][:2] == (2 * (4 * 12 * 24 // 4) * 2048 * 1024,
                                   (4 * 12 * 24 * 512 + 4 * 12 * 24 // 4 * 1024) * 2)


def _tree(module: torch.nn.Module) -> dict:
    """A port module's parameters as the JAX package's nested tree."""
    out: dict = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(p.detach().numpy())
    return out


@pytest.fixture(scope="module")
def f64_parts():
    cfg = LARGE_CONFIG.replace(embed_dim=32)
    gen = torch.Generator().manual_seed(3)
    inputs = kernel_slate.slate_inputs(cfg, 16, 32, "cpu", gen, embed_dtype=torch.float64,
                                       shuffle_dtype=torch.float64)
    return cfg, inputs, kernel_slate.slate_parts(cfg, inputs)


def test_parts_match_the_jax_functions(f64_parts):
    cfg, i, parts = f64_parts
    P = cfg.patch_size
    assert list(parts) == LABELS
    x = jnp.asarray(i["surf_stack"].numpy())
    want = level_patch_embed_apply(_tree(i["surf_embed"]), x, i["surf_names"], P)
    assert mean_rel(parts[LABELS[0]](), want) <= 1e-12

    xa = jnp.asarray(i["atmos_stack"].numpy())
    want = jax.vmap(lambda xc: level_patch_embed_apply(_tree(i["atmos_embed"]), xc,
                                                       i["atmos_names"], P),
                    in_axes=3, out_axes=1)(xa)
    got = parts[LABELS[1]]()
    assert got.shape == want.shape and mean_rel(got, want) <= 1e-12

    want = patch_merge_apply(_tree(i["merge"]), jnp.asarray(i["merge_x"].numpy()),
                             i["merge_res"])
    got = parts[LABELS[2]]()
    assert got.shape == want.shape and mean_rel(got, want) <= 1e-12

    want = patch_split_apply(_tree(i["split"]), jnp.asarray(i["split_x"].numpy()),
                             i["split_res"], (0, 0, 0))
    got = parts[LABELS[3]]()
    assert got.shape == want.shape and mean_rel(got, want) <= 1e-12
    assert np.isfinite(np.asarray(want)).all()
