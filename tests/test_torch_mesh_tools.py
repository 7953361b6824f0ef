"""The port's mesh tools that time the model on one card (``aurora_tpu_torch/tools/``
``mesh_kernel_bench``, ``overpad_bench``, ``scaling_bench``), rehearsed on the CPU at a small
size: their checks and their rows, not their times.

* ``mesh_kernel_bench``: the forward under ``make_mesh(1, 1, 1)`` gives the no-mesh bits.
* ``overpad_bench``: a factorisation's over-pad applied in one process
  (``swin3d.overpadded``) leaves the predictions as they are, in float64 to the bit, and pads
  each stage's grid to window x mesh multiples as a rank's block under that mesh does.
* ``scaling_bench``: one and two gloo ranks under ``auto_mesh`` give a row each.
"""

import pytest
import torch

from aurora_tpu_torch.model.aurora import AuroraSmallPretrained
from aurora_tpu_torch.tools import mesh_kernel_bench, overpad_bench, scaling_bench
from aurora_tpu_torch.tools.perf_breakdown import open_gates

SMALL = dict(use_lora=True, embed_dim=64, encoder_depths=(2, 2, 2), decoder_depths=(2, 2, 2))
GRID = ["--H", "40", "--W", "96", "--steps", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def model():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    m = AuroraSmallPretrained(device="cpu", dtype=torch.float64, seed=0, **SMALL)
    open_gates(m)
    yield m
    torch.set_num_threads(n)


def test_mesh_kernel_bench_gives_the_same_bits(model):
    out = mesh_kernel_bench.main(GRID, model=model)
    assert out["same_bits"] and out["ok"] and out["device"] == "cpu"
    assert out["no_mesh_s_per_step"] > 0 and out["mesh_s_per_step"] > 0


def test_overpad_bench_leaves_the_predictions(model):
    out = overpad_bench.main(GRID + ["--geom", "2,2", "--geom", "1,8"], model=model)
    assert out["ok"]
    for geom, row in out["geoms"].items():
        assert row["mean_rel"] == 0.0, geom  # float64: the pad-only windows are cropped
        assert row["extra_token_share"] > 0
    # Tokens 10 x 24, then 5 x 12, 3 x 6: padded to windows (6, 12) x the mesh.
    assert out["geoms"]["2x2"]["padded_grids"] == [(4, 12, 24), (4, 10, 24), (4, 6, 12)]
    assert out["geoms"]["1x8"]["padded_grids"] == [(4, 12, 96), (4, 5, 96), (4, 3, 48)]


def test_scaling_bench_gives_a_row_a_rank_count():
    out = scaling_bench.main(["--small", "--ranks", "1,2"] + GRID)
    rows = out["rows"]
    assert [r["ranks"] for r in rows] == [1, 2]
    assert rows[1]["mesh"] == {"data": 1, "lat": 1, "lon": 2}
    assert rows[0]["efficiency"] == 1.0 and all(r["grid_points_per_s"] > 0 for r in rows)
    assert len(rows[1]["step_s_per_rank"]) == 2
