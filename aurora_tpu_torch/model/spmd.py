"""The encoder and decoder on each rank's block under a ``(lat, lon)`` mesh (port of
``aurora_tpu/model/spmd.py``).

Everything inside the Perceiver encoder and decoder is local to a block once the pixel grid
is patch-aligned: the patch embedding reads whole patches, the level aggregation and
de-aggregation work per token column (K4 and K3 on the rank's columns), the heads and the
unpatchify per patch, and every other op is elementwise or a last-axis product. So under
an aligned mesh (:func:`spmd_local_aligned`) each rank runs the one-process encoder and
decoder on its block with no collective; the position and scale encodings, made once for
the whole grid in host float64 (``Aurora.grid_encodings``), are cut to the rank's
``(Hp, Wp, D)`` block (``aurora_tpu/model/spmd.py:66-86``).

A pixel grid that the mesh does not split into whole patches (JAX: GSPMD's partitioning,
``tests/test_parallel.py::test_sharded_forward_misaligned_grid``) runs the encoder and the
decoder whole on every rank, on the card as always: the inputs are gathered before the
encoder, the rank keeps its block of the token grid, and the token grid is gathered after
the backbone, each rank keeping its block of the predictions. The numbers are the same.
"""

from __future__ import annotations

import dataclasses

import torch

from aurora_tpu_torch.model.config import AuroraConfig
from aurora_tpu_torch.model.encoder import EncoderEncodings
from aurora_tpu_torch.parallel import halo
from aurora_tpu_torch.parallel.mesh import Mesh
from aurora_tpu_torch.parallel.sharding import (
    TOKENS_5D_SPEC,
    gather_tensor,
    shard_tensor,
)

__all__ = ["decoder_apply_sharded", "decoder_apply_whole", "encoder_apply_sharded",
           "encoder_apply_whole", "spmd_local_aligned"]

_SPATIAL = (None, None, "lat", "lon")  # a (B, T, H, W) field's split over the grid only
_SPATIAL_5D = (None, None, None, "lat", "lon")
_TOKENS = (None,) + TOKENS_5D_SPEC[1:]  # the token grid's split over (lat, lon) only


def spmd_local_aligned(cfg: AuroraConfig, B: int, H: int, W: int, mesh: Mesh) -> bool:
    """True when the encoder and decoder run on each rank's block: the batch ``B`` divides
    ``data`` and the whole pixel grid ``(H, W)`` divides ``patch_size x (lat | lon)``."""
    d, la, lo = (mesh.shape[a] for a in ("data", "lat", "lon"))
    P = cfg.patch_size
    return B % d == 0 and H % (P * la) == 0 and W % (P * lo) == 0


def _local_grid_encodings(enc: EncoderEncodings, grid: tuple[int, int], P: int,
                          mesh: Mesh) -> EncoderEncodings:
    """``enc`` with ``pos`` and ``scale`` cut from the whole ``(Hp, Wp, D)`` grid to this
    rank's block, flattened."""
    Hp, Wp = grid[0] // P, grid[1] // P
    (a, b), (c, d) = halo.local_extents((Hp, Wp), mesh)

    def cut(t):
        return t.reshape(Hp, Wp, -1)[a:b, c:d].reshape((b - a) * (d - c), -1)

    return dataclasses.replace(enc, pos=cut(enc.pos), scale=cut(enc.scale))


def encoder_apply_sharded(encoder, surf, static, atmos, enc: EncoderEncodings, atmos_levels,
                          grid: tuple[int, int], mesh: Mesh) -> torch.Tensor:
    """The encoder on this rank's pixel block (``surf (B, T, h, w)``, ``static`` expanded
    alike, ``atmos (B, T, C, h, w)``) of the whole ``grid``: 5D tokens ``(B, C_l, h / P, w
    / P, D)``, this rank's block of the token grid. No collective."""
    cfg = encoder.cfg
    P = cfg.patch_size
    B, _, h, w = next(iter(surf.values())).shape
    x = encoder(surf, static, atmos, _local_grid_encodings(enc, grid, P, mesh), atmos_levels)
    halo.note("encoder", local=1, grid=grid)
    return x.reshape(B, cfg.latent_levels, h // P, w // P, x.shape[-1])


def decoder_apply_sharded(decoder, x5: torch.Tensor, surf_names, atmos_names, levels_dec,
                          atmos_levels):
    """The decoder on this rank's block of 5D tokens ``(B, C_l, h, w, 2D)``: its block of
    the predictions, ``(B, h P, w P)`` / ``(B, C_A, h P, w P)``. No collective."""
    P = decoder.cfg.patch_size
    B, C_l, h, w, D = x5.shape
    return decoder(x5.reshape(B, C_l * h * w, D), surf_names, atmos_names, levels_dec,
                   (C_l, h, w), h * P, w * P, atmos_levels)


def encoder_apply_whole(encoder, surf, static, atmos, enc: EncoderEncodings, atmos_levels,
                        grid: tuple[int, int], mesh: Mesh) -> torch.Tensor:
    """The encoder of a grid the mesh does not split into whole patches: the pixel blocks
    gathered, the encoder run on the whole grid, and this rank's block of the token grid
    kept (the split rule's block of the ``(Hp, Wp)`` token rows and columns)."""
    cfg = encoder.cfg
    P = cfg.patch_size
    whole = [{k: gather_tensor(v, spec, mesh) for k, v in fields.items()}
             for fields, spec in ((surf, _SPATIAL), (static, _SPATIAL), (atmos, _SPATIAL_5D))]
    x = encoder(*whole, enc, atmos_levels)
    B = x.shape[0]
    x = x.reshape(B, cfg.latent_levels, grid[0] // P, grid[1] // P, x.shape[-1])
    halo.note("encoder", local=0, grid=grid)
    return shard_tensor(x, _TOKENS, mesh)


def decoder_apply_whole(decoder, x5: torch.Tensor, surf_names, atmos_names, levels_dec,
                        atmos_levels, grid: tuple[int, int], mesh: Mesh):
    """The decoder of a grid the mesh does not split into whole patches: the token grid
    gathered, the decoder run on the whole grid, and this rank's block of each prediction
    kept."""
    P = decoder.cfg.patch_size
    x = gather_tensor(x5, _TOKENS, mesh)
    B, C_l, Hp, Wp, D = x.shape
    surf, atmos = decoder(x.reshape(B, C_l * Hp * Wp, D), surf_names, atmos_names, levels_dec,
                          (C_l, Hp, Wp), grid[0], grid[1], atmos_levels)
    return ({k: shard_tensor(v, _SPATIAL[1:], mesh) for k, v in surf.items()},
            {k: shard_tensor(v, _SPATIAL, mesh) for k, v in atmos.items()})
