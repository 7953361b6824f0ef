"""Per-collective byte inventory of the 1.3 B 0.25 degree model across meshes (counterpart of
``tools/scaling_bytes.py``): for each ``(data, lat, lon)`` mesh, the forward and the train
step, parameters replicated and under ZeRO, every collective a rank enters by kind, with its
count and the bytes it puts in.

The JAX tool compiles the program over virtual devices and reads the collectives XLA
inserted. The port's collectives are its own code's, so this tool counts them from the same
geometry and parameter sizes the run uses: the halo moves' plans
(:func:`~aurora_tpu_torch.parallel.halo.make_move` over ``halo``'s per-axis plans of each
block, merge and split), the gathers of a pixel grid the mesh does not split into whole
patches, the parameters of the model built on the ``meta`` device in their order (the
gradient and ZeRO buckets of :mod:`~aurora_tpu_torch.parallel.sharding`), and the forward
passes of each rematerialised region (:func:`~aurora_tpu_torch.tools.train_bench.
block_runs`). Running the 1.3 B model in eight processes on the CPU would take hours;
:func:`inventory` of a small configuration is held against the ``halo.STATS`` of a real
run of it (``tests/test_torch_lat_lon_train.py``), collective for collective.

Kinds (``halo.report()["by_kind"]``): ``fetch:<enter|leave|merge|split>`` a halo move's
all-gather and ``fetch_T:...`` its transpose in the backward; ``gather`` / ``gather:sizes``
/ ``gather_T`` the whole-grid gathers of the encoder's inputs and the decoder's tokens;
``grid`` the blocks' extents; ``loss`` the loss's sum; ``grad:all_reduce``,
``grad:plane_sum``, ``grad:reduce_scatter`` the gradient buckets; ``zero:all_gather`` the
ZeRO parameters' gather.

Usage: ``python -m aurora_tpu_torch.tools.scaling_bytes [--out SCALING_BYTES_torch.json]
[--matrix "2,2,2:fwd:replicated ..."]``; ``inventory(cfg, grid, mesh, mode, params, ...)``
for one rank of one cell.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from aurora_tpu_torch.model.config import AuroraConfig
from aurora_tpu_torch.model.spmd import spmd_local_aligned
from aurora_tpu_torch.model.swin3d import get_encoder_specs, maybe_adjust_windows
from aurora_tpu_torch.parallel import halo
from aurora_tpu_torch.parallel.sharding import (
    BUCKET_BYTES,
    split_bounds,
    zero_partition_spec,
)
from aurora_tpu_torch.tools.train_bench import block_runs

__all__ = ["At", "MATRIX", "cell", "inventory", "main", "param_shapes"]

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# The JAX tool's cells (``tools/scaling_bytes.py:203-209``) and its file's two extra ones.
MATRIX = ("2,2,2:fwd:replicated 2,2,2:fwd:zero 2,2,2:train:replicated 2,2,2:train:zero "
          "1,2,4:fwd:replicated 1,2,4:fwd:zero 1,4,8:fwd:replicated 1,4,8:fwd:zero "
          "1,1,8:fwd:replicated 2,1,1:train:zero")
GRID = (721, 1440)


class At:
    """A rank's coordinates ``at`` on a mesh of ``shape`` (``{axis: size}``), as the halo
    plans read a mesh (``shape`` and ``axis_index``), with no process group."""

    def __init__(self, shape: dict, at: dict):
        self.shape, self._at = shape, at

    def axis_index(self, axis):
        return self._at[axis]


class _Ledger:
    def __init__(self):
        self.kinds: dict = {}

    def add(self, kind: str, nbytes: int, times: int = 1) -> None:
        if times <= 0:
            return
        e = self.kinds.setdefault(kind, dict(count=0, bytes=0))
        e["count"] += times
        e["bytes"] += int(nbytes) * times


def param_shapes(cfg: AuroraConfig, dtype: torch.dtype = torch.float32,
                 lora_recipe: bool = True) -> list[tuple]:
    """``(name, shape, is LoRA, item size)`` of every parameter of the model of ``cfg`` in
    ``dtype``, in the model's order, as ``tools.train_bench.build`` stores them (its LoRA
    recipe under ``autocast`` keeps the backbone in bf16); built on the ``meta`` device: no
    memory."""
    from aurora_tpu_torch.model.aurora import Aurora, cast_backbone_params

    model = Aurora(cfg, device="meta", dtype=dtype, seed=None)
    if lora_recipe and cfg.autocast:
        cast_backbone_params(model)
    return [(n, tuple(p.shape), any(part.startswith("lora_") for part in n.split(".")),
             p.element_size()) for n, p in model.named_parameters()]


def _buckets(sizes: list[int], weight) -> list[int]:
    """The elements of each run of ``sizes`` that ``sharding._buckets`` cuts at
    :data:`BUCKET_BYTES`, an item weighing ``weight(n)`` bytes."""
    out, run, size = [], 0, 0
    for n in sizes:
        w = weight(n)
        if run and size + w > BUCKET_BYTES:
            out.append(run)
            run, size = 0, 0
        run += n
        size += w
    if run:
        out.append(run)
    return out


def _fetches(ledger: _Ledger, axes, shape: list[int], at: dict, mesh_shape: dict,
             item: int, what: str, runs: int, grad: bool) -> list[int]:
    """The fetches of one move (``axes``: its halo plan a split dimension) of a block of
    ``shape``: ``runs`` forward passes and, with ``grad``, one transpose. Returns the
    block's shape after it."""
    shape = list(shape)
    for dim, axis, cur, want in axes:
        mv = halo.make_move(cur, want, at[axis] if mesh_shape[axis] > 1 else 0, what)
        other = int(np.prod(shape)) // shape[dim]
        if mv.longest:
            ledger.add(f"fetch:{what}", mv.longest * other * item, runs)
            if grad:
                ledger.add(f"fetch_T:{what}", mv.back_longest * other * item)
        shape[dim] = mv.out_rows
    return shape


def _gather(ledger: _Ledger, shape: list[int], dims: tuple[int, int], whole: tuple[int, int],
            mesh_shape: dict, item: int, runs: int, grad: bool) -> None:
    """``gather_tensor`` of a block of ``shape`` whose ``dims`` are its ``(lat, lon)`` block
    of the ``whole`` extents: ``runs`` forward passes and, with ``grad``, one transpose."""
    shape = list(shape)
    for dim, n, axis in zip(dims, whole, ("lat", "lon")):
        k = mesh_shape[axis]
        if k == 1:
            continue
        shape[dim] = max(b - a for a, b in split_bounds(n, k))
        ledger.add("gather:sizes", 8, runs)
        ledger.add("gather", int(np.prod(shape)) * item, runs)
        if grad:
            ledger.add("gather_T", int(np.prod(shape)) * k * item)
        shape[dim] = n


def inventory(cfg: AuroraConfig, grid: tuple[int, int], mesh_shape: dict, mode: str = "fwd",
              params: str = "replicated", batch: int = 1, at: Optional[dict] = None,
              trainable: str = "lora", input_bytes: int = 4, levels: int = 13,
              history: int = 2, shapes: Optional[list] = None) -> dict:
    """The collectives one rank (``at``, ``{axis: index}``; the first by default) enters in
    one call of ``mode``: "fwd" (``forward_core`` without gradients) or "train" (one
    ``make_train_step`` update with ``mae_loss``, ``trainable`` "lora" or "all"
    parameters), of ``cfg`` on the pixel ``grid`` (cropped to the patch here) with a batch
    of ``batch`` (``levels`` pressure levels, ``history`` steps, fields of ``input_bytes``)
    over the mesh, the parameters ``"replicated"`` or under ``"zero"`` (``shard_params``).
    ``shapes``: :func:`param_shapes` of ``cfg``. Returns ``{kind: {"count", "bytes"}}``."""
    at = at or dict(data=0, lat=0, lon=0)
    d, la, lo = (mesh_shape[a] for a in ("data", "lat", "lon"))
    spatial = la > 1 or lo > 1
    train = mode == "train"
    full_scope = train and cfg.remat and cfg.remat_scope == "full"
    tok_item = 2 if cfg.autocast else input_bytes
    dec_item = 4 if cfg.autocast else input_bytes
    acc = 8 if input_bytes == 8 else 4
    B = batch // d
    P = cfg.patch_size
    H, W = grid[0] // P * P, grid[1] // P * P
    ledger = _Ledger()
    shapes = shapes if shapes is not None else param_shapes(cfg)
    split = set()
    if params == "zero" and d > 1:
        split = {n for n, s, _, _ in shapes if zero_partition_spec(s, d)}
        by_dtype: dict = {}
        for n, s, _, item in shapes:
            if n in split:
                by_dtype.setdefault(item, []).append(int(np.prod(s)))
        for item, sizes in by_dtype.items():  # gathered_params: once a call
            for elems in _buckets(sizes, lambda n, item=item: n * item):
                ledger.add("zero:all_gather", elems // d * item)
    if spatial:
        for axis in ("lat", "lon"):
            if mesh_shape[axis] > 1:
                ledger.add("grid", 8)
        aligned = spmd_local_aligned(cfg, batch, H, W, At(mesh_shape, at))
        (r0, r1), (c0, c1) = (split_bounds(n, mesh_shape[a])[at[a]]
                              for n, a in ((H, "lat"), (W, "lon")))
        if not aligned:  # the inputs gathered, the encoder run whole
            runs = 1 + (full_scope and trainable == "all")
            for n_fields, lead in ((len(cfg.surf_vars), (B, history)),
                                   (len(cfg.static_vars), (B, history)),
                                   (len(cfg.atmos_vars), (B, history, levels))):
                for _ in range(n_fields):
                    _gather(ledger, [*lead, r1 - r0, c1 - c0], (len(lead), len(lead) + 1),
                            (H, W), mesh_shape, input_bytes, runs, False)
        bb = cfg.backbone
        all_res, pads = get_encoder_specs(bb, (cfg.latent_levels, H // P, W // P))
        n_enc, n_dec = len(bb.encoder_depths), len(bb.decoder_depths)
        stages = [("enc", i, all_res[i], bb.embed_dim * 2 ** i, bb.encoder_depths[i])
                  for i in range(n_enc)]
        stages += [("dec", i, all_res[n_dec - i - 1], bb.embed_dim * 2 ** (n_dec - i - 1),
                    bb.decoder_depths[i]) for i in range(n_dec)]
        half = tuple(x // 2 for x in bb.window_size)
        outer = 1 + bool(full_scope)  # the merges and splits: the backbone's replay
        first = True
        for s, (part, i, res, D, depth) in enumerate(stages):
            C, Hs, Ws = res
            (a, b), (c, e) = split_bounds(Hs, la)[at["lat"]], split_bounds(Ws, lo)[at["lon"]]
            for blk in range(depth):
                ws, ss = maybe_adjust_windows(bb.window_size, (0, 0, 0) if blk % 2 == 0
                                              else half, res)
                geo = halo.window_geometry(res, ws, ss, At(mesh_shape, at))
                runs = block_runs(cfg, s, blk, depth, len(stages)) if train else 1
                # Under LoRA training the first block's input (the encoder's) needs no
                # gradient.
                grad_in = train and not (first and trainable == "lora")
                shape = _fetches(ledger, halo._enter_axes(geo, mesh_shape),
                                 [B, geo.padded[0], b - a, e - c, D], at, mesh_shape, tok_item,
                                 "enter", runs, grad_in)
                _fetches(ledger, halo._leave_axes(geo, mesh_shape), shape, at, mesh_shape,
                         tok_item, "leave", runs, train)
                first = False
            if part == "enc" and i < n_enc - 1:
                _fetches(ledger, halo._merge_axes(res, mesh_shape), [B, C, b - a, e - c, D],
                         at, mesh_shape, tok_item, "merge", outer, train)
            if part == "dec" and i < n_dec - 1:
                _fetches(ledger, halo._split_axes(res, pads[n_dec - i - 2], mesh_shape),
                         [B, C, 2 * (b - a), 2 * (e - c), D // 2], at, mesh_shape, tok_item,
                         "split", outer, train)
        if not aligned:  # the tokens gathered, the decoder run whole
            Hp, Wp = H // P, W // P
            (a, b), (c, e) = split_bounds(Hp, la)[at["lat"]], split_bounds(Wp, lo)[at["lon"]]
            _gather(ledger, [B, cfg.latent_levels, b - a, e - c, 2 * bb.embed_dim], (2, 3),
                    (Hp, Wp), mesh_shape, dec_item, outer, train)
    if train:
        if spatial:  # the loss's whole grid
            for axis in ("lat", "lon"):
                if mesh_shape[axis] > 1:
                    ledger.add("grid", 8)
        if d * la * lo > 1:
            ledger.add("loss", acc)
        trained = [(n, int(np.prod(s))) for n, s, lora, _ in shapes
                   if trainable == "all" or lora]
        for elems in _buckets([k for n, k in trained if n not in split], lambda n: n * 4):
            ledger.add("grad:all_reduce", elems * acc)
        for elems in _buckets([k for n, k in trained if n in split], lambda n: n * 4):
            if spatial:
                ledger.add("grad:plane_sum", elems * acc)
            ledger.add("grad:reduce_scatter", elems * acc)
    return dict(sorted(ledger.kinds.items()))


def cell(spec: str, cfg: Optional[AuroraConfig] = None, grid=GRID,
         shapes: Optional[list] = None) -> dict:
    """One ``"d,lat,lon:mode:params"`` cell of the 1.3 B production model (its LoRA recipe,
    ``remat`` at "full" in the train step; batch ``d``, 13 levels): every rank's inventory
    of one ``data`` slice (the others' are the same), the largest of each kind, and the
    largest total."""
    from aurora_tpu_torch.tools import train_bench

    mesh_str, mode, params = spec.split(":")
    d, la, lo = (int(v) for v in mesh_str.split(","))
    mesh_shape = dict(data=d, lat=la, lon=lo)
    cfg = cfg or train_bench.train_config()
    shapes = shapes if shapes is not None else param_shapes(cfg)
    coords = [(i, j) for i in range(la) for j in range(lo)]
    ranks = [inventory(cfg, grid, mesh_shape, mode, params, batch=d,
                       at=dict(data=0, lat=i, lon=j), shapes=shapes) for i, j in coords]
    kinds = sorted({k for r in ranks for k in r})
    most = {k: dict(count=max(r.get(k, {}).get("count", 0) for r in ranks),
                    bytes=max(r.get(k, {}).get("bytes", 0) for r in ranks)) for k in kinds}
    return dict(mesh=mesh_shape, mode=mode, params=params,
                param_count=sum(int(np.prod(s)) for _, s, _, _ in shapes),
                collectives_per_rank_max=most,
                total_bytes_per_rank_max=max(sum(v["bytes"] for v in r.values())
                                             for r in ranks),
                halo_bytes_per_rank_max=max(sum(v["bytes"] for k, v in r.items()
                                                if k.startswith("fetch")) for r in ranks),
                ranks=[dict(at=dict(lat=i, lon=j), collectives=r)
                       for (i, j), r in zip(coords, ranks)])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--matrix", default=MATRIX, help="space-separated d,lat,lon:mode:params")
    ap.add_argument("--out", default=os.path.join(ROOT, "SCALING_BYTES_torch.json"))
    args = ap.parse_args(argv)
    from aurora_tpu_torch.tools import train_bench

    cfg = train_bench.train_config()
    shapes = param_shapes(cfg)
    cells = [cell(spec, cfg, shapes=shapes) for spec in args.matrix.split()]
    out = dict(grid=list(GRID), config="Aurora(use_lora=True) 1.3 B, production knobs, LoRA "
               "train step with remat at full (tools.train_bench.train_config)",
               source="aurora_tpu_torch/tools/scaling_bytes.py (counted from the run's "
                      "plans and parameter sizes; held against halo.STATS of a small run "
                      "by tests/test_torch_lat_lon_train.py)",
               bytes="what one rank puts into each collective", cells=cells)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps([dict(mesh=c["mesh"], mode=c["mode"], params=c["params"],
                           total_bytes_per_rank_max=c["total_bytes_per_rank_max"])
                      for c in cells]))
    return out


if __name__ == "__main__":
    main()
