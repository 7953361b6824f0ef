"""Placement of batches and parameters over the mesh (port of
``aurora_tpu/parallel/sharding.py``).

The layout specs of the JAX package, as tuples of axis names (None: whole):

* surface fields ``(B, T, H, W)``: :data:`SURF_SPEC`; static fields ``(H, W)``:
  :data:`STATIC_SPEC`; atmospheric fields ``(B, T, C, H, W)``: :data:`ATMOS_SPEC`; the
  backbone's token grid ``(B, C, H, W, D)``: :data:`TOKENS_5D_SPEC`.
* Parameters: replicated, or under :func:`shard_params` (ZeRO over ``data``) each large
  tensor held as this rank's slice along the axis :func:`zero_partition_spec` picks.

A rank holds its slice of the batch over ``data`` and its block of the grid over ``lat``
and ``lon`` (:func:`shard_tensor` cuts a tensor by its spec, :func:`gather_tensor` joins
the blocks). **The rule for uneven extents** (GSPMD splits them implicitly; here it is
written out): an extent ``n`` over ``k`` ranks is cut into blocks of ``ceil(n / k)``, the
last ones shorter or empty (:func:`split_bounds`; 45 token rows over 2: 23 and 22). Every
tensor of the batch, the predictions and the token grid between the backbone's blocks is
held so. :func:`constrain` is the identity: a rank's block already has its layout.

A model under :func:`shard_params` gathers its split parameters once before a forward
(:func:`gathered_params`: ``Aurora.forward_core``, :func:`~aurora_tpu_torch.rollout.rollout`
and the train steps enter it), and a train step reduces its gradients with
:func:`average_gradients`: summed over the ``(lat, lon)`` plane, where each rank's gradient
is its block's share, and averaged over ``data``.

The moves between layouts carry gradients: :func:`gather_tensor`'s backward reduce-scatters
each rank's gradient of the whole tensor (summed over the line, the rank keeping its block),
and :func:`shard_tensor`'s (a slice) fills the rest with zeros.

Every collective moves flat buckets of at most :data:`BUCKET_BYTES`, not one tensor at a
time; gloo takes CUDA tensors in each of them, so ranks that share one card run over gloo.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from aurora_tpu_torch.parallel.mesh import MESH_AXES, SPATIAL, Mesh, current_mesh

__all__ = [
    "ATMOS_SPEC",
    "BUCKET_BYTES",
    "STATIC_SPEC",
    "SURF_SPEC",
    "TOKENS_5D_SPEC",
    "average_gradients",
    "constrain",
    "data_mesh",
    "gather_batch",
    "gather_tensor",
    "gathered_params",
    "global_grid",
    "global_mean",
    "replicate",
    "shard_batch",
    "shard_batch_arrays",
    "shard_leading",
    "shard_params",
    "shard_tensor",
    "spatial_mesh",
    "split_bounds",
    "train_mesh",
    "zero_partition_spec",
]

SURF_SPEC = ("data", None, "lat", "lon")
STATIC_SPEC = ("lat", "lon")
ATMOS_SPEC = ("data", None, None, "lat", "lon")
TOKENS_5D_SPEC = ("data", None, "lat", "lon", None)

BUCKET_BYTES = 256 << 20  # the largest flat buffer one collective moves


def constrain(x, spec):
    """The identity: every rank already holds its block of ``x`` in the layout of ``spec``
    (its slice over ``data``, its block over ``lat`` and ``lon``)."""
    return x


def split_bounds(n: int, k: int) -> list[tuple[int, int]]:
    """The port's rule for an extent ``n`` over ``k`` ranks: ``[start, end)`` of each rank's
    block, blocks of ``ceil(n / k)`` in rank order, the last ones shorter (or empty)."""
    b = -(-n // k)
    return [(min(i * b, n), min((i + 1) * b, n)) for i in range(k)]


def spatial_mesh() -> Optional[Mesh]:
    """The entered mesh when it splits the grid (``lat`` or ``lon`` above 1), else None."""
    mesh = current_mesh()
    return mesh if mesh is not None and mesh.spatial else None


def global_grid(h: int, w: int, mesh: Mesh) -> tuple[int, int]:
    """The whole grid ``(H, W)`` of which this rank holds an ``h x w`` block: the blocks'
    extents gathered over the ``lat`` and ``lon`` lines (raises where they do not follow
    :func:`split_bounds`, as a batch cut by :func:`shard_batch_arrays` does)."""
    out = []
    for n, axis in ((h, "lat"), (w, "lon")):
        k = mesh.shape[axis]
        if k == 1:
            out.append(n)
            continue
        every = torch.empty(k, dtype=torch.int64, device=mesh.device)
        dist.all_gather_into_tensor(every, torch.tensor([n], dtype=torch.int64,
                                                        device=mesh.device),
                                    group=mesh.group(axis))
        _count("grid", 8)
        sizes = every.tolist()
        total = sum(sizes)
        if sizes != [b - a for a, b in split_bounds(total, k)]:
            raise ValueError(f"blocks of {sizes} along {axis} are not the split of {total} "
                             "(shard_batch_arrays cuts a batch so)")
        out.append(total)
    return tuple(out)


def zero_partition_spec(shape, data_size: int, min_size: int = 2**16) -> tuple:
    """The ZeRO placement rule for a tensor of ``shape`` (the JAX package's): split the
    largest axis that the ``data`` degree divides when the tensor has ``min_size`` elements
    or more, else replicate. Returns the spec as a tuple (``("data", None)``: split on axis
    0; ``()``: replicated)."""
    shape = tuple(int(s) for s in shape)
    if len(shape) >= 1 and int(np.prod(shape)) >= min_size:
        order = np.argsort(shape)[::-1]
        for ax in order:
            if shape[ax] % data_size == 0:
                spec = [None] * len(shape)
                spec[ax] = "data"
                return tuple(spec)
    return ()


def _split_axis(spec: tuple) -> Optional[int]:
    return spec.index("data") if "data" in spec else None


# ------------------------------------------------------------------ collectives


def _buckets(items: list, nbytes) -> list[list]:
    """``items`` in order, cut into runs of at most BUCKET_BYTES (``nbytes(item)`` each; an
    item larger than that is a bucket of its own)."""
    out, run, size = [], [], 0
    for it in items:
        n = nbytes(it)
        if run and size + n > BUCKET_BYTES:
            out.append(run)
            run, size = [], 0
        run.append(it)
        size += n
    if run:
        out.append(run)
    return out


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _count(kind: str, nbytes: int) -> None:
    """Count a collective in :data:`~aurora_tpu_torch.parallel.halo.STATS` (``by_kind``)."""
    from aurora_tpu_torch.parallel import halo

    halo.count(kind, nbytes)


def train_mesh(model: Optional[torch.nn.Module] = None) -> Optional[Mesh]:
    """The mesh a train step reduces its gradients and its loss over: the one ``model``'s
    parameters were placed on (:func:`shard_params`), else the entered one; None when
    neither splits anything (``data``, ``lat`` and ``lon`` all 1)."""
    placement = getattr(model, "_zero_placement", None)
    mesh = placement.mesh if placement is not None else current_mesh()
    if mesh is None or mesh.size == 1:
        return None
    return mesh


def data_mesh(model: Optional[torch.nn.Module] = None) -> Optional[Mesh]:
    """The mesh a call runs its data axis over: the one ``model``'s parameters were placed
    on (:func:`shard_params`), else the entered one; None when either is absent or its
    ``data`` degree is 1."""
    placement = getattr(model, "_zero_placement", None)
    mesh = placement.mesh if placement is not None else current_mesh()
    if mesh is None or mesh.shape["data"] == 1:
        return None
    return mesh


def shard_leading(x, mesh: Optional[Mesh], local: int):
    """``x`` cut to this rank's slice of its leading (batch) axis when it holds the whole
    batch (``data`` x ``local`` rows); as it is when it already holds ``local`` rows."""
    if mesh is None or x is None or x.shape[0] == local:
        return x
    d = mesh.shape["data"]
    if x.shape[0] != local * d:
        raise ValueError(f"leading axis {x.shape[0]}: neither this rank's batch ({local}) nor "
                         f"the whole one ({local} x {d})")
    return x.narrow(0, mesh.axis_index("data") * local, local)


def global_mean(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A per-rank scalar summed over each ``(lat, lon)`` plane (a rank's loss is its block's
    share) and averaged over ``data``; ``x`` itself without a mesh."""
    if mesh is None or mesh.size == 1:
        return x
    t = x.detach().to(_acc(x.dtype)).reshape(1).clone()
    dist.all_reduce(t, group=mesh.group(MESH_AXES))
    _count("loss", t.numel() * t.element_size())
    return (t / mesh.shape["data"]).reshape(x.shape).to(x.dtype)


# ------------------------------------------------------------------ batches


def shard_tensor(x, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec`` (one axis name or None per
    dimension): the batch axis cut into equal slices over ``data``, ``lat`` and ``lon`` by
    :func:`split_bounds`; on the mesh's device, contiguous."""
    x = torch.as_tensor(x)
    if len(spec) != x.dim():
        raise ValueError(f"spec {spec} for a tensor of shape {tuple(x.shape)}")
    for dim, axis in enumerate(spec):
        if axis is None or mesh.shape[axis] == 1:
            continue
        k, i = mesh.shape[axis], mesh.axis_index(axis)
        n = x.shape[dim]
        if axis == "data":
            if n % k:
                raise ValueError(f"batch {n} is not a multiple of data = {k}")
            a, b = i * (n // k), (i + 1) * (n // k)
        else:
            a, b = split_bounds(n, k)[i]
        x = x.narrow(dim, a, b - a)
    return x.to(mesh.device).contiguous()


def _gather_sizes(n: int, mesh: Mesh, axis: str, device) -> list[int]:
    """The extent ``n`` of every rank's block along ``axis``'s line, in rank order."""
    k = mesh.shape[axis]
    every = torch.empty(k, dtype=torch.int64, device=device)
    dist.all_gather_into_tensor(every, torch.tensor([n], dtype=torch.int64, device=device),
                                group=mesh.group(axis))
    _count("gather:sizes", 8)
    return every.tolist()


def _gather_forward(x: torch.Tensor, dim: int, mesh: Mesh, axis: str, sizes: list[int]):
    k, m = mesh.shape[axis], max(sizes)
    if x.shape[dim] < m:
        pad = list(x.shape)
        pad[dim] = m - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    whole = x.new_empty(k * x.numel())
    dist.all_gather_into_tensor(whole, x.reshape(-1), group=mesh.group(axis))
    _count("gather", x.numel() * x.element_size())
    parts = whole.view(k, *x.shape).unbind(0)
    return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, sizes)], dim=dim)


class _GatherLine(torch.autograd.Function):
    """The all-gather of the blocks along a line; its backward is the reduce-scatter: each
    rank's gradient of the whole tensor summed over the line, the rank keeping its block."""

    @staticmethod
    def forward(ctx, x, dim, mesh, axis, sizes):
        ctx.args = (dim, mesh, axis, sizes)
        return _gather_forward(x, dim, mesh, axis, sizes)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axis, sizes = ctx.args
        k, m, i = mesh.shape[axis], max(sizes), mesh.axis_index(axis)
        parts = []
        for p in g.split(sizes, dim=dim):
            if p.shape[dim] < m:
                pad = list(p.shape)
                pad[dim] = m - p.shape[dim]
                p = torch.cat([p, p.new_zeros(pad)], dim=dim)
            parts.append(p)
        rows = torch.stack(parts).contiguous()
        out = g.new_empty(rows[0].numel())
        dist.reduce_scatter_tensor(out, rows.reshape(-1), group=mesh.group(axis))
        _count("gather_T", rows.numel() * rows.element_size())
        return out.view(rows.shape[1:]).narrow(dim, 0, sizes[i]), None, None, None, None


def _gather_line(x: torch.Tensor, dim: int, mesh: Mesh, axis: str) -> torch.Tensor:
    """The blocks of ``x`` along ``dim`` over this rank's ``axis`` line, joined in rank
    order (the data axis: equal slices; lat / lon: :func:`split_bounds` blocks, padded to
    the longest for the all-gather and cut back). Differentiable (:class:`_GatherLine`)."""
    if mesh.shape[axis] == 1:
        return x
    x = x.contiguous()
    sizes = _gather_sizes(x.shape[dim], mesh, axis, x.device)
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherLine.apply(x, dim, mesh, axis, sizes)
    return _gather_forward(x, dim, mesh, axis, sizes)


def gather_tensor(x: torch.Tensor, spec: tuple, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The whole tensor of which each rank holds its block ``x`` under ``spec``: the blocks
    all-gathered over each split axis of the mesh (default: the entered one) and joined in
    rank order. ``x`` itself without such a mesh."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return x
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = _gather_line(x, dim, mesh, axis)
    return x


def _batch_spec(x, lead: bool) -> tuple:
    """A batch tensor's spec: the leading axis over ``data`` (``lead``), the last two over
    ``lat`` and ``lon``, the rest whole."""
    n = x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)
    if n < 2 or (lead and n < 3):
        raise ValueError(f"a batch tensor of {n} dimensions has no (lat, lon) grid")
    return (("data",) if lead else ()) + (None,) * (n - 2 - lead) + ("lat", "lon")


def shard_batch_arrays(surf: dict, static: dict, atmos: dict, mesh: Mesh):
    """This rank's part of the batch dicts, on its device: the surface (:data:`SURF_SPEC`)
    and atmospheric (:data:`ATMOS_SPEC`) fields cut to its slice of the batch axis and its
    (lat, lon) block of the grid, the static fields (:data:`STATIC_SPEC`) to its block. A
    grid split over (lat, lon) must be cropped to the patch size first (``Batch.crop``)."""
    return ({k: shard_tensor(v, SURF_SPEC, mesh) for k, v in surf.items()},
            {k: shard_tensor(v, STATIC_SPEC, mesh) for k, v in static.items()},
            {k: shard_tensor(v, ATMOS_SPEC, mesh) for k, v in atmos.items()})


def shard_batch(batch, mesh: Mesh):
    """This rank's part of a :class:`~aurora_tpu_torch.batch.Batch`
    (:func:`shard_batch_arrays`); its metadata (the whole grid's ``lat`` / ``lon``) as it
    is. Crop the batch to the patch size before (``batch.crop(patch_size)``)."""
    surf, static, atmos = shard_batch_arrays(batch.surf_vars, batch.static_vars,
                                             batch.atmos_vars, mesh)
    return dataclasses.replace(batch, surf_vars=surf, static_vars=static, atmos_vars=atmos)


def gather_batch(tensors, mesh: Optional[Mesh] = None):
    """The whole batch of what each rank holds a part of: a dict of tensors, one tensor, or
    a :class:`~aurora_tpu_torch.batch.Batch` (its variables, static ones too). Each tensor's
    leading axis is all-gathered over ``data`` and its last two axes over ``lat`` and
    ``lon``, joined in rank order (:func:`gather_tensor`); a Batch's static fields over
    ``lat`` and ``lon`` only. Without a mesh, the input itself."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.size == 1:
        return tensors
    if isinstance(tensors, torch.Tensor):
        return gather_tensor(tensors, _batch_spec(tensors, True), mesh)
    if isinstance(tensors, dict):
        return {k: gather_tensor(v, _batch_spec(v, True), mesh) for k, v in tensors.items()}
    return dataclasses.replace(
        tensors, surf_vars=gather_batch(tensors.surf_vars, mesh),
        atmos_vars=gather_batch(tensors.atmos_vars, mesh),
        static_vars={k: gather_tensor(torch.as_tensor(v).to(mesh.device), _batch_spec(v, False),
                                      mesh)
                     for k, v in tensors.static_vars.items()})


def replicate(tree, mesh: Mesh):
    """Broadcast from the mesh's first rank over ``data``: a module's parameters and
    buffers in place (returns the module), or a tensor, dict, list or tuple of tensors
    (returns the broadcast copies)."""
    if mesh.shape["data"] == 1:
        return tree
    g, src = mesh.group("data"), int(mesh.ranks.ravel()[0])

    def bcast(t: torch.Tensor) -> torch.Tensor:
        t = t.detach().to(mesh.device).contiguous().clone()
        dist.broadcast(t, src=src, group=g)
        return t

    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for t in (*tree.parameters(), *tree.buffers()):
                t.copy_(bcast(t))
        return tree
    if isinstance(tree, torch.Tensor):
        return bcast(tree)
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    return tree


# ------------------------------------------------------------------ ZeRO


class ZeroPlacement:
    """The ZeRO placement of a model's parameters: ``split`` {name: (axis, full shape)} of
    the parameters held as this rank's slice; ``gathered``: the slices kept while the whole
    tensors stand in for them; ``pending``: the averaged gradient slices waiting for the
    slices to come back."""

    def __init__(self, mesh: Mesh, split: dict):
        self.mesh, self.split = mesh, split
        self.gathered: Optional[dict] = None
        self.pending: dict = {}


def shard_params(model: torch.nn.Module, mesh: Mesh, min_size: int = 2**16) -> torch.nn.Module:
    """ZeRO placement over ``data``: each parameter :func:`zero_partition_spec` splits is
    held as this rank's slice along that axis (its optimiser moments then exist for the
    slice only); the rest stay whole. Every rank must hold the same values before (seeded
    alike, loaded, or :func:`replicate`). Call it before binding the optimiser. Returns the
    model."""
    d = mesh.shape["data"]
    if d == 1:
        return model
    i = mesh.axis_index("data")
    split = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            ax = _split_axis(zero_partition_spec(p.shape, d, min_size))
            if ax is None:
                continue
            split[name] = (ax, tuple(p.shape))
            p.data = p.data.chunk(d, dim=ax)[i].contiguous()
    model._zero_placement = ZeroPlacement(mesh, split)
    return model


@contextlib.contextmanager
def gathered_params(model: torch.nn.Module):
    """Inside, every ZeRO-split parameter of ``model`` holds its whole tensor, all-gathered
    over ``data`` (one flat collective a bucket); on exit each holds its slice again and
    takes the averaged gradient slice :func:`average_gradients` left. Nested entries and a
    model without a placement pass through."""
    zp = getattr(model, "_zero_placement", None)
    if zp is None or zp.gathered is not None:
        yield model
        return
    params = dict(model.named_parameters())
    mesh, g = zp.mesh, zp.mesh.group("data")
    d = mesh.shape["data"]
    names = list(zp.split)
    zp.gathered = {n: params[n].data for n in names}
    try:
        with torch.no_grad():
            by_dtype: dict = {}
            for n in names:
                by_dtype.setdefault(params[n].dtype, []).append(n)
            for dtype, group in by_dtype.items():
                for bucket in _buckets(group, lambda n: params[n].numel() * d
                                       * params[n].element_size()):
                    flat = torch.cat([params[n].data.reshape(-1) for n in bucket])
                    whole = torch.empty(d * flat.numel(), dtype=dtype, device=flat.device)
                    dist.all_gather_into_tensor(whole, flat, group=g)
                    _count("zero:all_gather", flat.numel() * flat.element_size())
                    whole = whole.view(d, -1)
                    off = 0
                    for n in bucket:
                        part = zp.gathered[n]
                        k = part.numel()
                        pieces = [whole[r, off:off + k].view(part.shape) for r in range(d)]
                        params[n].data = torch.cat(pieces, dim=zp.split[n][0])
                        off += k
        yield model
    finally:
        for n in names:  # a whole gradient left unaveraged has no slice to go to
            params[n].grad = None
            params[n].data = zp.gathered[n]
        for n, gr in zp.pending.items():
            params[n].grad = gr
        zp.gathered, zp.pending = None, {}


def average_gradients(model: torch.nn.Module, mesh: Optional[Mesh] = None) -> None:
    """Reduce the gradients of ``model``'s parameters in float32 (float64 for float64
    gradients): summed over each ``(lat, lon)`` plane (a rank's gradient is its block's
    share of the loss's) and averaged over ``data``. The whole ones are all-reduced over the
    mesh; the ZeRO-split ones (whole inside :func:`gathered_params`) are summed over the
    plane, then reduce-scattered over ``data`` to this rank's slice, which the parameter
    takes when the gathered context ends. One flat collective a bucket (two for the split
    ones under a plane of more than one rank). A no-op without a mesh that splits anything
    (:func:`train_mesh`)."""
    mesh = mesh or train_mesh(model)
    if mesh is None or mesh.size == 1:
        return
    zp = getattr(model, "_zero_placement", None)
    split = zp.split if zp is not None and zp.gathered is not None else {}
    everyone, plane = mesh.group(MESH_AXES), mesh.group(SPATIAL)
    g, d = mesh.group("data"), mesh.shape["data"]
    i = mesh.axis_index("data")
    whole, parts = [], []
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        (parts if name in split else whole).append((name, p))
    with torch.no_grad():
        for bucket in _buckets(whole, lambda it: it[1].numel() * 4):
            acc = _acc(bucket[0][1].grad.dtype)
            flat = torch.cat([p.grad.reshape(-1).to(acc) for _, p in bucket])
            dist.all_reduce(flat, group=everyone)
            _count("grad:all_reduce", flat.numel() * flat.element_size())
            if d > 1:
                flat /= d
            off = 0
            for _, p in bucket:
                p.grad.copy_(flat[off:off + p.numel()].view(p.shape))
                off += p.numel()
        for bucket in _buckets(parts, lambda it: it[1].numel() * 4):
            acc = _acc(bucket[0][1].grad.dtype)
            rows = torch.cat([
                torch.stack([c.reshape(-1) for c in p.grad.to(acc).chunk(d, dim=split[n][0])])
                for n, p in bucket], dim=1)  # (d, sum of slice sizes): row r is rank r's
            if plane is not None:
                dist.all_reduce(rows, group=plane)
                _count("grad:plane_sum", rows.numel() * rows.element_size())
            out = torch.empty(rows.shape[1], dtype=acc, device=rows.device)
            dist.reduce_scatter_tensor(out, rows.reshape(-1), group=g)
            _count("grad:reduce_scatter", rows.numel() * rows.element_size())
            out /= d
            off = 0
            for n, p in bucket:
                shape = p.grad.chunk(d, dim=split[n][0])[i].shape
                k = int(np.prod(shape))
                zp.pending[n] = out[off:off + k].view(shape).to(p.grad.dtype)
                p.grad = None
                off += k
