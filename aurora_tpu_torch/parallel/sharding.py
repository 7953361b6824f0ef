"""Placement of batches and parameters over the mesh (port of
``aurora_tpu/parallel/sharding.py``).

The layout specs of the JAX package, as tuples of axis names (None: whole):

* surface fields ``(B, T, H, W)``: :data:`SURF_SPEC`; static fields ``(H, W)``:
  :data:`STATIC_SPEC`; atmospheric fields ``(B, T, C, H, W)``: :data:`ATMOS_SPEC`; the
  backbone's token grid ``(B, C, H, W, D)``: :data:`TOKENS_5D_SPEC`.
* Parameters: replicated, or under :func:`shard_params` (ZeRO over ``data``) each large
  tensor held as this rank's slice along the axis :func:`zero_partition_spec` picks.

Only the ``data`` axis runs (ROADMAP A4b has the rest): a rank holds its slice of the
batch, and :func:`constrain` is the identity. A model under :func:`shard_params` gathers its
split parameters once before a forward (:func:`gathered_params`: ``Aurora.forward_core``,
:func:`~aurora_tpu_torch.rollout.rollout` and the train steps enter it), and a train step
averages its gradients over ``data`` with :func:`average_gradients`.

Every collective moves flat buckets of at most :data:`BUCKET_BYTES`, not one tensor at a
time; gloo takes CUDA tensors in each of them, so ranks that share one card run over gloo.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from aurora_tpu_torch.parallel.mesh import Mesh, current_mesh

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
    "gathered_params",
    "global_mean",
    "replicate",
    "shard_batch_arrays",
    "shard_leading",
    "shard_params",
    "zero_partition_spec",
]

SURF_SPEC = ("data", None, "lat", "lon")
STATIC_SPEC = ("lat", "lon")
ATMOS_SPEC = ("data", None, None, "lat", "lon")
TOKENS_5D_SPEC = ("data", None, "lat", "lon", None)

BUCKET_BYTES = 256 << 20  # the largest flat buffer one collective moves


def constrain(x, spec):
    """The identity: under a data-only mesh every rank holds whole token grids of its batch
    slice, and no other mesh can be entered yet."""
    return x


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
    """The mean of a per-rank scalar over ``data`` (``x`` itself without a mesh)."""
    if mesh is None:
        return x
    t = x.detach().to(_acc(x.dtype)).reshape(1).clone()
    dist.all_reduce(t, group=mesh.group("data"))
    return (t / mesh.shape["data"]).reshape(x.shape).to(x.dtype)


# ------------------------------------------------------------------ batches


def shard_batch_arrays(surf: dict, static: dict, atmos: dict, mesh: Mesh):
    """This rank's part of the batch dicts, on its device: the surface and atmospheric
    fields cut to its slice of the batch axis, the static fields whole."""
    d, i = mesh.shape["data"], mesh.axis_index("data")

    def cut(v):
        v = torch.as_tensor(v)
        if v.shape[0] % d:
            raise ValueError(f"batch {v.shape[0]} is not a multiple of data = {d}")
        n = v.shape[0] // d
        return v.narrow(0, i * n, n).to(mesh.device).contiguous()

    return ({k: cut(v) for k, v in surf.items()},
            {k: torch.as_tensor(v).to(mesh.device) for k, v in static.items()},
            {k: cut(v) for k, v in atmos.items()})


def gather_batch(tensors, mesh: Optional[Mesh] = None):
    """The whole batch of a prediction that each rank holds a slice of: every tensor of a
    dict (or one tensor) all-gathered along its leading axis over ``data``, in rank order.
    Without a data mesh, the input itself."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.shape["data"] == 1:
        return tensors
    if isinstance(tensors, torch.Tensor):
        return gather_batch({"x": tensors}, mesh)["x"]
    g, d = mesh.group("data"), mesh.shape["data"]
    out = {}
    for k, v in tensors.items():
        v = v.contiguous()
        whole = torch.empty((d * v.shape[0], *v.shape[1:]), dtype=v.dtype, device=v.device)
        dist.all_gather_into_tensor(whole, v, group=g)
        out[k] = whole
    return out


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
    """Average the gradients of ``model``'s parameters over ``data`` in float32 (float64 for
    float64 gradients): the whole ones all-reduced, the ZeRO-split ones (whole inside
    :func:`gathered_params`) reduce-scattered to this rank's slice, which the parameter
    takes when the gathered context ends. One flat collective a bucket. A no-op without a
    data mesh."""
    mesh = mesh or data_mesh(model)
    if mesh is None:
        return
    zp = getattr(model, "_zero_placement", None)
    split = zp.split if zp is not None and zp.gathered is not None else {}
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
            dist.all_reduce(flat, group=g)
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
            out = torch.empty(rows.shape[1], dtype=acc, device=rows.device)
            dist.reduce_scatter_tensor(out, rows.reshape(-1), group=g)
            out /= d
            off = 0
            for n, p in bucket:
                shape = p.grad.chunk(d, dim=split[n][0])[i].shape
                k = int(np.prod(shape))
                zp.pending[n] = out[off:off + k].view(shape).to(p.grad.dtype)
                p.grad = None
                off += k
