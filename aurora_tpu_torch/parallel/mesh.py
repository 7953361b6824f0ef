"""The ``('data', 'lat', 'lon')`` mesh of ranks (port of ``aurora_tpu/parallel/mesh.py``).

* ``data``: the batch axis; each rank holds its slice of the batch, and the train steps
  average their gradients over it.
* ``lat`` / ``lon``: the 2D split of the pixel and token grids; each rank holds its block
  (:mod:`~aurora_tpu_torch.parallel.sharding`), and the backbone moves thin halos between
  blocks (:mod:`~aurora_tpu_torch.parallel.halo`). The forward, the roll-outs and the train
  steps run under it; a train step sums its gradients over the ``(lat, lon)`` plane.

A :class:`Mesh` is the ranks of the process group arranged in that shape, with one process
group for each line of ranks along an axis of size above 1, for each ``(lat, lon)`` plane
and for the whole mesh (made when the mesh is built, by every rank alike). The ``lat`` and
``lon`` lines are rings, as ``jnp.roll`` wraps on every axis: :meth:`Mesh.neighbours` gives
a rank's previous and next rank on each.
Entering a mesh (``with mesh:``, the counterpart of ``with jax.set_mesh(mesh)``) makes it
the mesh that the model and the train steps run under. A single process gets a 1 x 1 x 1
mesh that needs no process group.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch.distributed as dist

from aurora_tpu_torch.parallel.distributed import rank_device

__all__ = ["MESH_AXES", "Mesh", "SPATIAL", "auto_mesh", "current_mesh", "make_mesh"]

MESH_AXES = ("data", "lat", "lon")
SPATIAL = ("lat", "lon")  # the grid's axes: a rank's (lat, lon) plane is its group

_ENTERED: list["Mesh"] = []


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


class Mesh:
    """Ranks in a ``(data, lat, lon)`` array. ``shape``: ``{axis: size}``; ``rank``: this
    process's rank; ``coords``: its ``{axis: index}`` (None for a rank outside the mesh);
    ``device``: the device this rank computes on; :meth:`group`: the process group of this
    rank's line along an axis (None for an axis of size 1); :meth:`neighbours`: its ring
    neighbours on that line."""

    def __init__(self, ranks: np.ndarray, device: Optional[str] = None):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.shape = dict(zip(MESH_AXES, (int(s) for s in self.ranks.shape)))
        self.size = int(self.ranks.size)
        self.rank = dist.get_rank() if _initialized() else 0
        at = np.argwhere(self.ranks == self.rank)
        self.coords = dict(zip(MESH_AXES, (int(i) for i in at[0]))) if len(at) else None
        self.device = rank_device(device)
        self._groups: dict = {}
        if _initialized() and self.size > 1:
            # Every rank makes every group, in the same order (``new_group`` is collective):
            # the lines of each axis, then the (lat, lon) planes and the whole mesh where
            # they are not one of those.
            made: dict = {}
            for axes in (("data",), ("lat",), ("lon",), SPATIAL, MESH_AXES):
                split = tuple(a for a in axes if self.shape[a] > 1)
                if not split:
                    continue
                if split in made:
                    self._groups[axes] = made[split]
                    continue
                idx = [MESH_AXES.index(a) for a in split]
                rest = [i for i in range(3) if i not in idx]
                n = int(np.prod([self.ranks.shape[i] for i in idx]))
                lines = np.transpose(self.ranks, rest + idx).reshape(-1, n)
                mine = None
                for line in lines:
                    g = dist.new_group([int(r) for r in line])
                    if self.rank in line:
                        mine = g
                made[split] = self._groups[axes] = mine
            for axis in MESH_AXES:
                if (axis,) in self._groups:
                    self._groups[axis] = self._groups.pop((axis,))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.ranks.ravel().tolist()}, device={self.device})"

    def group(self, axis):
        """The process group of this rank's line along ``axis`` (a name), or of its plane
        over several axes (:data:`SPATIAL`, :data:`MESH_AXES`: the whole mesh); None where
        no axis of them is above 1."""
        return self._groups.get(axis)

    def axis_index(self, axis: str) -> int:
        if self.coords is None:
            raise RuntimeError(f"rank {self.rank} is not in {self}")
        return self.coords[axis]

    @property
    def spatial(self) -> bool:
        """True when the mesh splits the grid (``lat`` or ``lon`` above 1)."""
        return self.shape["lat"] > 1 or self.shape["lon"] > 1

    def line(self, axis: str) -> list[int]:
        """The ranks of this rank's line along ``axis``, in axis order."""
        a = MESH_AXES.index(axis)
        at = [self.axis_index(x) for x in MESH_AXES]
        at[a] = slice(None)
        return [int(r) for r in self.ranks[tuple(at)]]

    def neighbours(self, axis: str) -> tuple[int, int]:
        """The (previous, next) ranks of this rank on its ring along ``axis`` (itself on an
        axis of size 1)."""
        line, i = self.line(axis), self.axis_index(axis)
        return line[(i - 1) % len(line)], line[(i + 1) % len(line)]

    def __enter__(self) -> "Mesh":
        if self.size > 1 and (not _initialized() or self.coords is None):
            raise RuntimeError(f"{self} needs torch.distributed initialised with this rank in "
                               "it (aurora_tpu_torch.parallel.initialize)")
        _ENTERED.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ENTERED.remove(self)


def current_mesh() -> Optional[Mesh]:
    """The mesh entered last and not left, or None."""
    return _ENTERED[-1] if _ENTERED else None


def _all_ranks() -> list[int]:
    return list(range(dist.get_world_size() if _initialized() else 1))


def make_mesh(data: int = 1, lat: int = 1, lon: int = 1, devices: Optional[Sequence] = None,
              device: Optional[str] = None) -> Mesh:
    """A ``('data', 'lat', 'lon')`` mesh over the given ranks (``devices``; by default every
    rank of the process group, or the one process). ``device``: "cpu" to compute on the CPU
    (the card by default)."""
    devices = list(devices if devices is not None else _all_ranks())
    n = data * lat * lon
    if len(devices) < n:
        raise ValueError(f"Need {n} devices, have {len(devices)}.")
    return Mesh(np.array(devices[:n]).reshape(data, lat, lon), device=device)


def auto_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None,
              grid: Optional[tuple[int, int]] = None, window: tuple[int, int, int] = (2, 6, 12),
              batch: int = 1, device: Optional[str] = None) -> Mesh:
    """Factorise ``n_devices`` into a (data, lat, lon) shape, as the JAX package does.

    Without ``grid``: ``lon`` largest, then ``lat``, then ``data`` (the power of two of
    ``n`` split between lon and lat, lon first; the rest on data). With ``grid=(Hp, Wp)``
    (the token grid): the factorisation with the least over-padding of the three U-Net
    stages to window x mesh multiples (weights 1, 0.75, 0.5), ties to the larger ``data``,
    then the larger ``lon``; ``data`` divides ``batch``."""
    devices = list(devices if devices is not None else _all_ranks())
    n = n_devices or len(devices)

    def factorizations(n):
        out = []
        for d in range(1, n + 1):
            if n % d or batch % d:
                continue
            m = n // d
            for la in range(1, m + 1):
                if m % la == 0:
                    out.append((d, la, m // la))
        return out

    def pad_overhead(la, lo):
        Hp, Wp = grid
        total = 0.0
        for weight in (1.0, 0.75, 0.5):
            Hpad = Hp + (-Hp) % window[1]
            Wpad = Wp + (-Wp) % window[2]
            Hover = Hpad + (-Hpad) % (window[1] * la)
            Wover = Wpad + (-Wpad) % (window[2] * lo)
            total += weight * ((Hover * Wover) / (Hpad * Wpad) - 1.0)
            Hp, Wp = (Hp + Hp % 2) // 2, (Wp + Wp % 2) // 2
        return total

    if grid is not None:
        best = min(factorizations(n),
                   key=lambda f: (round(pad_overhead(f[1], f[2]), 9), -f[0], -f[2]))
        return make_mesh(*best, devices=devices[:n], device=device)

    p2 = 1
    rest = n
    while rest % 2 == 0:
        rest //= 2
        p2 *= 2
    lon = lat = 1
    toggle = True
    while p2 > 1:
        if toggle:
            lon *= 2
        else:
            lat *= 2
        p2 //= 2
        toggle = not toggle
    return make_mesh(data=rest, lat=lat, lon=lon, devices=devices[:n], device=device)
