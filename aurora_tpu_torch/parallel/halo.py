"""The moves between the ranks' blocks of the token grid under a ``(lat, lon)`` mesh: the
explicit counterpart of what GSPMD lowers ``jnp.roll`` and the backbone's pads, crops and
patch-merge slices to (``aurora_tpu/model/swin3d.py:1132-1175``, ``:1411-1421``).

Between the backbone's blocks each rank holds its block of the token grid ``(B, C, H, W,
D)``: rows and columns by :func:`~aurora_tpu_torch.parallel.sharding.split_bounds` (the
"canonical" layout). A Swin block's windows need another layout: the grid rolled by half
a window, centre-padded and over-padded to window x mesh multiples, split into equal blocks
of whole windows. Every move between two such layouts is :func:`fetch` along one axis:
each rank names, for each row of the block it is to hold, the row of the old layout it
comes from (or a zero pad row); the rows that other ranks hold travel as one all-gather
over the axis's line (gloo and NCCL take CUDA tensors in it), and only those rows. A roll
by at most half a window moves thin strips: at the 0.25 degree grid's first stage over
``lat = lon = 2``, 3 rows or 6 columns of a 90 x 180 block.

* :func:`enter_windows` / :func:`leave_windows`: a block's roll by ``-shift`` and its pad
  (centre pad and ``extra``) in, and its crop and the roll back out; the level axis, never
  split, rolls by K1 (:func:`~aurora_tpu_torch.ops.roll.roll3d`) on the rank's block.
* :func:`merge_rows`: the 2 x 2 patch merge's cells whole on one rank when a block's
  extent is odd (45 token rows a rank at the second stage, in the example).
* :func:`split_crop`: the crop after the patch split.

:data:`STATS` counts what moved: the collectives, the bytes each rank sent, and what each
geometry of block saw (:func:`report`); ``STATS["by_kind"]`` every collective of the
parallel layer by kind, the gathers and gradient reductions of
:mod:`~aurora_tpu_torch.parallel.sharding` too.

Every move is differentiable: :func:`fetch`'s backward is its transpose, one all-gather
over the same line that sends each row's gradient back to the rank that holds the row
(the train steps under a ``(lat, lon)`` mesh run through it).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from aurora_tpu_torch.ops.masks import three_sided_padding, window_group_ids
from aurora_tpu_torch.parallel.mesh import Mesh
from aurora_tpu_torch.parallel.sharding import split_bounds

__all__ = ["STATS", "Move", "Windows", "count", "enter_windows", "enter_plans", "fetch",
           "leave_windows", "local_extents", "local_group_ids", "make_move", "merge_rows",
           "note", "plan", "reset_stats", "report", "split_crop", "window_geometry"]

AXES = {2: "lat", 3: "lon"}  # the token grid's split dimensions


def _new_stats() -> dict:
    return dict(collectives=0, bytes_sent=0, largest_sent=0, seen={}, by_kind={})


STATS: dict = _new_stats()


def reset_stats() -> None:
    """Set :data:`STATS` to zero."""
    STATS.clear()
    STATS.update(_new_stats())


def count(kind: str, nbytes: int, halo_move: bool = False) -> None:
    """Count one collective of ``kind`` into which this rank put ``nbytes`` bytes in
    ``STATS["by_kind"]``; a halo move (:func:`fetch` and its transpose) also in the
    counters of the moves (``collectives``, ``bytes_sent``, ``largest_sent``)."""
    entry = STATS["by_kind"].setdefault(kind, dict(count=0, bytes=0))
    entry["count"] += 1
    entry["bytes"] += int(nbytes)
    if halo_move:
        STATS["collectives"] += 1
        STATS["bytes_sent"] += int(nbytes)
        STATS["largest_sent"] = max(STATS["largest_sent"], int(nbytes))


def note(kind: str, **facts) -> None:
    """Count that ``kind`` was seen with ``facts`` (ints or tuples of ints) in
    ``STATS["seen"]``."""
    key = (kind, tuple(sorted((k, tuple(v) if isinstance(v, (list, tuple)) else v)
                              for k, v in facts.items())))
    STATS["seen"][key] = STATS["seen"].get(key, 0) + 1


def report() -> dict:
    """:data:`STATS` as plain data: the counters of the halo moves (collectives, the bytes
    this rank sent, the most in one collective; a line of ``k`` ranks receives ``k - 1``
    times what each sends), every collective by kind (``by_kind``: ``{kind: {"count",
    "bytes"}}``, the bytes this rank put in; :func:`fetch` ``fetch:<what>``, its transpose
    in the backward ``fetch_T:<what>``, the others named where they are made) and each
    geometry seen with its count (``seen``: a list of ``{"kind", ..., "count"}``)."""
    out = {k: v for k, v in STATS.items() if k not in ("seen", "by_kind")}
    out["by_kind"] = {k: dict(v) for k, v in STATS["by_kind"].items()}
    out["seen"] = [dict(kind=k, **{a: list(v) if isinstance(v, tuple) else v for a, v in f},
                        count=n) for (k, f), n in STATS["seen"].items()]
    return out


# ------------------------------------------------------------------------------ fetch


def _runs(src: np.ndarray) -> list[tuple[int, int, int]]:
    """``(start, length, first source)`` of the runs of consecutive sources in ``src``."""
    runs = []
    p = 0
    while p < len(src):
        q = p + 1
        while q < len(src) and src[q] == src[q - 1] + 1 and (src[p] >= 0) == (src[q] >= 0):
            q += 1
        if src[p] < 0:  # a run of pad rows
            while q < len(src) and src[q] < 0:
                q += 1
        runs.append((p, q - p, int(src[p])))
        p = q
    return runs


def plan(cur: list[tuple[int, int]], want: Callable[[int], np.ndarray]):
    """The moves of :func:`fetch` over a line of ``len(cur)`` ranks: ``(wants, sends)``,
    ``wants[r]`` the rows rank ``r`` is to hold, ``sends[s][r]`` the rows rank ``s`` sends
    to rank ``r`` (ascending; none to itself)."""
    k = len(cur)
    wants = [np.asarray(want(r), dtype=np.int64) for r in range(k)]
    sends = [[np.unique(wants[r][(wants[r] >= a) & (wants[r] < b)]) if r != s
              else np.empty(0, np.int64) for r in range(k)] for s, (a, b) in enumerate(cur)]
    return wants, sends


@dataclasses.dataclass(frozen=True)
class Move:
    """One rank's part of a :func:`fetch` over a line of ``k`` ranks, worked out from the
    :func:`plan` that every rank of the line computes alike.

    Forward: the rank puts ``send`` (its local rows, in the order the receivers read them)
    into a buffer of ``longest`` rows, all-gathered over the line (none when ``longest`` is
    0: then no rank enters), and assembles its new block from ``runs``: ``(start, length,
    source rank or -1 for zero rows, first row)``, the row an index into that source's
    local block (the rank itself) or its buffer (another rank).

    Backward (the transpose): each rank sums the gradient rows of what it received into one
    buffer of ``back_longest`` rows (the other ranks' rows in rank order, ``back_runs``:
    ``(start, length, position)``), all-gathered over the line when the forward moved
    anything; the gradient of its rows it kept is added in place (``keep_runs``:
    ``(start, length, local row)``), that of the rows it sent from every other rank's buffer
    (``owed``: ``(rank, position in its buffer, local row, length)``). Zero rows get
    nothing. A row wanted twice, or by several ranks, gets the sum."""

    k: int
    me: int
    rows: int  # the rank's rows before
    out_rows: int  # and after
    send: tuple[int, ...]
    longest: int
    runs: tuple[tuple[int, int, int, int], ...]
    identity: bool
    back_longest: int
    back_runs: tuple[tuple[int, int, int], ...]
    keep_runs: tuple[tuple[int, int, int], ...]
    owed: tuple[tuple[int, int, int, int], ...]


def make_move(cur: list[tuple[int, int]], want: Callable[[int], np.ndarray], me: int,
              what: str = "fetch") -> Move:
    """The :class:`Move` of rank ``me`` of the line (``cur`` and ``want`` as in
    :func:`fetch`)."""
    k = len(cur)
    wants, sends = plan(cur, want)
    lens = [sum(len(p) for p in row) for row in sends]
    a_me, b_me = cur[me]
    mine = wants[me]
    send = np.concatenate(sends[me]) - a_me if lens[me] else np.empty(0, np.int64)
    # Where each wanted row lies: this rank's block, or rank s's section for this rank.
    owner = np.full(len(mine), -1, np.int64)
    offset = np.full(len(mine), -1, np.int64)
    # The transpose's buffer: the rows this rank received, from each sender in rank order.
    received = [sum(len(sends[s][r]) for s in range(k)) for r in range(k)]
    back_base = np.cumsum([0] + [len(sends[s][me]) for s in range(k)])
    back_pos = np.full(len(mine), -1, np.int64)
    for s, (a, b) in enumerate(cur):
        inside = (mine >= a) & (mine < b)
        owner[inside] = s
        if s == me:
            offset[inside] = mine[inside] - a
        elif inside.any():
            base = sum(len(p) for p in sends[s][:me])
            idx = np.searchsorted(sends[s][me], mine[inside])
            offset[inside] = base + idx
            back_pos[inside] = back_base[s] + idx
    if ((mine >= 0) & (owner < 0)).any():
        raise ValueError(f"{what}: rows {mine[(mine >= 0) & (owner < 0)][:4]} lie on no rank")
    key = np.where(mine < 0, -1, owner * (1 << 40) + offset)
    runs = []
    for p, n, first in _runs(key):
        if first < 0:
            runs.append((p, n, -1, 0))
        else:
            s, off = divmod(first, 1 << 40)
            runs.append((p, n, int(s), int(off)))
    kept = np.where(owner == me, offset, -1)
    keep_runs = tuple((p, n, first) for p, n, first in _runs(kept) if first >= 0)
    back_runs = tuple((p, n, first) for p, n, first in _runs(back_pos) if first >= 0)
    owed = []
    for r in range(k):
        if r == me or not len(sends[me][r]):
            continue
        pos = sum(len(sends[s][r]) for s in range(me))
        for p, n, first in _runs(sends[me][r] - a_me):
            owed.append((r, pos + p, first, n))
    identity = len(mine) == b_me - a_me and np.array_equal(mine, np.arange(a_me, b_me))
    return Move(k, me, b_me - a_me, len(mine), tuple(int(v) for v in send), max(lens),
                tuple(runs), bool(identity), max(received), back_runs, keep_runs,
                tuple(owed))


def _all_gather(buf: torch.Tensor, k: int, mesh: Mesh, axis: str) -> torch.Tensor:
    """``buf`` of every rank of ``axis``'s line, stacked ``(k, *buf.shape)``."""
    out = buf.new_empty(k * buf.numel())
    dist.all_gather_into_tensor(out, buf.reshape(-1), group=mesh.group(axis))
    return out.view(k, *buf.shape)


def _move_forward(x: torch.Tensor, dim: int, mv: Move, mesh: Mesh, axis: Optional[str],
                  what: str) -> torch.Tensor:
    recv = None
    if mv.longest:
        shape = list(x.shape)
        shape[dim] = mv.longest
        buf = x.new_zeros(shape)
        if mv.send:
            buf.narrow(dim, 0, len(mv.send)).copy_(
                x.index_select(dim, torch.as_tensor(mv.send, device=x.device)))
        recv = _all_gather(buf, mv.k, mesh, axis)
        count(f"fetch:{what}", buf.numel() * buf.element_size(), halo_move=True)
    if mv.identity:
        return x  # this rank's rows stay as they are
    shape = list(x.shape)
    shape[dim] = mv.out_rows
    out = x.new_empty(shape)
    for p, n, s, off in mv.runs:
        dst = out.narrow(dim, p, n)
        if s < 0:
            dst.zero_()
        else:
            dst.copy_((x if s == mv.me else recv[s]).narrow(dim, off, n))
    return out


def _move_backward(g: torch.Tensor, dim: int, mv: Move, mesh: Mesh, axis: Optional[str],
                   what: str) -> torch.Tensor:
    shape = list(g.shape)
    shape[dim] = mv.rows
    if mv.identity:
        gx = g.clone()
    else:
        gx = g.new_zeros(shape)
        for p, n, row in mv.keep_runs:
            gx.narrow(dim, row, n).add_(g.narrow(dim, p, n))
    if mv.longest:  # the forward moved rows: every rank of the line enters
        shape[dim] = mv.back_longest
        buf = g.new_zeros(shape)
        for p, n, pos in mv.back_runs:
            buf.narrow(dim, pos, n).add_(g.narrow(dim, p, n))
        back = _all_gather(buf, mv.k, mesh, axis)
        count(f"fetch_T:{what}", buf.numel() * buf.element_size(), halo_move=True)
        for r, pos, row, n in mv.owed:
            gx.narrow(dim, row, n).add_(back[r].narrow(dim, pos, n))
    return gx


class _Fetch(torch.autograd.Function):
    """:func:`fetch` with its transpose as the backward (one all-gather a way)."""

    @staticmethod
    def forward(ctx, x, dim, mv, mesh, axis, what):
        ctx.args = (dim, mv, mesh, axis, what)
        return _move_forward(x, dim, mv, mesh, axis, what)

    @staticmethod
    def backward(ctx, g):
        return (_move_backward(g.contiguous(), *ctx.args), None, None, None, None, None)


def fetch(x: torch.Tensor, dim: int, mesh: Mesh, axis: Optional[str],
          cur: list[tuple[int, int]], want: Callable[[int], np.ndarray],
          what: str = "fetch") -> torch.Tensor:
    """``x`` in another layout along ``dim``, the rows moved over ``axis``'s line.

    ``cur[r]``: the ``[start, end)`` of the rows (global indices along ``dim``) that rank
    ``r`` of the line holds now (``x`` is this rank's); ``want(r)``: the global row of the
    old layout that each row of rank ``r``'s new block comes from, -1 for a zero row. Every
    rank of the line computes every rank's plan alike, so all of them enter the one
    all-gather, or none does when no row changes rank. Each rank sends the rows that other
    ranks want of it, once each, padded to the longest such set over the line.

    Differentiable: the backward is the transpose (:class:`Move`), which sends the gradient
    of each row back to the rank that holds it, summed where the row went to several places;
    every rank of the line enters its all-gather exactly when the forward's ran. Autograd
    runs the backwards of one graph in one order on every rank, and a rematerialised region
    replays its forward fetches in the backward on every rank alike."""
    me = 0 if axis is None else mesh.axis_index(axis)
    mv = make_move(cur, want, me, what)
    if torch.is_grad_enabled() and x.requires_grad and (mv.longest or not mv.identity):
        return _Fetch.apply(x, dim, mv, mesh, axis, what)
    return _move_forward(x, dim, mv, mesh, axis, what)


# ------------------------------------------------------------------------------ geometry


def local_extents(shape: tuple[int, int], mesh: Mesh) -> tuple[tuple[int, int], ...]:
    """``([start, end) of the rows, [start, end) of the columns)`` of this rank's block of a
    ``(H, W)`` grid."""
    return tuple(split_bounds(n, mesh.shape[a])[mesh.axis_index(a)]
                 for n, a in zip(shape, ("lat", "lon")))


@dataclasses.dataclass(frozen=True)
class Windows:
    """A Swin block's window geometry under a mesh: the grid ``res`` ``(C, H, W)``, windows
    ``ws``, shift ``ss``, centre pad ``pad`` and over-pad ``extra`` (to window x mesh
    multiples, ``aurora_tpu/model/swin3d.py:1146-1175``), the padded grid ``padded`` and
    the rank's block of it."""

    res: tuple[int, int, int]
    ws: tuple[int, int, int]
    ss: tuple[int, int, int]
    pad: tuple[int, int, int]
    extra: tuple[int, int, int]
    padded: tuple[int, int, int]
    mesh_shape: tuple[int, int]  # (lat, lon)
    at: tuple[int, int]  # this rank's (lat, lon) index

    @property
    def block(self) -> tuple[int, int]:
        """The rows and columns of the rank's block of the padded grid."""
        return self.padded[1] // self.mesh_shape[0], self.padded[2] // self.mesh_shape[1]


def window_geometry(res, ws, ss, mesh: Mesh) -> Windows:
    """The :class:`Windows` of a block over ``res`` on ``mesh``."""
    C, H, W = res
    la, lo = mesh.shape["lat"], mesh.shape["lon"]
    pad = ((-C) % ws[0], (-H) % ws[1], (-W) % ws[2])
    extra = (0, (-(H + pad[1])) % (ws[1] * la), (-(W + pad[2])) % (ws[2] * lo))
    padded = tuple(n + p + e for n, p, e in zip(res, pad, extra))
    return Windows(tuple(res), tuple(ws), tuple(ss), pad, extra, padded, (la, lo),
                   (mesh.axis_index("lat"), mesh.axis_index("lon")))


@lru_cache(maxsize=64)
def local_group_ids(geo: Windows) -> np.ndarray:
    """This rank's rows of the shifted block's ``(nW, N)`` group ids: the global ids of the
    over-padded grid as ``(C1, H1, W1, N)``, cut to the rank's window rows and columns (as
    ``aurora_tpu/model/swin3d.py:1013-1018`` cuts the bias), flattened. Read-only, so that
    the kernel's wrapper finds its device copy by identity."""
    C, H, W = geo.res
    ids = window_group_ids(C, H, W, geo.ws, geo.ss, True, geo.extra)
    C1, H1, W1 = (p // w for p, w in zip(geo.padded, geo.ws))
    h1, w1 = H1 // geo.mesh_shape[0], W1 // geo.mesh_shape[1]
    i, j = geo.at
    ids = ids.reshape(C1, H1, W1, -1)[:, i * h1:(i + 1) * h1, j * w1:(j + 1) * w1]
    out = np.ascontiguousarray(ids.reshape(-1, ids.shape[-1]))
    out.flags.writeable = False
    return out


def _roll_levels(x: torch.Tensor, shift: int) -> torch.Tensor:
    """``x`` rolled along the level axis (never split) on this rank's block: K1."""
    from aurora_tpu_torch.ops.roll import roll3d

    return roll3d(x.contiguous(), (shift, 0, 0)) if shift else x


def _enter_axes(geo: Windows, mesh_shape: dict):
    """Per split dimension of :func:`enter_windows`: ``(dim, axis, cur, want)``."""
    C, H, W = geo.res
    left, _, top, _, _, _ = three_sided_padding(*geo.pad)
    out = []
    for dim, n, shift, lo_pad, m in ((2, H, geo.ss[1], top, geo.block[0]),
                                     (3, W, geo.ss[2], left, geo.block[1])):
        axis = AXES[dim]

        def want(r, n=n, shift=shift, lo_pad=lo_pad, m=m):
            real = np.arange(r * m, (r + 1) * m) - lo_pad
            return np.where((real >= 0) & (real < n), (real + shift) % n, -1)

        out.append((dim, axis, split_bounds(n, mesh_shape[axis]), want))
    return out


def enter_plans(geo: Windows, mesh_shape: dict) -> dict:
    """The :func:`plan` of each split axis of :func:`enter_windows` (``{axis: (wants,
    sends)}``), without moving anything."""
    return {axis: plan(cur, want) for _, axis, cur, want in _enter_axes(geo, mesh_shape)}


def enter_windows(x: torch.Tensor, geo: Windows, mesh: Mesh) -> torch.Tensor:
    """The rank's block ``x`` of the grid (canonical layout) -> its block of the grid rolled
    by ``-ss``, centre-padded by ``pad`` and over-padded by ``extra``: whole windows,
    ``geo.block`` rows and columns. One fetch an axis, which moves the roll's halo strip and
    the rows that cross a block's edge at the pad."""
    _, _, _, _, front, back = three_sided_padding(*geo.pad)
    x = _roll_levels(x, -geo.ss[0])
    if geo.pad[0]:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 0, front, back))
    for dim, axis, cur, want in _enter_axes(geo, mesh.shape):
        x = fetch(x, dim, mesh, axis, cur, want, what="enter")
    return x


def _leave_axes(geo: Windows, mesh_shape: dict):
    """Per split dimension of :func:`leave_windows`: ``(dim, axis, cur, want)``."""
    left, _, top, _, _, _ = three_sided_padding(*geo.pad)
    out = []
    for dim, n, shift, lo_pad, m in ((2, geo.res[1], geo.ss[1], top, geo.block[0]),
                                     (3, geo.res[2], geo.ss[2], left, geo.block[1])):
        axis = AXES[dim]
        k = mesh_shape[axis]
        bounds = split_bounds(n, k)

        def want(r, n=n, shift=shift, lo_pad=lo_pad, bounds=bounds):
            j = np.arange(*bounds[r])
            return (j - shift) % n + lo_pad

        out.append((dim, axis, [(r * m, (r + 1) * m) for r in range(k)], want))
    return out


def leave_windows(xp: torch.Tensor, geo: Windows, mesh: Mesh) -> torch.Tensor:
    """Inverse of :func:`enter_windows`: the padded block -> the rank's block of the grid
    cropped and rolled back by ``+ss`` (canonical layout)."""
    C = geo.res[0]
    _, _, _, _, front, _ = three_sided_padding(*geo.pad)
    for dim, axis, cur, want in _leave_axes(geo, mesh.shape):
        xp = fetch(xp, dim, mesh, axis, cur, want, what="leave")
    if geo.pad[0]:
        xp = xp[:, front:front + C]
    return _roll_levels(xp, geo.ss[0]).contiguous()


def _merge_axes(res: tuple[int, int, int], mesh_shape: dict):
    """Per split dimension of :func:`merge_rows`: ``(dim, axis, cur, want)``."""
    out = []
    for dim, n in ((2, res[1]), (3, res[2])):
        axis = AXES[dim]
        k = mesh_shape[axis]
        pad = n % 2
        merged = split_bounds((n + pad) // 2, k)

        def want(r, n=n, lo_pad=pad // 2, merged=merged):
            real = np.arange(2 * merged[r][0], 2 * merged[r][1]) - lo_pad
            return np.where((real >= 0) & (real < n), real, -1)

        out.append((dim, axis, split_bounds(n, k), want))
    return out


def merge_rows(x: torch.Tensor, res: tuple[int, int, int], mesh: Mesh) -> torch.Tensor:
    """The rank's block of the patch merge's input, centre-padded by ``(H % 2, W % 2)``,
    as the 2 x 2 cells of its block of the merged grid need it: rows ``[2a, 2b)`` and
    columns likewise, where ``[a, b)`` is its block of the merged extent. A cell that an
    odd block's edge cuts comes whole to one rank."""
    for dim, axis, cur, want in _merge_axes(res, mesh.shape):
        x = fetch(x, dim, mesh, axis, cur, want, what="merge")
    return x


def _split_axes(res: tuple[int, int, int], crop: tuple[int, int, int], mesh_shape: dict):
    """Per split dimension of :func:`split_crop`: ``(dim, axis, cur, want)``."""
    left, _, top, _, _, _ = three_sided_padding(*crop)
    out = []
    for dim, n, c, lo in ((2, res[1], crop[1], top), (3, res[2], crop[2], left)):
        axis = AXES[dim]
        k = mesh_shape[axis]
        cropped = split_bounds(2 * n - c, k)

        def want(r, cropped=cropped, lo=lo):
            return np.arange(*cropped[r]) + lo

        out.append((dim, axis, [(2 * a, 2 * b) for a, b in split_bounds(n, k)], want))
    return out


def split_crop(x: torch.Tensor, res: tuple[int, int, int], crop: tuple[int, int, int],
               mesh: Mesh) -> torch.Tensor:
    """The patch split's output block (rows ``[2a, 2b)`` of the ``(2H, 2W)`` grid, where
    ``[a, b)`` is the rank's block of the input) cropped by ``crop`` (centre crop, as
    :func:`~aurora_tpu_torch.model.swin3d.crop_3d`) into the rank's block of the cropped
    grid."""
    for dim, axis, cur, want in _split_axes(res, crop, mesh.shape):
        x = fetch(x, dim, mesh, axis, cur, want, what="split")
    return x
