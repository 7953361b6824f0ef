"""Shifted-window communication groups with longitude wrap-around (port of
``aurora_tpu/ops/masks.py``).

Host-side numpy, cached per geometry. Instead of an additive ``(nW, N, N)`` bias the
attention takes the per-token group id ``(nW, N)``: two tokens attend to each other
unmasked iff their ids are equal, and with a bias of -100 otherwise. The window-attention
kernel forms that bias from the ids in its body, so the bias is never materialised.
"""

from __future__ import annotations

import itertools
from functools import lru_cache

import numpy as np
import torch

__all__ = [
    "two_sided_padding",
    "three_sided_padding",
    "get_3d_merge_groups",
    "window_group_ids",
    "group_ids_tensor",
    "bias_from_groups",
]


def two_sided_padding(h_padding: int, w_padding: int) -> tuple[int, int, int, int]:
    """Centred padding: (left, right, top, bottom). Odd remainders go right/bottom."""
    assert h_padding >= 0 and w_padding >= 0
    top = h_padding // 2
    left = w_padding // 2
    return left, w_padding - left, top, h_padding - top


def three_sided_padding(c_padding: int, h_padding: int, w_padding: int):
    """Centred padding: (left, right, top, bottom, front, back)."""
    assert c_padding >= 0
    front = c_padding // 2
    return (*two_sided_padding(h_padding, w_padding), front, c_padding - front)


def get_3d_merge_groups() -> list[tuple[int, int]]:
    """Group pairs merged for global longitude connectivity: in each of the 3 level slices
    the (middle-row, right-column) pairs join so attention wraps around the globe."""
    merge_2d = [(1, 2), (4, 5), (7, 8)]
    return [(g1 + 9 * c, g2 + 9 * c) for c in range(3) for g1, g2 in merge_2d]


@lru_cache(maxsize=128)
def window_group_ids(
    C: int,
    H: int,
    W: int,
    ws: tuple[int, int, int],
    ss: tuple[int, int, int],
    warped: bool = True,
    extra: tuple[int, int, int] = (0, 0, 0),
) -> np.ndarray:
    """Group id of every token in every window, ``(nW, N)`` int32.

    The ``(C, H, W)`` grid is assumed rolled by ``-ss`` and then centre-padded to window
    multiples; pad tokens get a fresh id of their own. Windows are numbered in
    (C-blocks, H-blocks, W-blocks) order and tokens in (wc, wh, ww) order.

    ``extra`` appends that many pad planes, rows and columns after the centre pad, each a
    multiple of the window's extent along its axis: whole pad-only windows, with the pad's
    id. They change no real token's window, so a real token's attention is the same as
    without them. A mesh over-pads so, to window x mesh multiples
    (``aurora_tpu/ops/masks.py:54-110``).
    """
    img = np.zeros((C, H, W), dtype=np.int32)
    c_slices = (slice(0, -ws[0]), slice(-ws[0], -ss[0]), slice(-ss[0], None))
    h_slices = (slice(0, -ws[1]), slice(-ws[1], -ss[1]), slice(-ss[1], None))
    w_slices = (slice(0, -ws[2]), slice(-ws[2], -ss[2]), slice(-ss[2], None))
    cnt = 0
    for c, h, w in itertools.product(c_slices, h_slices, w_slices):
        img[c, h, w] = cnt
        cnt += 1
    if warped:
        for grp1, grp2 in get_3d_merge_groups():
            img[img == grp1] = grp2
    pad = ((-C) % ws[0], (-H) % ws[1], (-W) % ws[2])
    left, right, top, bottom, front, back = three_sided_padding(*pad)
    img = np.pad(img, ((front, back), (top, bottom), (left, right)), constant_values=cnt)
    if any(extra):
        if any(e % w for e, w in zip(extra, ws)):
            raise ValueError(f"extra {tuple(extra)} is not whole windows of {tuple(ws)}")
        img = np.pad(img, ((0, extra[0]), (0, extra[1]), (0, extra[2])), constant_values=cnt)
    Cp, Hp, Wp = img.shape
    img = img.reshape(Cp // ws[0], ws[0], Hp // ws[1], ws[1], Wp // ws[2], ws[2])
    img = img.transpose(0, 2, 4, 1, 3, 5)  # (C1, H1, W1, wc, wh, ww)
    ids = np.ascontiguousarray(img.reshape(-1, ws[0] * ws[1] * ws[2]))
    ids.flags.writeable = False  # shared by every caller of this geometry
    return ids


_device_ids: dict = {}
_by_identity: dict = {}


def group_ids_tensor(groups: np.ndarray, device) -> torch.Tensor:
    """The ``(nW, N)`` int32 ids as a tensor on ``device``, cached per geometry.

    A read-only array (as :func:`window_group_ids` returns) is found again by identity, so
    a launch does not hash a megabyte of ids on the host; any other array by its bytes.
    """
    frozen = not groups.flags.writeable
    if frozen:
        hit = _by_identity.get((id(groups), str(device)))
        if hit is not None and hit[0] is groups:
            return hit[1]
    key = (groups.tobytes(), groups.shape, str(device))
    if key not in _device_ids:
        _device_ids[key] = torch.as_tensor(np.array(groups), dtype=torch.int32).to(device)
    if frozen:
        _by_identity[id(groups), str(device)] = (groups, _device_ids[key])
    return _device_ids[key]


def bias_from_groups(groups: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The additive ``(nW, N, N)`` bias: 0 where the ids match, -100 otherwise."""
    same = groups[:, :, None] == groups[:, None, :]
    return torch.where(same, 0.0, -100.0).to(dtype)
