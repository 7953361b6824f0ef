"""Seeded random weights for a model, made on the device from ``--seed`` in a few large
draws, under the measured port's parameter names.

The same seed and the same ``(name, shape)`` list give the same values: the benchmark fills
the port's parameters with them, frees the port, and draws them again for the reference.
Names are taken in sorted order, so the values do not depend on the order in which a
model registers its modules.

Scales, by the parameter's role (the released model's own initialisation, with the FiLM
modulations and the LoRA ``B`` banks opened, which are zero at initialisation and would make
every Swin block an identity): linear weights and biases ``N(0, 0.02^2)``; LayerNorm
weights ``1 + N(0, 0.02^2)``; FiLM modulation weights ``N(0, 0.1^2)``; LoRA ``A`` ``N(0,
1/in)`` and ``B`` ``N(0, 0.02^2)``; patch-embedding kernels ``N(0, 1 / (3 T P P))`` (the
variance of the released uniform initialisation).
"""

from __future__ import annotations

import math
from typing import Iterable

import torch

CHUNK = 1 << 28  # elements drawn in one call at most (1 GiB of float32)


def scale_of(name: str, shape: tuple[int, ...]) -> tuple[float, float]:
    """``(mean, std)`` of the parameter ``name``."""
    last = name.rsplit(".", 1)[-1]
    if last == "A":
        return 0.0, 1.0 / math.sqrt(shape[-1])
    if last == "B":
        return 0.0, 0.02
    if ".weights." in name:  # a patch embedding's (T, P, P, D) kernel
        return 0.0, 1.0 / math.sqrt(3 * shape[0] * shape[1] * shape[2])
    if "modulation" in name and last == "weight":
        return 0.0, 0.1
    norm = any(p.startswith(("norm", "ln")) or p.endswith("norm")
               for p in name.split(".")[:-1])
    if norm and last == "weight" and len(shape) == 1:
        return 1.0, 0.02
    return 0.0, 0.02


def fill(params: Iterable[tuple[str, torch.Tensor]], seed: int, device) -> None:
    """Write the seed's values into ``params`` (``(name, tensor)`` pairs on ``device``) in
    place, in float32 rounded once to each tensor's dtype."""
    items = sorted(params, key=lambda kv: kv[0])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(t.numel() for _, t in items)
    buf, start = None, 0  # the current draw and the flat offset of its first element
    offset = 0
    with torch.no_grad():
        for name, t in items:
            n = t.numel()
            parts, done = [], 0
            while done < n:
                at = offset + done
                if buf is None or at >= start + buf.numel():
                    start = at
                    buf = torch.randn(min(CHUNK, total - at), generator=gen, device=device)
                take = min(n - done, start + buf.numel() - at)
                parts.append(buf[at - start:at - start + take])
                done += take
            flat = parts[0] if len(parts) == 1 else torch.cat(parts)
            mean, std = scale_of(name, tuple(t.shape))
            t.copy_((flat * std + mean).view(t.shape))
            offset += n
    del buf


def make(shapes: dict[str, tuple[int, ...]], seed: int, device) -> dict[str, torch.Tensor]:
    """The seed's weights as a dict of float32 tensors of ``shapes``."""
    out = {n: torch.empty(s, dtype=torch.float32, device=device) for n, s in shapes.items()}
    fill(out.items(), seed, device)
    return out
