"""Per-variable patch embedding (port of ``aurora_tpu/model/patchembed.py``).

Each variable has its own ``(T, P, P, D)`` kernel (the JAX layout). At apply time the
kernels of the variables present are stacked into one strided convolution over
``V * T`` input channels; only the first ``T`` history slots of each kernel are used.
The convolution is a library call: the JAX package leaves it to XLA too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from aurora_tpu_torch.model.nn import uniform_

__all__ = ["LevelPatchEmbed"]


class LevelPatchEmbed(nn.Module):
    def __init__(
        self,
        var_names: tuple[str, ...],
        patch_size: int,
        embed_dim: int,
        history_size: int = 1,
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        self.patch_size = patch_size
        shape = (history_size, patch_size, patch_size, embed_dim)
        self.weights = nn.ParameterDict(
            {n: nn.Parameter(torch.zeros(shape, device=device, dtype=dtype)) for n in var_names}
        )
        self.bias = nn.Parameter(torch.zeros(embed_dim, device=device, dtype=dtype))

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The torch conv default: uniform(+-1/sqrt(T * P * P))."""
        fan_in = next(iter(self.weights.values())).shape[:3].numel()  # T * P * P
        for w in self.weights.values():
            uniform_(w, gen, fan_in)
        uniform_(self.bias, gen, fan_in)

    def forward(self, x: torch.Tensor, var_names: tuple[str, ...]) -> torch.Tensor:
        """Embed ``x: (B, V, T, H, W)`` to tokens ``(B, H/P * W/P, D)``."""
        B, V, T, H, W = x.shape
        P = self.patch_size
        assert len(var_names) == V, f"{V} != {len(var_names)}."
        assert H % P == 0 and W % P == 0
        w = torch.stack([self.weights[n][:T] for n in var_names])  # (V, T, P, P, D)
        w = w.permute(4, 0, 1, 2, 3).reshape(-1, V * T, P, P).to(x.dtype)
        y = F.conv2d(x.reshape(B, V * T, H, W), w, stride=P)  # (B, D, H/P, W/P)
        # Token-major (B, L, D) in memory: the kernels downstream take contiguous tensors.
        return y.flatten(2).transpose(1, 2).contiguous() + self.bias.to(x.dtype)
