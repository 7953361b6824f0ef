"""Per-roll-out-step LoRA (port of ``aurora_tpu/model/lora.py``).

The bank is stored stacked, ``A: (S, r, in)`` and ``B: (S, r, out)``, with ``S = 1`` for the
"single" and "from_second" modes and ``S = max_steps`` for "all". The kernels never run a
rank-r side path: :func:`lora_weight_delta` folds the adapter into the weight they read
(``aurora_tpu/model/swin3d.py:1243-1247``). Every projection that runs as a plain GEMM (the
``"xla"`` routes, and the proj outside a fused tail) adds the side path :func:`lora_apply`
instead, as the JAX package does (``swin3d.py:308-315``, ``:1291-1297``).
"""

from __future__ import annotations

import torch
from torch import nn

from aurora_tpu_torch.model.config import LoRAMode
from aurora_tpu_torch.model.nn import uniform_

__all__ = ["LoRA", "lora_apply", "lora_weight_delta"]


class LoRA(nn.Module):
    def __init__(
        self,
        d_in: int,
        d_out: int,
        r: int = 8,
        max_steps: int = 40,
        mode: LoRAMode = "single",
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        n = max_steps if mode == "all" else 1
        self.A = nn.Parameter(torch.zeros(n, r, d_in, device=device, dtype=dtype))
        self.B = nn.Parameter(torch.zeros(n, r, d_out, device=device, dtype=dtype))

    def reset_parameters(self, gen: torch.Generator) -> None:
        """A with the linear default init, B at zero (the adapter starts as identity)."""
        uniform_(self.A, gen, fan_in=self.A.shape[-1])
        with torch.no_grad():
            self.B.zero_()


def _select(A, B, step: int, mode: LoRAMode):
    if mode in ("single", "from_second"):
        return A[0], B[0]
    if mode == "all":
        idx = min(max(int(step), 0), A.shape[0] - 1)
        return A[idx], B[idx]
    raise ValueError(f"Invalid mode: {mode}")


def _active(step: int, max_steps: int, mode: LoRAMode) -> float:
    return float(step < max_steps and (mode != "from_second" or step > 0))


def lora_apply(
    A: torch.Tensor,
    B: torch.Tensor,
    x: torch.Tensor,
    step: int,
    *,
    r: int,
    alpha: int,
    max_steps: int,
    mode: LoRAMode,
) -> torch.Tensor:
    """The additive side path ``(x @ A^T) @ B * (alpha / r)`` for roll-out step ``step``
    (``aurora_tpu/model/lora.py:47-75``), computed in ``x``'s dtype: each product rounds
    to it, then the scaling, then the step gate."""
    a, b = _select(A, B, step, mode)
    out = (x @ a.T.to(x.dtype)) @ b.to(x.dtype)
    out = out * (alpha / r)
    return out * _active(step, max_steps, mode)


def lora_weight_delta(
    A: torch.Tensor,
    B: torch.Tensor,
    step: int,
    *,
    r: int,
    alpha: int,
    max_steps: int,
    mode: LoRAMode,
) -> torch.Tensor:
    """The LoRA correction as an effective-weight delta ``(d_in, d_out)`` for roll-out step
    ``step``, computed in the parameter dtype: ``x @ (W + delta)`` equals the linear plus
    the LoRA side path up to one re-association."""
    a, b = _select(A, B, step, mode)
    return (a.T @ b) * (alpha / r) * _active(step, max_steps, mode)
