"""NN primitives of ``aurora_tpu/model/nn.py`` as ``nn.Module``s and functions on tensors.

Conventions kept from the JAX package so the two compare like with like:

* Linear weights are ``(in, out)`` (the JAX layout; torch's own ``nn.Linear`` is
  ``(out, in)``), bias ``(out,)``.
* LayerNorm eps is 1e-5. In bf16 it is the shifted-variance form of ``nn.py:67-94``,
  not textbook LN: f32 statistics taken around a bf16 mean estimate.
* GELU is the exact erf form.
* ``AdaptiveLayerNorm`` is FiLM: ``LN(x) * (scale_bias + scale(c)) + shift(c)`` with a
  zero-initialised modulation linear.

The training-only stochastic knobs (:func:`dropout`, :func:`drop_path`) draw every Bernoulli
mask through one function, :func:`keep_mask`, from an integer seed folded along the draw's
place in the model (:class:`DrawKey`), the counterpart of the JAX package's PRNG key tree.
A mask is a function of ``(seed, path, shape, keep)`` alone, so a rematerialised region that
runs again in the backward draws the masks it drew in the forward:
``torch.utils.checkpoint`` restores the global RNG states on a replay, but not a
``torch.Generator`` that a region would draw from.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

__all__ = [
    "DrawKey",
    "acc_dtype",
    "checkpointed",
    "draw_key",
    "drop_path",
    "dropout",
    "fold_seed",
    "keep_mask",
    "full_f32_products",
    "matmul_acc",
    "linear",
    "layernorm",
    "gelu",
    "Linear",
    "LayerNorm",
    "MLP",
    "AdaptiveLayerNorm",
    "sdpa",
    "split_heads",
    "merge_heads",
    "trunc_normal_",
    "uniform_",
]


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulation type of a plain version: f64 stays f64, everything else is f32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def matmul_acc(a: torch.Tensor, b: torch.Tensor, fast: bool = False) -> torch.Tensor:
    """``a @ b`` accumulated in f32 (f64 for f64 operands of one dtype) and returned in the
    accumulation type: the JAX package's ``dot_general(..., preferred_element_type=f32)``.

    ``fast=False`` (the kernels' plain versions) widens both operands first, so a bf16 product
    runs as an f32 one. ``fast=True`` (the forms the backward differentiates,
    :mod:`aurora_tpu_torch.ops.ad`) multiplies in the operands' dtype, which on the card is a
    bf16 product accumulating in f32, rounded once to bf16 before it is widened. In float64
    the two are one computation."""
    acc = acc_dtype(a.dtype)
    if fast:
        return (a @ b).to(acc)
    return a.to(acc) @ b.to(acc)


@contextlib.contextmanager
def full_f32_products():
    """Full-f32 products and convolutions on the card (TF32 off) for the model's own calls,
    the caller's settings restored on exit. The encoder, the decoder and the perceiver's q
    and k run in f32 as the JAX reference does; PyTorch would run f32 convolutions in TF32
    by default, and a caller may have switched TF32 on for its products. ``Encoder.forward``,
    ``Decoder.forward`` and ``Aurora.forward_core`` run inside it; the train steps hold it
    over their backward too."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def checkpointed(on: bool, fn, *args):
    """``fn(*args)``; with ``on``, rematerialised: its activations are not kept for the
    backward, which runs ``fn`` again (``jax.checkpoint``'s counterpart, non-reentrant
    ``torch.utils.checkpoint``). A region inside another one runs once more for each region
    around it: the backward of the outer one replays it, then its own backward."""
    if not on:
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


_U64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    """One step of splitmix64 on a 64-bit integer."""
    z = (z + 0x9E3779B97F4A7C15) & _U64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
    return z ^ (z >> 31)


def fold_seed(seed: int, path: tuple[int, ...]) -> int:
    """The 64-bit seed of a draw: ``seed`` folded with each index of ``path`` in turn by
    splitmix64 (``jax.random.fold_in``'s counterpart)."""
    z = seed & _U64
    for i in path:
        z = _splitmix64(z ^ _splitmix64(int(i) & _U64))
    return z


@dataclasses.dataclass(frozen=True)
class DrawKey:
    """A place in the tree of draws: the step's ``seed`` and the ``path`` of indices that
    leads from the step to one draw. The path mirrors the JAX package's keys: the roll-out
    step (``aurora_tpu/training/train.py:190``), the backbone stage (encoder ``i``, decoder
    ``100 + i``, ``aurora_tpu/model/swin3d.py:1743,1756``), the block (``:1596``), then one
    of a block's five draws (``:1126``)."""

    seed: int
    path: tuple[int, ...] = ()

    def fold(self, i: int) -> "DrawKey":
        return DrawKey(self.seed, self.path + (int(i),))


def draw_key(generator: torch.Generator) -> DrawKey:
    """One 64-bit seed drawn from ``generator``: the root of a step's draws. Called outside
    every rematerialised region, once a step."""
    seed = torch.randint(0, 2**63 - 1, (), generator=generator, device=generator.device)
    return DrawKey(int(seed.item()))


def keep_mask(shape: tuple[int, ...], keep: float, seed: int, path: tuple[int, ...],
              device) -> torch.Tensor:
    """The boolean mask of one Bernoulli(``keep``) draw of ``shape`` on ``device``: uniform
    numbers from a generator seeded with :func:`fold_seed` of ``(seed, path)``, below
    ``keep``. Every stochastic draw of the port goes through this function."""
    gen = torch.Generator(device=device).manual_seed(fold_seed(seed, path))
    return torch.rand(shape, generator=gen, device=device) < keep


def _keep_scalar(keep: float, x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(keep, dtype=x.dtype, device=x.device)


def dropout(x: torch.Tensor, rate: float, key: Optional[DrawKey]) -> torch.Tensor:
    """Inverted dropout (``aurora_tpu/model/nn.py:142-149``): each element kept with
    probability ``1 - rate`` and divided by it, in ``x.dtype``. The identity without a key or
    at rate 0."""
    if key is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = keep_mask(tuple(x.shape), keep, key.seed, key.path, x.device)
    return torch.where(mask, x / _keep_scalar(keep, x), torch.zeros((), dtype=x.dtype,
                                                                       device=x.device))


def drop_path(x: torch.Tensor, rate: float, key: Optional[DrawKey]) -> torch.Tensor:
    """Stochastic depth (``aurora_tpu/model/nn.py:152-167``): the whole branch of a batch
    element dropped with probability ``rate`` (one flag per element), the survivors divided
    by ``1 - rate`` in ``x.dtype``. The identity without a key or at rate 0."""
    if key is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = keep_mask((x.shape[0],) + (1,) * (x.ndim - 1), keep, key.seed, key.path, x.device)
    return x * mask.to(x.dtype) / _keep_scalar(keep, x)


def trunc_normal_(t: torch.Tensor, gen: torch.Generator, std: float = 0.02) -> torch.Tensor:
    """Truncated normal (±2σ), the reference default for linear weights."""
    with torch.no_grad():
        return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=gen)


def uniform_(t: torch.Tensor, gen: torch.Generator, fan_in: int) -> torch.Tensor:
    """Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)): the torch conv / LoRA-A default."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=gen)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None):
    y = x @ weight.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def layernorm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm over the last axis (non-affine when ``weight`` is None)."""
    if x.dtype == torch.bfloat16:
        mean = x.float().mean(-1, keepdim=True)
        shift = mean.to(x.dtype)
        meansq = (x - shift).square().float().mean(-1, keepdim=True)
        resid = mean - shift.float()
        var = torch.clamp(meansq - resid.square(), min=0.0)
        y = ((x.float() - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    else:
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.to(x.dtype) + bias.to(x.dtype)
    return y


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scaled dot-product attention over ``(..., heads, seq, head_dim)`` tensors, as
    ``aurora_tpu/model/nn.py:170-189``: the logits are computed in the input dtype (bf16
    under autocast) and only then widened to f32 for the bias and softmax; the weights are
    rounded to the input dtype. The window-attention kernels keep the logits f32 from the
    start, so this is not their plain version."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("...hqd,...hkd->...hqk", q, k)
    compute = torch.float32 if logits.dtype == torch.bfloat16 else logits.dtype
    logits = logits.to(compute) * scale
    if bias is not None:
        logits = logits + bias.to(compute)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("...hqk,...hkd->...hqd", weights, v)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``(..., seq, H*Dh) -> (..., H, seq, Dh)``."""
    *lead, s, d = x.shape
    return x.reshape(*lead, s, num_heads, d // num_heads).transpose(-2, -3)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``(..., H, seq, Dh) -> (..., seq, H*Dh)``."""
    x = x.transpose(-2, -3)
    *lead, s, h, dh = x.shape
    return x.reshape(*lead, s, h * dh)


class Linear(nn.Module):
    """``x @ weight + bias`` with an ``(in, out)`` weight."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, *, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(d_in, d_out, device=device, dtype=dtype))
        self.bias = (
            nn.Parameter(torch.zeros(d_out, device=device, dtype=dtype)) if bias else None
        )

    def reset_parameters(self, gen: torch.Generator) -> None:
        trunc_normal_(self.weight, gen)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, d: int, *, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(d, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        return layernorm(x, self.weight, self.bias, eps)


class MLP(nn.Module):
    """Two-layer GELU MLP (``fc1``/``fc2``)."""

    def __init__(self, d_in: int, d_hidden: int, *, device=None, dtype=None):
        super().__init__()
        self.fc1 = Linear(d_in, d_hidden, device=device, dtype=dtype)
        self.fc2 = Linear(d_hidden, d_in, device=device, dtype=dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.fc1.reset_parameters(gen)
        self.fc2.reset_parameters(gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class AdaptiveLayerNorm(nn.Module):
    """FiLM adaptive LayerNorm (reference: aurora/model/film.py:14-49)."""

    def __init__(self, dim: int, context_dim: int, *, device=None, dtype=None):
        super().__init__()
        # Zero-initialised: the block starts as LN * scale_bias.
        self.modulation = Linear(context_dim, 2 * dim, device=device, dtype=dtype)

    def shift_scale(self, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The per-batch ``(B, D)`` shift and scale for context ``c: (B, Dc)``."""
        shift, scale = self.modulation(F.silu(c)).chunk(2, dim=-1)
        return shift, scale

    def forward(self, x: torch.Tensor, c: torch.Tensor, scale_bias: float = 0.0):
        shift, scale = self.shift_scale(c)
        shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
        return layernorm(x) * (scale_bias + scale.reshape(shape)) + shift.reshape(shape)
