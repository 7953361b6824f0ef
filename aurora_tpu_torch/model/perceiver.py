"""Perceiver resampler of the level (de-)aggregation (port of
``aurora_tpu/model/perceiver.py``).

Both uses have queries that are identical for every token column (the learned latents of
the encoder, the pressure-level embeddings of the decoder), so layer 0's query projection
runs once on ``(Q, D)`` and the per-column work is the shared-query core (K4) followed by
the MLP half ``lat + LN(mlp(lat))``, which is the block-MLP call (K3) with the LayerNorm
affine in the FiLM slot. Under ``value_bf16`` (the production ``agg_bf16``/``deagg_bf16``
modes) the value path runs in bf16 and q/k/logits stay f32.

Deeper layers (``enc_depth`` / ``dec_depth`` > 1) have latents that differ from column to
column: each runs the generic per-column cross-attention (:func:`perceiver_layer_apply`,
plain products: K and Q are 3-13) on the M-major context, then its MLP half through K3. Under
``value_bf16`` they run in float32, as the JAX package's do (``perceiver.py:276-285``). The
generic resampler :func:`perceiver_resampler_apply` runs every layer that way.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from aurora_tpu_torch.model.nn import LayerNorm, Linear, MLP, merge_heads, sdpa, split_heads
from aurora_tpu_torch.ops.mlp import mlp_adaln_residual
from aurora_tpu_torch.ops.resampler import perceiver_core

__all__ = [
    "PerceiverResampler",
    "mlp_half",
    "perceiver_layer_apply",
    "perceiver_resampler_apply",
    "resampler_shared_query_apply",
    "shared_query_core_args",
]


class _Attention(nn.Module):
    """``ln_k_q`` adds the stabilising LayerNorms of ``stabilise_level_agg`` on the k and q
    projections, taken over the whole ``inner`` axis before the head split
    (``aurora_tpu/model/perceiver.py:31-42``)."""

    def __init__(self, latent_dim, context_dim, head_dim, num_heads, ln_k_q=False, *,
                 device=None, dtype=None):
        super().__init__()
        inner = head_dim * num_heads
        kw = dict(bias=False, device=device, dtype=dtype)
        self.to_q = Linear(latent_dim, inner, **kw)
        self.to_kv = Linear(context_dim, 2 * inner, **kw)
        self.to_out = Linear(inner, latent_dim, **kw)
        if ln_k_q:
            self.ln_k = LayerNorm(inner, device=device, dtype=dtype)
            self.ln_q = LayerNorm(inner, device=device, dtype=dtype)
        else:
            self.ln_k = self.ln_q = None


class _Layer(nn.Module):
    def __init__(self, latent_dim, context_dim, head_dim, num_heads, mlp_ratio, ln_k_q=False, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attn = _Attention(latent_dim, context_dim, head_dim, num_heads, ln_k_q, **kw)
        self.mlp = MLP(latent_dim, int(latent_dim * mlp_ratio), **kw)
        self.ln1 = LayerNorm(latent_dim, **kw)
        self.ln2 = LayerNorm(latent_dim, **kw)


class PerceiverResampler(nn.Module):
    def __init__(self, latent_dim, context_dim, depth=1, head_dim=64, num_heads=16,
                 mlp_ratio=4.0, ln_k_q=False, *, device=None, dtype=None):
        super().__init__()
        self.num_heads = num_heads
        # The stabilising LayerNorms sit on layer 0 only (perceiver.py:78-81).
        self.layers = nn.ModuleList(
            _Layer(latent_dim, context_dim, head_dim, num_heads, mlp_ratio,
                   ln_k_q=ln_k_q and i == 0, device=device, dtype=dtype)
            for i in range(depth)
        )

    def reset_parameters(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, Linear):
                m.reset_parameters(gen)


def shared_query_core_args(
    p: PerceiverResampler,
    queries: torch.Tensor,
    ctx: torch.Tensor,
    ln_eps: float = 1e-5,
    value_bf16: bool = False,
) -> tuple[tuple, dict]:
    """The positional and keyword arguments of layer 0's :func:`perceiver_core` call (K4):
    the query projection, once on ``queries: (Q, D)``, and the weights (with the biases of
    ``to_kv`` and ``to_out`` where they exist) as the layer holds them."""
    layer = p.layers[0]
    att = layer.attn
    h = p.num_heads
    Q = queries.shape[0]
    q0 = att.to_q(queries)  # (Q, inner)
    if att.ln_q is not None:
        q0 = att.ln_q(q0)
    inner = q0.shape[-1]
    dh = inner // h
    w_kv, b_kv = att.to_kv.weight, att.to_kv.bias
    args = (ctx, w_kv[:, :inner], w_kv[:, inner:], q0.reshape(Q, h, dh), att.to_out.weight,
            layer.ln1.weight, layer.ln1.bias, queries)
    kwargs = dict(scale=1.0 / dh**0.5, ln_eps=ln_eps, value_bf16=value_bf16,
                  lnk=None if att.ln_k is None else (att.ln_k.weight, att.ln_k.bias))
    # The biases of to_kv / to_out where the layer holds them (perceiver.py:200-212, :295)
    if b_kv is not None:
        kwargs.update(bk=b_kv[:inner], bv=b_kv[inner:])
    if att.to_out.bias is not None:
        kwargs.update(bout=att.to_out.bias)
    return args, kwargs


def mlp_half(layer: _Layer, lat: torch.Tensor, ln_eps: float = 1e-5) -> torch.Tensor:
    """A layer's MLP half ``lat + LN(mlp(lat))`` on ``lat: (..., D)`` as one K3 call with the
    LayerNorm affine in the FiLM slot (``perceiver.py:255-273``): the ``4 D`` hidden layer
    never reaches device memory."""
    D_lat = lat.shape[-1]
    mp, ln2 = layer.mlp, layer.ln2
    out = mlp_adaln_residual(
        lat.reshape(1, -1, D_lat),
        mp.fc1.weight, mp.fc1.bias, mp.fc2.weight, mp.fc2.bias,
        shift=ln2.bias[None], scale=ln2.weight[None], scale_bias=0.0, ln_eps=ln_eps,
    )
    return out.reshape(lat.shape)


def _attention(att: _Attention, latents: torch.Tensor, x: torch.Tensor,
               num_heads: int) -> torch.Tensor:
    """Cross-attention latents <- context, ``(..., L1, Dl)`` and ``(..., L2, Dc)``, with the
    ``ln_k`` / ``ln_q`` of the layer before the head split (``perceiver.py:45-59``)."""
    q = att.to_q(latents)
    k, v = att.to_kv(x).chunk(2, dim=-1)
    if att.ln_k is not None:
        k = att.ln_k(k)
        q = att.ln_q(q)
    q, k, v = (split_heads(t, num_heads) for t in (q, k, v))
    return att.to_out(merge_heads(sdpa(q, k, v)))


def perceiver_layer_apply(
    layer: _Layer,
    latents: torch.Tensor,
    x: torch.Tensor,
    num_heads: int,
    ln_eps: float = 1e-5,
    residual_latent: bool = True,
) -> torch.Tensor:
    """One post-res-norm Perceiver layer on per-column latents ``(M, Q, D)`` and an M-major
    context ``(M, K, D)``: ``LN1(attention)`` (+ the latents with ``residual_latent``), then
    the MLP half (K3)."""
    attn_out = layer.ln1(_attention(layer.attn, latents, x, num_heads), eps=ln_eps)
    latents = attn_out + latents if residual_latent else attn_out
    return mlp_half(layer, latents, ln_eps)


def perceiver_resampler_apply(
    p: PerceiverResampler,
    latents: torch.Tensor,
    x: torch.Tensor,
    num_heads: Optional[int] = None,
    ln_eps: float = 1e-5,
    residual_latent: bool = True,
) -> torch.Tensor:
    """The generic resampler (``perceiver.py:90-103``): every layer per column, latents
    ``(..., Q, D)`` against the context ``(..., K, D)``. ``num_heads`` defaults to the
    resampler's own."""
    h = p.num_heads if num_heads is None else num_heads
    for layer in p.layers:
        latents = perceiver_layer_apply(layer, latents, x, h, ln_eps, residual_latent)
    return latents


def resampler_shared_query_apply(
    p: PerceiverResampler,
    queries: torch.Tensor,
    ctx: torch.Tensor,
    ln_eps: float = 1e-5,
    value_bf16: bool = False,
) -> torch.Tensor:
    """``queries: (Q, D)``, k-major context ``ctx: (K, M, D)`` -> ``(M, Q, D)``: layer 0 as
    K4, then its MLP half (:func:`mlp_half`, K3); each deeper layer as
    :func:`perceiver_layer_apply` on the M-major context, in float32 under ``value_bf16``."""
    args, kwargs = shared_query_core_args(p, queries, ctx, ln_eps, value_bf16)
    lat = mlp_half(p.layers[0], perceiver_core(*args, **kwargs), ln_eps)
    if len(p.layers) == 1:
        return lat
    if value_bf16:
        lat = lat.float()  # the deeper, row-dependent layers stay f32 (perceiver.py:276-277)
    c_m = ctx.transpose(0, 1)  # (M, K, D)
    for layer in p.layers[1:]:
        lat = perceiver_layer_apply(layer, lat, c_m, p.num_heads, ln_eps)
    return lat
