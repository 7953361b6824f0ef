"""Perceiver resampler of the level (de-)aggregation (port of
``aurora_tpu/model/perceiver.py``).

Both uses have queries that are identical for every token column (the learned latents of
the encoder, the pressure-level embeddings of the decoder), so layer 0's query projection
runs once on ``(Q, D)`` and the per-column work is the shared-query core (K4) followed by
the MLP half ``lat + LN(mlp(lat))``, which is the block-MLP call (K3) with the LayerNorm
affine in the FiLM slot. Under ``value_bf16`` (the production ``agg_bf16``/``deagg_bf16``
modes) the value path runs in bf16 and q/k/logits stay f32.

The port runs this one form on every device; the JAX package's other routes (generic
per-column resampler, chunking, deeper layers) are not ported: the main path uses depth 1.
"""

from __future__ import annotations

import torch
from torch import nn

from aurora_tpu_torch.model.nn import LayerNorm, Linear, MLP
from aurora_tpu_torch.ops.mlp import mlp_adaln_residual
from aurora_tpu_torch.ops.resampler import perceiver_core

__all__ = [
    "PerceiverResampler",
    "resampler_shared_query_apply",
    "shared_query_core_args",
    "shared_query_mlp",
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
        if depth != 1:
            raise NotImplementedError("only depth-1 resamplers are ported")
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
    the query projection, once on ``queries: (Q, D)``, and the weights as the layer holds
    them."""
    layer = p.layers[0]
    att = layer.attn
    h = p.num_heads
    Q = queries.shape[0]
    q0 = att.to_q(queries)  # (Q, inner)
    if att.ln_q is not None:
        q0 = att.ln_q(q0)
    inner = q0.shape[-1]
    dh = inner // h
    w_kv = att.to_kv.weight
    args = (ctx, w_kv[:, :inner], w_kv[:, inner:], q0.reshape(Q, h, dh), att.to_out.weight,
            layer.ln1.weight, layer.ln1.bias, queries)
    kwargs = dict(scale=1.0 / dh**0.5, ln_eps=ln_eps, value_bf16=value_bf16,
                  lnk=None if att.ln_k is None else (att.ln_k.weight, att.ln_k.bias))
    return args, kwargs


def shared_query_mlp(p: PerceiverResampler, lat: torch.Tensor, ln_eps: float = 1e-5) -> torch.Tensor:
    """Layer 0's MLP half on K4's ``(M, Q, D)`` result: ``lat + LN(mlp(lat))`` as one K3 call
    with the LayerNorm affine in the FiLM slot."""
    M, Q, D_lat = lat.shape
    mp, ln2 = p.layers[0].mlp, p.layers[0].ln2
    out = mlp_adaln_residual(
        lat.reshape(1, M * Q, D_lat),
        mp.fc1.weight, mp.fc1.bias, mp.fc2.weight, mp.fc2.bias,
        shift=ln2.bias[None], scale=ln2.weight[None], scale_bias=0.0, ln_eps=ln_eps,
    )
    return out.reshape(M, Q, D_lat)


def resampler_shared_query_apply(
    p: PerceiverResampler,
    queries: torch.Tensor,
    ctx: torch.Tensor,
    ln_eps: float = 1e-5,
    value_bf16: bool = False,
) -> torch.Tensor:
    """``queries: (Q, D)``, k-major context ``ctx: (K, M, D)`` -> ``(M, Q, D)``: K4, then
    the MLP half (K3)."""
    args, kwargs = shared_query_core_args(p, queries, ctx, ln_eps, value_bf16)
    return shared_query_mlp(p, perceiver_core(*args, **kwargs), ln_eps)
