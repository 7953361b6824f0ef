"""K9-K13: the kernels of the probe tools (:mod:`aurora_tpu_torch.tools`).

They replace the five Pallas kernels that the JAX package defines inside its tools, each
with its plain PyTorch version beside it. What a TPU mode meant is given its reading on a
Hopper card in each wrapper's docstring; the kernels are in ``csrc/probes.cu``.

* K9 :func:`mlp_t` replaces ``tools/backbone_ablate.py::make_mlp_t`` (``pl.pallas_call`` at
  ``backbone_ablate.py:457``): the block MLP branch computed feature-major.
* K10 :func:`attn_probe` replaces ``make_probe(mode)`` (``:598``): the qkv projection and the
  unmasked attention core on partitioned windows in seven timing modes.
* K11 :func:`attn5d_direct` replaces ``make_direct(mode)`` (``:877``): window attention whose
  unit of work is a strip of windows of the 5D tokens, gathered on chip.
* K12 :func:`gemm_blocked` replaces ``tools/gemm_probe.py::pallas_gemm`` (``:102``): a
  hand-blocked GEMM with a swept row block.
* K13 :func:`smem_probe` replaces ``tools/vmem_probe.py::try_size`` (``:26``): a trivial
  kernel with a swept fast-memory scratch.

On a CUDA tensor every wrapper launches its kernel or raises; the plain versions run for
CPU tensors only (and beside the kernels in the checks on the card).
"""

from __future__ import annotations

import ctypes
import math

import torch

from aurora_tpu_torch.model.nn import acc_dtype
from aurora_tpu_torch.ops import _lib
from aurora_tpu_torch.ops.mlp import _mlp_weights, mlp_adaln_residual_plain
from aurora_tpu_torch.ops.window_attention import (
    _check_heads,
    window_attention_windowed_plain,
    window_partition,
    window_reverse,
)

__all__ = [
    "ATTN_PROBE_MODES",
    "ATTN5D_MODES",
    "SharedMemoryRefused",
    "attn5d_direct",
    "attn5d_direct_plain",
    "attn_probe",
    "attn_probe_plain",
    "gemm_blocked",
    "gemm_blocked_plain",
    "mlp_t",
    "mlp_t_plain",
    "smem_optin_bytes",
    "smem_probe",
    "smem_probe_plain",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ATTN_PROBE_MODES = (
    "baseline", "no_softmax", "no_core", "fulld", "bf16_core", "batched_heads", "bf16_batched",
)
ATTN5D_MODES = ("vec", "loop")


# ------------------------------------------------------------------------------ K12


def gemm_blocked_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gemm_blocked`: ``round(a @ w)`` with f32 accumulation."""
    acc = acc_dtype(a.dtype)
    return (a.to(acc) @ w.to(acc)).to(a.dtype)


def gemm_blocked(a: torch.Tensor, w: torch.Tensor, MB: int) -> torch.Tensor:
    """``round_bf16(a @ w)`` for ``a: (M, K)``, ``w: (K, N)`` as stored, f32 accumulation.

    ``MB`` is the row block. The TPU kernel held ``MB`` rows with whole K and N in VMEM;
    whole K and N do not fit a block's 227 KB of shared memory at K = 2048, so here ``MB``
    is the number of rows one block walks, in 64-row tiles, with N in chunks of 128 and K
    in steps of 32 through shared memory. ``M`` must be a multiple of ``MB``.

    CPU tensors take :func:`gemm_blocked_plain`; CUDA tensors launch the kernel, which takes
    bf16 with K a multiple of 32 and N of 128.
    """
    M, K = a.shape
    N = w.shape[1]
    if tuple(w.shape) != (K, N) or MB <= 0 or M % MB:
        raise ValueError(f"gemm_blocked: a {tuple(a.shape)}, w {tuple(w.shape)}, MB={MB}")
    if a.device.type == "cpu":
        return gemm_blocked_plain(a, w)
    _lib.require(a, "a", torch.bfloat16)
    _lib.require(w, "w", torch.bfloat16, (K, N))
    if K % 32 or N % 128:
        raise ValueError(f"gemm_blocked kernel: needs K % 32 == 0, N % 128 == 0; got {K}, {N}")
    out = torch.empty(M, N, device=a.device, dtype=torch.bfloat16)
    fn = _lib.kernel("probes", "gemm_blocked", [_P] * 3 + [_I] * 4 + [_P])
    err = fn(a.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N, MB, _lib.stream(a))
    _lib.check(err, "gemm_blocked")
    _lib.LAUNCHES["gemm_blocked"] += 1
    return out


# ------------------------------------------------------------------------------ K13


class SharedMemoryRefused(RuntimeError):
    """The card refused a block this much dynamic shared memory (attribute or launch)."""

    def __init__(self, nbytes: int, code: int):
        super().__init__(f"{nbytes} bytes of dynamic shared memory refused: CUDA error {code}")
        self.nbytes, self.code = nbytes, code


def smem_probe_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`smem_probe`: ``2 x + x[0, 0]``."""
    return 2.0 * x + x[0, 0]


def smem_probe(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """``2 x + scratch[0, 0]`` with ``scratch[0, :] = x[0, :]`` for ``x: (8, 128)`` f32,
    where ``scratch`` is ``nbytes`` of fast memory whose last byte is also touched.

    The TPU probe raised its VMEM scratch until Mosaic refused. The card's counterpart is
    the dynamic shared memory one block may opt in to
    (``cudaFuncAttributeMaxDynamicSharedMemorySize``). A refused attribute or launch raises
    :class:`SharedMemoryRefused`; the refusal is not sticky and is cleared.

    CPU tensors take :func:`smem_probe_plain`; CUDA tensors launch the kernel.
    """
    if tuple(x.shape) != (8, 128):
        raise ValueError(f"smem_probe: x must be (8, 128), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return smem_probe_plain(x)
    _lib.require(x, "x", torch.float32)
    out = torch.empty_like(x)
    fn = _lib.kernel("probes", "smem_probe", [_P, _P, _I, _P])
    err = fn(x.data_ptr(), out.data_ptr(), int(nbytes), _lib.stream(x))
    if err != 0:
        raise SharedMemoryRefused(int(nbytes), err)
    _lib.LAUNCHES["smem_probe"] += 1
    return out


def smem_optin_bytes() -> int:
    """``cudaDevAttrMaxSharedMemoryPerBlockOptin`` of the current card."""
    value = ctypes.c_int(0)
    fn = _lib.kernel("probes", "smem_optin_bytes", [ctypes.POINTER(ctypes.c_int)])
    _lib.check(fn(ctypes.byref(value)), "smem_optin_bytes")
    return value.value


# ------------------------------------------------------------------------------ K9


def mlp_t_plain(x, w1, b1, w2, b2, sh, sc, ln_eps: float = 1e-5) -> torch.Tensor:
    """Plain version of :func:`mlp_t`: K3's plain version at ``scale_bias = 0`` with the
    per-feature ``(D, 1)`` shift and gain as one FiLM row."""
    return mlp_adaln_residual_plain(
        x[None], w1, b1.reshape(-1), w2, b2.reshape(-1), sh.reshape(1, -1), sc.reshape(1, -1),
        0.0, ln_eps,
    )[0]


def mlp_t(x, w1, b1, w2, b2, sh, sc, R: int, ln_eps: float = 1e-5) -> torch.Tensor:
    """``x + LN(round(fc2 GELU(round(fc1 x + b1)) + b2)) * sc + sh`` for ``x: (L, D)``,
    ``w1: (D, H)``, ``w2: (H, D)``, ``b1: (H, 1)``, ``b2``/``sh``/``sc``: ``(D, 1)``;
    the numbers of K3 at ``scale_bias = 0``, computed feature-major.

    The TPU kernel transposed its ``(R, D)`` row tile once so that both products have the
    tokens as their wide N dimension and the LayerNorm reduces over sublanes. On the card
    the same choice reads: the weight is the row (A) operand of the tensor-core tile and
    the tokens its columns, the hidden stays on chip as (hidden chunk, token tile), and the
    LayerNorm reduces down the accumulator's rows, across lanes and then across warps
    through shared memory, where K3 reduces along a thread's own registers. ``R`` stays
    the number of token rows one block walks (in tiles of ``32768 / D`` tokens), so
    ``L / R`` blocks run; it must divide ``L``.

    CPU tensors take :func:`mlp_t_plain`; CUDA tensors launch the kernel, which takes bf16
    rows with D in (512, 1024, 2048) and a hidden width that is a multiple of 64.
    """
    L, D = x.shape
    Hd = w1.shape[1]
    if R <= 0 or L % R:
        raise ValueError(f"mlp_t: the row block R={R} must divide L={L}")
    if x.device.type == "cpu":
        return mlp_t_plain(x, w1, b1, w2, b2, sh, sc, ln_eps)
    _lib.require(x, "x", torch.bfloat16)
    if D not in (512, 1024, 2048) or Hd % 64 or tuple(w2.shape) != (Hd, D):
        raise ValueError(f"mlp_t kernel: unsupported D={D}, hidden={Hd}")
    w1t, b1f, w2t, b2f = _mlp_weights(w1, b1.reshape(-1), w2, b2.reshape(-1))
    shf = sh.to(torch.float32).reshape(-1).contiguous()
    scf = sc.to(torch.float32).reshape(-1).contiguous()
    for n, t, shape in (("b1", b1f, (Hd,)), ("b2", b2f, (D,)), ("sh", shf, (D,)), ("sc", scf, (D,))):
        _lib.require(t, n, torch.float32, shape)
    out = torch.empty_like(x)
    fn = _lib.kernel("probes", "mlp_t", [_P] * 8 + [_I] * 4 + [_F, _P])
    err = fn(
        x.data_ptr(), w1t.data_ptr(), b1f.data_ptr(), w2t.data_ptr(), b2f.data_ptr(),
        shf.data_ptr(), scf.data_ptr(), out.data_ptr(), L, R, D, Hd, float(ln_eps),
        _lib.stream(x),
    )
    _lib.check(err, "mlp_t")
    _lib.LAUNCHES["mlp_t"] += 1
    return out


# ------------------------------------------------------------------------------ K10


def attn_probe_plain(xw, wqkv, bqkv, num_heads: int, mode: str) -> torch.Tensor:
    """Plain version of :func:`attn_probe` (``backbone_ablate.py:509-595``), step by step.

    ``qkv = round(x @ W) + b`` (bias added after the rounding, in the token dtype).
    ``no_core`` returns its first D features. Otherwise, per head (``fulld``: one head as
    wide as D) with ``scale = 1 / sqrt(D / num_heads)`` in every mode:

    * ``baseline``/``batched_heads``/``fulld``: f32 logits ``q.k * scale``, f32 softmax,
      weights rounded to the token dtype;
    * ``no_softmax``: the scaled f32 logits, rounded, are the weights;
    * ``bf16_core``/``bf16_batched``: the logits are rounded to the token dtype before the
      scale, and the softmax runs on token-dtype values: the scaled logits, their difference
      to the row maximum, its exponential, the row sum (summed in f32, rounded) and the
      quotient are each rounded to the token dtype;

    then ``w @ v`` with f32 accumulation, rounded, heads merged.
    """
    if mode not in ATTN_PROBE_MODES:
        raise ValueError(f"attn_probe mode must be one of {ATTN_PROBE_MODES}, got {mode!r}")
    dt, acc = xw.dtype, acc_dtype(xw.dtype)
    B, nW, N, D = xw.shape
    qkv = (xw.to(acc) @ wqkv.to(dt).to(acc)).to(dt) + bqkv.to(dt).reshape(-1)
    if mode == "no_core":
        return qkv[..., :D]
    scale = 1.0 / math.sqrt(D // num_heads)
    h = 1 if mode == "fulld" else num_heads
    q, k, v = (t.reshape(B, nW, N, h, D // h).to(acc) for t in qkv.chunk(3, -1))
    logits = torch.einsum("bwqhd,bwkhd->bwhqk", q, k)
    if mode in ("bf16_core", "bf16_batched"):
        lg = logits.to(dt) * scale
        e = torch.exp(lg - lg.amax(-1, keepdim=True))
        wgt = e / e.sum(-1, keepdim=True)
    elif mode == "no_softmax":
        wgt = (logits * scale).to(dt)
    else:
        wgt = torch.softmax(logits * scale, dim=-1).to(dt)
    return torch.einsum("bwhqk,bwkhd->bwqhd", wgt.to(acc), v).to(dt).reshape(B, nW, N, D)


def attn_probe(xw, wqkv, bqkv, num_heads: int, mode: str) -> torch.Tensor:
    """The qkv projection and the unmasked attention core on partitioned windows
    ``xw: (B, nW, 144, D)``, ``wqkv: (D, 3D)``, ``bqkv: (3D,)`` or ``(1, 3D)``, in one of
    :data:`ATTN_PROBE_MODES`; the numbers of each mode are in :func:`attn_probe_plain`.

    ``baseline`` is K6 without tail and mask: one block per (window, head), the TPU
    kernel's loop over heads. The TPU kernel's ``batched_heads``/``bf16_batched`` put all
    heads into one batched product: the same numbers in another schedule. On the card the
    other schedule is one block per window that walks its heads with q, k and v of one
    head at a time in shared memory. ``fulld`` (one head of width D) exceeds a block's
    shared memory with q, k and v of a window (442 KB at D = 512), so its block tiles the
    head dim in chunks of 64, sums the chunks' logits in registers and keeps v of every
    chunk in shared memory; it takes D = 512 only. ``no_softmax``, ``no_core`` and
    ``fulld`` are wrong as attention by construction and right against their plain
    versions.

    CPU tensors take :func:`attn_probe_plain`; CUDA tensors launch the kernel, which takes
    bf16 tokens, windows of 144 tokens and a head dim of 64.
    """
    if mode not in ATTN_PROBE_MODES:
        raise ValueError(f"attn_probe mode must be one of {ATTN_PROBE_MODES}, got {mode!r}")
    if xw.device.type == "cpu":
        return attn_probe_plain(xw, wqkv, bqkv, num_heads, mode)
    B, nW, N, D = xw.shape
    _lib.require(xw, "xw", torch.bfloat16)
    _check_heads(N, D, num_heads, "attn_probe")
    if mode == "fulld" and D != 512:
        raise ValueError(f"attn_probe kernel: mode fulld takes D = 512, got {D}")
    wt = wqkv.to(torch.bfloat16).t().contiguous()  # (3D, D)
    bq = bqkv.to(torch.bfloat16).reshape(-1).contiguous()
    _lib.require(wt, "wqkv", torch.bfloat16, (3 * D, D))
    _lib.require(bq, "bqkv", torch.bfloat16, (3 * D,))
    out = torch.empty_like(xw)
    fn = _lib.kernel("probes", "attn_probe", [_P] * 4 + [_I] * 4 + [_P])
    err = fn(xw.data_ptr(), wt.data_ptr(), bq.data_ptr(), out.data_ptr(), B * nW, D, num_heads,
             ATTN_PROBE_MODES.index(mode), _lib.stream(xw))
    _lib.check(err, f"attn_probe[{mode}]")
    _lib.LAUNCHES["attn_probe"] += 1
    return out


# ------------------------------------------------------------------------------ K11


def attn5d_direct_plain(x5, wqkv, bqkv, ws, num_heads: int, mode: str) -> torch.Tensor:
    """Plain version of :func:`attn5d_direct` (``backbone_ablate.py:822-874``): unmasked
    window attention without tail on padded 5D tokens. ``vec`` relayouts the whole grid
    into windows once; ``loop`` takes one slice of ``ws[2]`` columns per window position
    along W and writes each result back in place. Both give the same numbers."""
    if mode not in ATTN5D_MODES:
        raise ValueError(f"attn5d_direct mode must be one of {ATTN5D_MODES}, got {mode!r}")
    _, Cp, Hp, Wp, _ = x5.shape
    bq = bqkv.reshape(-1)

    def attend(blk):
        w = window_attention_windowed_plain(window_partition(blk, ws), wqkv, bq, None, num_heads)
        return window_reverse(w, ws, *blk.shape[1:4])

    if mode == "vec":
        return attend(x5)
    out = torch.empty_like(x5)
    for j in range(Wp // ws[2]):
        cols = slice(j * ws[2], (j + 1) * ws[2])
        out[:, :, :, cols] = attend(x5[:, :, :, cols])
    return out


def attn5d_direct(x5, wqkv, bqkv, ws, num_heads: int, mode: str) -> torch.Tensor:
    """Unmasked window attention without tail on padded 5D tokens
    ``x5: (B, Cp, Hp, Wp, D)`` with windows ``ws`` read in place; ``wqkv: (D, 3D)``,
    ``bqkv: (3D,)``. The numbers of K2 without tail and of the chain partition -> K6
    without tail -> reverse.

    The unit of work is the TPU kernel's: the ``(ws0, ws1, Wp)`` strip of ``Wp / ws2``
    windows, gathered on chip. A strip is 4.4 MB at stage 1, far beyond shared memory, so
    a block (one per strip and head) walks its windows and holds one window's 144 x 32
    channel slab at a time. ``loop`` (the TPU kernel's one slice per window) gathers each
    slab from device memory through a table of row numbers with register-staged 16-byte
    loads; ``vec`` (the TPU kernel's one relayout of the strip) brings the slabs in by one
    pass of asynchronous 16-byte copies addressed arithmetically in strip order, straight
    into shared memory and double-buffered against the tensor-core work.

    CPU tensors take :func:`attn5d_direct_plain`; CUDA tensors launch the kernel, which
    takes bf16 tokens, windows of 144 tokens and a head dim of 64.
    """
    if mode not in ATTN5D_MODES:
        raise ValueError(f"attn5d_direct mode must be one of {ATTN5D_MODES}, got {mode!r}")
    B, Cp, Hp, Wp, D = x5.shape
    if Cp % ws[0] or Hp % ws[1] or Wp % ws[2]:
        raise ValueError(f"padded grid {(Cp, Hp, Wp)} is not a multiple of the window {ws}")
    if x5.device.type == "cpu":
        return attn5d_direct_plain(x5, wqkv, bqkv, ws, num_heads, mode)
    _lib.require(x5, "x5", torch.bfloat16)
    _check_heads(ws[0] * ws[1] * ws[2], D, num_heads, "attn5d_direct")
    wt = wqkv.to(torch.bfloat16).t().contiguous()
    bq = bqkv.to(torch.bfloat16).reshape(-1).contiguous()
    _lib.require(wt, "wqkv", torch.bfloat16, (3 * D, D))
    _lib.require(bq, "bqkv", torch.bfloat16, (3 * D,))
    out = torch.empty_like(x5)
    fn = _lib.kernel("probes", "attn5d_direct", [_P] * 4 + [_I] * 10 + [_P])
    err = fn(x5.data_ptr(), wt.data_ptr(), bq.data_ptr(), out.data_ptr(), B, Cp, Hp, Wp, D, *ws,
             num_heads, int(mode == "vec"), _lib.stream(x5))
    _lib.check(err, f"attn5d_direct[{mode}]")
    _lib.LAUNCHES["attn5d_direct"] += 1
    return out
