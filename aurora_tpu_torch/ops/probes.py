"""K9-K13: the kernels of the probe tools (:mod:`aurora_tpu_torch.tools`).

They replace the five Pallas kernels that the JAX package defines inside its tools, each
with its plain PyTorch version beside it. What a TPU mode meant is given its reading on a
Hopper card in each wrapper's docstring. K9 is ``csrc/mlp_t.cu``, K10 ``csrc/attn_probe.cu``,
K11 ``csrc/attn5d_direct.cu`` and K12 ``csrc/gemm.cu``, all on the shared TMA + ``wgmma``
headers; K13 is ``csrc/probes.cu``.

* K9 :func:`mlp_t` replaces ``tools/backbone_ablate.py::make_mlp_t`` (``pl.pallas_call`` at
  ``backbone_ablate.py:457``): the block MLP branch computed feature-major, the weight as
  the row operand of both products and the tokens as their wide dimension.
* K10 :func:`attn_probe` replaces ``make_probe(mode)`` (``:598``): the qkv projection and the
  unmasked attention core on partitioned windows in seven timing modes, on K6's qkv
  product and K7's core.
* K11 :func:`attn5d_direct` replaces ``make_direct(mode)`` (``:877``): window attention on
  the 5D tokens whose two modes are two schedules of the windows, whole strips or one
  window at a time, on K2's qkv ring and K7's core.
* K12 :func:`gemm_blocked` replaces ``tools/gemm_probe.py::pallas_gemm`` (``:102``): a
  hand-blocked GEMM with a swept row block, here a persistent TMA + ``wgmma`` pipeline.
* K13 :func:`smem_probe` replaces ``tools/vmem_probe.py::try_size`` (``:26``): a trivial
  kernel with a swept fast-memory scratch.

On a CUDA tensor every wrapper launches its kernel or raises; the plain versions run for
CPU tensors only (and beside the kernels in the checks on the card). Every wrapper reads its
weights as stored.
"""

from __future__ import annotations

import ctypes
import math

import torch

from aurora_tpu_torch.model.nn import acc_dtype
from aurora_tpu_torch.ops import _lib
from aurora_tpu_torch.ops.mlp import MLP_SCRATCH_BYTES, mlp_adaln_residual_plain
from aurora_tpu_torch.ops.window_attention import (
    _check_heads,
    check_window_attention_shape,
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
    "attn5d_schedule",
    "attn5d_unit",
    "attn_probe",
    "attn_probe_plain",
    "GEMM_TILE",
    "gemm_blocked",
    "gemm_blocked_plain",
    "gemm_blocked_schedule",
    "gemm_blocked_unit",
    "MLP_T_TILE",
    "mlp_t",
    "mlp_t_item",
    "mlp_t_plain",
    "mlp_t_schedule",
    "smem_optin_bytes",
    "empty_launch",
    "smem_probe",
    "smem_probe_plain",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ATTN_PROBE_MODES = (
    "baseline", "no_softmax", "no_core", "fulld", "bf16_core", "batched_heads", "bf16_batched",
)
ATTN5D_MODES = ("vec", "loop")
ATTN5D_D = (512, 1024, 2048)  # the widths K11 takes: the 1.3 B model's stages (the tool's sweep)


# ------------------------------------------------------------------------------ K12


def gemm_blocked_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gemm_blocked`: ``round(a @ w)`` with f32 accumulation."""
    acc = acc_dtype(a.dtype)
    return (a.to(acc) @ w.to(acc)).to(a.dtype)


GEMM_TILE = (64, 256, 64)  # rows of a piece, columns and K step of a tile (csrc/gemm.cu)


def gemm_blocked_schedule(M: int, K: int, N: int, MB: int) -> tuple[int, int, int]:
    """``(pieces_per_block, n_tiles, units)`` of the K12 kernel for ``(M, K) @ (K, N)`` under
    the row block ``MB``, or ``ValueError`` naming the shape.

    Each of the ``M / MB`` row blocks is cut into ``ceil(MB / 64)`` pieces of 64 rows, the
    last one ragged. The pieces of all row blocks, in order, are paired into tiles (one
    piece for each consumer warpgroup); a unit is one tile under one of the ``N / 256``
    column tiles. The kernel takes ``K`` a multiple of 64 and ``N`` of 256.
    """
    rows, bn, bk = GEMM_TILE
    if min(M, K, N, MB) <= 0 or M % MB:
        raise ValueError(f"gemm_blocked: the row block MB={MB} must divide M={M} (K={K}, N={N})")
    if K % bk or N % bn:
        raise ValueError(
            f"gemm_blocked kernel: needs K % {bk} == 0 and N % {bn} == 0; got ({M}, {K}) @ "
            f"({K}, {N})"
        )
    pieces_per_block = -(-MB // rows)
    pieces = (M // MB) * pieces_per_block
    units = -(-pieces // 2) * (N // bn)
    if max(pieces, units) >= 2**31:
        raise ValueError(f"gemm_blocked kernel: {units} units for ({M}, {K}) @ ({K}, {N}), MB={MB}")
    return pieces_per_block, N // bn, units


def gemm_blocked_unit(u: int, M: int, MB: int, pieces_per_block: int, n_tiles: int):
    """Unit ``u`` of the schedule as the kernel decodes it: the ``(first row, rows, first
    column, columns)`` rectangles of the output it writes, one for each of its pieces (the
    last tile of an odd number of pieces has one). Column tiles run fastest, so the column
    tiles of one tile are neighbours in time and ``a`` is read from device memory once."""
    rows, bn, _ = GEMM_TILE
    tile, n = divmod(u, n_tiles)
    out = []
    for p in (2 * tile, 2 * tile + 1):
        if p < (M // MB) * pieces_per_block:
            block, t = divmod(p, pieces_per_block)
            out.append((block * MB + t * rows, min(rows, MB - t * rows), n * bn, bn))
    return out


def gemm_blocked(a: torch.Tensor, w: torch.Tensor, MB: int) -> torch.Tensor:
    """``round_bf16(a @ w)`` for ``a: (M, K)``, ``w: (K, N)`` as stored, f32 accumulation.

    ``MB`` is the row block and must divide ``M``. The TPU kernel held ``MB`` rows with whole
    K and N in VMEM per step of a sequential grid. On the card it is the unit of the
    schedule (:func:`gemm_blocked_schedule`): every row block is cut into 64-row pieces,
    pairs of pieces form tiles, and the (tile, column tile) units are dealt to one
    persistent block per SM, so ``MB`` sets where the ragged pieces fall and not how many
    SMs work. The kernel is a TMA + ``wgmma`` pipeline (``csrc/gemm.cu`` on
    ``csrc/gemm_sm90.cuh``) that reads ``w`` as stored; a row's sum runs over K in one
    order, so the result is the same bits for every ``MB``.

    CPU tensors take :func:`gemm_blocked_plain`; CUDA tensors launch the kernel, which takes
    bf16 with K a multiple of 64 and N of 256 and raises for other shapes.
    """
    if a.dim() != 2 or w.dim() != 2 or w.shape[0] != a.shape[1]:
        raise ValueError(f"gemm_blocked: a {tuple(a.shape)}, w {tuple(w.shape)}, MB={MB}")
    (M, K), N = a.shape, w.shape[1]
    if MB <= 0 or M % MB:
        raise ValueError(f"gemm_blocked: a {tuple(a.shape)}, w {tuple(w.shape)}, MB={MB}")
    if a.device.type == "cpu":
        return gemm_blocked_plain(a, w)
    return _gemm_blocked_launch(a, w, MB)


@_lib.launch("gemm_blocked")
def _gemm_blocked_launch(a: torch.Tensor, w: torch.Tensor, MB: int) -> torch.Tensor:
    (M, K), N = a.shape, w.shape[1]
    _lib.require(a, "a", torch.bfloat16)
    _lib.require(w, "w", torch.bfloat16, (K, N))
    pieces_per_block, _, units = gemm_blocked_schedule(M, K, N, MB)
    out = torch.empty(M, N, device=a.device, dtype=torch.bfloat16)
    fn = _lib.kernel("gemm", "gemm_blocked", [_P] * 3 + [_I] * 6 + [_P])
    err = fn(a.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N, MB, pieces_per_block, units,
             _lib.stream(a))
    _lib.check(err, "gemm_blocked")
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
    return _smem_probe_launch(x, nbytes)


@_lib.launch("smem_probe")
def _smem_probe_launch(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    _lib.require(x, "x", torch.float32)
    out = torch.empty_like(x)
    fn = _lib.kernel("probes", "smem_probe", [_P, _P, _I, _P])
    err = fn(x.data_ptr(), out.data_ptr(), int(nbytes), _lib.stream(x))
    if err != 0:
        raise SharedMemoryRefused(int(nbytes), err)
    return out


def empty_launch(device: torch.device) -> None:
    """Launch a kernel that does nothing on ``device``'s current stream: timed beside K13,
    whose own time is what a launch costs. No kernel of the port: it counts nowhere."""
    fn = _lib.kernel("probes", "empty_launch", [_P])
    _lib.check(fn(torch.cuda.current_stream(device).cuda_stream), "empty_launch")


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


MLP_T_TILE = (256, 128)  # tokens and features of a tile of both products (csrc/mlp_t.cu)


def mlp_t_schedule(L: int, D: int, Hd: int, R: int, cap: int = MLP_SCRATCH_BYTES) -> dict:
    """K9's schedule on the card for ``x: (L, D)``, hidden ``Hd`` and the row block ``R``,
    or ``ValueError`` naming the shape.

    A unit is ``R`` consecutive tokens (``R`` must divide ``L``), cut into
    ``tiles_per_unit = ceil(R / 256)`` token tiles from its first row, so no tile straddles
    two units. The bf16 hidden ``h^T`` of a chunk of whole units, each padded to
    ``padded_unit = 256 tiles_per_unit`` columns, must fit ``cap`` (K3's scratch cap); the
    chunks (``(first unit, units)``) are as equal as whole units allow. ``items`` gives each
    chunk's work items of fc1 and of fc2: (token tile, 128-feature tile) pairs over ``Hd``
    and over ``D`` features.
    """
    T, F = MLP_T_TILE
    if R <= 0 or L % R:
        raise ValueError(f"mlp_t: the row block R={R} must divide L={L}")
    tpu = -(-R // T)
    n_units = L // R
    most = cap // (2 * Hd * tpu * T)
    if most <= 0:
        raise ValueError(f"mlp_t kernel: {cap} bytes of scratch hold no unit of R={R}, hidden={Hd}")
    per = -(-n_units // -(-n_units // most))
    chunks = [(u0, min(per, n_units - u0)) for u0 in range(0, n_units, per)]
    return dict(tiles_per_unit=tpu, padded_unit=tpu * T, units_per_chunk=per, chunks=chunks,
                items=[(uc * tpu * (Hd // F), uc * tpu * (D // F)) for _, uc in chunks])


def mlp_t_item(i: int, unit0: int, R: int, tiles_per_unit: int, m_tiles: int):
    """Item ``i`` of a launch over the chunk that starts at unit ``unit0``, as the kernel
    decodes it: ``(first row, rows, first feature)`` of the ``rows x 128`` block of the
    output it computes (``m_tiles``: ``Hd / 128`` for fc1, ``D / 128`` for fc2). Feature
    tiles run fastest, so the blocks that run side by side read the same tokens."""
    T, F = MLP_T_TILE
    tile, mt = divmod(i, m_tiles)
    u, t = divmod(tile, tiles_per_unit)
    return (unit0 + u) * R + t * T, min(T, R - t * T), mt * F


def mlp_t(x, w1, b1, w2, b2, sh, sc, R: int, ln_eps: float = 1e-5) -> torch.Tensor:
    """``x + LN(round(fc2 GELU(round(fc1 x + b1)) + b2)) * sc + sh`` for ``x: (L, D)``,
    ``w1: (D, H)``, ``w2: (H, D)``, ``b1: (H, 1)``, ``b2``/``sh``/``sc``: ``(D, 1)``;
    the numbers of K3 at ``scale_bias = 0``, computed feature-major.

    The TPU kernel transposed its ``(R, D)`` row tile once so that both products have the
    weight as the row operand and the tokens as their wide N dimension, and the LayerNorm
    reduces down the features. On the card both products run in that form on the TMA +
    ``wgmma`` ring (``csrc/mlp_t.cu``): A is the weight as stored (an MN-major operand, no
    transposed copy), N the tokens; fc1's tile of ``h^T`` goes through the GELU into a
    hidden scratch, fc2's tile of ``y^T`` gives each token the LayerNorm statistics of its
    128 features (a reduction down the accumulator's rows) and goes back to token-major
    rows through shared memory; K3's row kernel merges the ``D / 128`` statistics, applies
    the FiLM row and adds ``x``.

    What ``R`` sets on the card: it must divide ``L`` and is the schedule's unit, ``R``
    consecutive tokens whose 256-token tiles start at its first row (a ragged last tile
    where 256 does not divide ``R``); the work is (token tile, feature tile) items over one
    persistent block an SM, so every ``R`` fills the card (:func:`mlp_t_schedule`).

    CPU tensors take :func:`mlp_t_plain`; CUDA tensors launch the kernels, which take bf16
    rows with D in (512, 1024, 2048) and a hidden width that is a multiple of 128.
    """
    L, D = x.shape
    Hd = w1.shape[1]
    if R <= 0 or L % R:
        raise ValueError(f"mlp_t: the row block R={R} must divide L={L}")
    if x.device.type == "cpu":
        return mlp_t_plain(x, w1, b1, w2, b2, sh, sc, ln_eps)
    return _mlp_t_launch(x, w1, b1, w2, b2, sh, sc, R, ln_eps)


@_lib.launch("mlp_t")
def _mlp_t_launch(x, w1, b1, w2, b2, sh, sc, R, ln_eps):
    return _mlp_t_call(_lib.kernel("mlp_t", "mlp_t", _MLP_T_ARGS), x, w1, b1, w2, b2, sh, sc, R,
                       ln_eps)


_MLP_T_ARGS = [_P] * 10 + [_I] * 5 + [_F, _P]


def _mlp_t_call(fn, x, w1, b1, w2, b2, sh, sc, R, ln_eps) -> torch.Tensor:
    """Run ``fn`` (``mlp_t`` of ``csrc/mlp_t.cu``, or an ablated copy) on checked operands:
    the weights as stored (a cast only where they are stored in another type), the
    scratch allocated here."""
    bf, f32 = torch.bfloat16, torch.float32
    L, D = x.shape
    Hd = w1.shape[1]
    _lib.require(x, "x", bf)
    if D not in (512, 1024, 2048) or Hd <= 0 or Hd % MLP_T_TILE[1]:
        raise ValueError(f"mlp_t kernel: unsupported D={D}, hidden={Hd}")
    sched = mlp_t_schedule(L, D, Hd, R)
    ops = {"w1": (w1.to(bf).contiguous(), (D, Hd)), "w2": (w2.to(bf).contiguous(), (Hd, D)),
           "b1": (b1.to(f32).reshape(-1).contiguous(), (Hd,))}
    for n, t in (("b2", b2), ("sh", sh), ("sc", sc)):
        ops[n] = (t.to(f32).reshape(-1).contiguous(), (D,))
    # The tensor maps' bases and the 16-byte loads and stores need 16-byte alignment.
    for name, (t, shape) in {"x": (x, (L, D)), **ops}.items():
        _lib.require(t, name, t.dtype, shape)
        if t.device != x.device or t.data_ptr() % 16:
            raise ValueError(f"mlp_t: {name} must be on {x.device}, 16-byte aligned")
    hid = torch.empty(Hd, sched["units_per_chunk"] * sched["padded_unit"], dtype=bf,
                      device=x.device)
    stats = torch.empty(L, D // MLP_T_TILE[1], 2, dtype=f32, device=x.device)
    out = torch.empty_like(x)
    p = {k: t.data_ptr() for k, (t, _) in ops.items()}
    err = fn(x.data_ptr(), p["w1"], p["b1"], p["w2"], p["b2"], p["sh"], p["sc"], hid.data_ptr(),
             stats.data_ptr(), out.data_ptr(), L, R, D, Hd, sched["units_per_chunk"],
             float(ln_eps), _lib.stream(x))
    _lib.check(err, "mlp_t")
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

    On the card (``csrc/attn_probe.cu``) the qkv product is K6's (the TMA + ``wgmma`` ring,
    ``wqkv`` read as stored, into a ``(rows, 3D)`` scratch); ``no_core`` stops there and
    returns its first D columns, as the TPU mode computed the whole product. The core is
    K7's ring kernel with the weights in the mode's form (f32 softmax, the scaled logits
    rounded, or a softmax rounded to bf16 at every step). ``baseline`` and ``bf16_core`` keep
    the TPU kernel's loop over heads as the unit (window, head); the TPU kernel's
    ``batched_heads``/``bf16_batched`` put all heads into one batched product: the same
    numbers in another schedule, here a unit of one window that walks its heads. So
    ``baseline`` is K6 without tail and mask, bit for bit, and each batched mode gives its
    per-head mode's bits. ``fulld`` (one head of width D, scale 1/8) has a ``wgmma`` core of
    its own that streams q, k and v of a window (442 KB at D = 512) through shared memory in
    chunks of 64 features; it takes D = 512 only. ``no_softmax``, ``no_core`` and ``fulld``
    are wrong as attention by construction and right against their plain versions.

    CPU tensors take :func:`attn_probe_plain`; CUDA tensors launch the kernels, which take
    bf16 tokens, windows of 144 tokens, a head dim of 64 and D a multiple of 256.
    """
    if mode not in ATTN_PROBE_MODES:
        raise ValueError(f"attn_probe mode must be one of {ATTN_PROBE_MODES}, got {mode!r}")
    if xw.device.type == "cpu":
        return attn_probe_plain(xw, wqkv, bqkv, num_heads, mode)
    return _attn_probe_launch(xw, wqkv, bqkv, num_heads, mode)


@_lib.launch("attn_probe")
def _attn_probe_launch(xw, wqkv, bqkv, num_heads, mode):
    return _attn_probe_call(_lib.kernel("attn_probe", "attn_probe", _ATTN_PROBE_ARGS), xw, wqkv,
                            bqkv, num_heads, mode)


_ATTN_PROBE_ARGS = [_P] * 5 + [_I] * 4 + [_P]


def _attn_probe_call(fn, xw, wqkv, bqkv, num_heads, mode) -> torch.Tensor:
    """Run ``fn`` (``attn_probe`` of ``csrc/attn_probe.cu``, or an ablated copy) on checked
    operands: ``wqkv`` as stored (a cast only where it is stored in another type), the qkv
    scratch allocated here."""
    bf = torch.bfloat16
    B, nW, N, D = xw.shape
    _lib.require(xw, "xw", bf)
    _check_heads(N, D, num_heads, "attn_probe")
    if D % 256:
        raise ValueError(f"attn_probe kernel: D={D} is not a multiple of 256")
    if mode == "fulld" and D != 512:
        raise ValueError(f"attn_probe kernel: mode fulld takes D = 512, got {D}")
    ops = {"wqkv": (wqkv.to(bf).contiguous(), (D, 3 * D)),
           "bqkv": (bqkv.to(bf).reshape(-1).contiguous(), (3 * D,))}
    for name, (t, shape) in {"xw": (xw, (B, nW, N, D)), **ops}.items():
        _lib.require(t, name, bf, shape)
        if t.device != xw.device or t.data_ptr() % 16:
            raise ValueError(f"attn_probe: {name} must be on {xw.device}, 16-byte aligned")
    qkv = xw.new_empty(B, nW, N, 3 * D)
    out = None if mode == "no_core" else torch.empty_like(xw)
    err = fn(xw.data_ptr(), ops["wqkv"][0].data_ptr(), ops["bqkv"][0].data_ptr(), qkv.data_ptr(),
             None if out is None else out.data_ptr(), B * nW, D, num_heads,
             ATTN_PROBE_MODES.index(mode), _lib.stream(xw))
    _lib.check(err, f"attn_probe[{mode}]")
    return qkv[..., :D] if out is None else out


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


def attn5d_unit(u: int, mode: str, heads: int, W1: int) -> tuple[int, int]:
    """``(window, head)`` of unit ``u`` of K11's core launch, decoded as
    ``csrc/attn5d_direct.cu`` decodes it. Windows are numbered in ``window_partition``'s order
    (``b nW + (c1 H1 + h1) W1 + w1``), so strip ``s`` holds windows ``s W1 .. s W1 + W1 - 1``.
    ``loop``: the heads of one window in turn (K2's order); ``vec``: the ``W1`` windows of a
    strip for one head, then the strip's next head."""
    if mode == "loop":
        return u // heads, u % heads
    item = u // W1
    return (item // heads) * W1 + u % W1, item % heads


def attn5d_schedule(B: int, Cp: int, Hp: int, Wp: int, ws, heads: int, mode: str,
                    slots: int = 2 * 132) -> dict:
    """The work of K11's core launch as ``launch_sdpa`` (``csrc/sdpa_sm90.cuh``) cuts it:
    ``units`` = windows x heads, runs of ``run`` units per block (about ``units / slots``,
    rounded up to whole items of ``group`` units: ``W1`` in mode ``vec``, 1 in ``loop``) and
    ``blocks`` of them. ``slots``: two blocks an SM, 264 on the H100. Decode a unit with
    :func:`attn5d_unit`."""
    if mode not in ATTN5D_MODES:
        raise ValueError(f"attn5d_direct mode must be one of {ATTN5D_MODES}, got {mode!r}")
    if Cp % ws[0] or Hp % ws[1] or Wp % ws[2]:
        raise ValueError(f"padded grid {(Cp, Hp, Wp)} is not a multiple of the window {ws}")
    W1 = Wp // ws[2]
    nW = (Cp // ws[0]) * (Hp // ws[1]) * W1
    units = B * nW * heads
    group = W1 if mode == "vec" else 1
    run = -(-units // slots)
    run = -(-run // group) * group
    return dict(units=units, run=run, blocks=-(-units // run), group=group, W1=W1, nW=nW)


def attn5d_direct(x5, wqkv, bqkv, ws, num_heads: int, mode: str) -> torch.Tensor:
    """Unmasked window attention without tail on padded 5D tokens
    ``x5: (B, Cp, Hp, Wp, D)`` with windows ``ws`` read in place; ``wqkv: (D, 3D)``,
    ``bqkv: (3D,)``. The numbers of K2 without tail and of the chain partition -> K6
    without tail -> reverse.

    On the card (``csrc/attn5d_direct.cu``) this is K2 without tail's two launches: the qkv
    product on the TMA + ``wgmma`` ring over the grid's rows in stored order (``wqkv`` read
    as stored) into a ``(rows, 3D)`` scratch, then K7's ring core reading each window in
    place through the 5D tensor map, unmasked. The TPU kernel's two modes are two work
    orders of the core (:func:`attn5d_schedule`): ``vec`` (one relayout of a whole strip)
    has a block take whole ``(ws0, ws1, Wp)`` strips of ``Wp / ws2`` windows, one head at a
    time; ``loop`` (one slice per window) takes one window at a time with its heads in
    turn. Both give K2 without tail's bits.

    CPU tensors take :func:`attn5d_direct_plain`; CUDA tensors launch the kernels, which
    take bf16 tokens of the shapes K2 takes (``check_window_attention_shape``).
    """
    if mode not in ATTN5D_MODES:
        raise ValueError(f"attn5d_direct mode must be one of {ATTN5D_MODES}, got {mode!r}")
    _, Cp, Hp, Wp, _ = x5.shape
    if Cp % ws[0] or Hp % ws[1] or Wp % ws[2]:
        raise ValueError(f"padded grid {(Cp, Hp, Wp)} is not a multiple of the window {ws}")
    if x5.device.type == "cpu":
        return attn5d_direct_plain(x5, wqkv, bqkv, ws, num_heads, mode)
    return _attn5d_direct_launch(x5, wqkv, bqkv, ws, num_heads, mode)


@_lib.launch("attn5d_direct")
def _attn5d_direct_launch(x5, wqkv, bqkv, ws, num_heads, mode):
    return _attn5d_direct_call(_lib.kernel("attn5d_direct", "attn5d_direct", _ATTN5D_ARGS), x5,
                               wqkv, bqkv, ws, num_heads, mode)


_ATTN5D_ARGS = [_P] * 5 + [_I] * 10 + [_P]


def _attn5d_direct_call(fn, x5, wqkv, bqkv, ws, num_heads, mode) -> torch.Tensor:
    """Run ``fn`` (``attn5d_direct`` of ``csrc/attn5d_direct.cu``, or an ablated copy) on
    checked operands: ``wqkv`` as stored (a cast only where it is stored in another type),
    the qkv scratch allocated here."""
    bf = torch.bfloat16
    _lib.require(x5, "x5", bf)
    _, _, rows = check_window_attention_shape(tuple(x5.shape), num_heads, ws, ATTN5D_D)
    B, Cp, Hp, Wp, D = x5.shape
    ops = {"wqkv": (wqkv.to(bf).contiguous(), (D, 3 * D)),
           "bqkv": (bqkv.to(bf).reshape(-1).contiguous(), (3 * D,))}
    for name, (t, shape) in {"x5": (x5, tuple(x5.shape)), **ops}.items():
        _lib.require(t, name, bf, shape)
        if t.device != x5.device or t.data_ptr() % 16:
            raise ValueError(f"attn5d_direct: {name} must be on {x5.device}, 16-byte aligned")
    qkv = x5.new_empty(rows, 3 * D)
    out = torch.empty_like(x5)
    err = fn(x5.data_ptr(), ops["wqkv"][0].data_ptr(), ops["bqkv"][0].data_ptr(), qkv.data_ptr(),
             out.data_ptr(), B, Cp, Hp, Wp, D, *ws, num_heads, int(mode == "vec"),
             _lib.stream(x5))
    _lib.check(err, f"attn5d_direct[{mode}]")
    return out
