#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``aurora_tpu_torch``) on one NVIDIA H100.

Phases, each printing one JSON line; any failure raises and the script exits non-zero:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: every ``aurora_tpu_torch/csrc/*.cu`` with ``nvcc`` for ``sm_90a``;
3. one phase per kernel and mode at the shapes its path gives it (the backbone's routes
   for K1-K8, the probe tools' sweeps for K9-K13, the level aggregation for K4 with
   ``ln_k``): the kernel
   against its plain PyTorch version on the same inputs, with CUDA-event times of the
   kernel, the plain version and the library call where one computes the same function
   (``torch.roll`` for K1, ``F.scaled_dot_product_attention`` with the -100/0 mask for
   K7, ``torch.matmul`` for K12), median of 10 runs after warm-up, and the bound
   max(flops / peak, bytes / 3.35 TB/s). Roll (both signs of the shift) and the
   shared-memory probe must be exact. K2-K6 with their tail and K9 add a
   branch to a residual (``x + LN(.) * scale + shift``) and round the sum to bf16; their
   error is the largest ``|kernel - plain|`` less one bf16 ulp of the output (the two may
   round one f32 value apart), over the largest ``|plain - residual|``, the branch's size:
   block 6e-3, perceiver core 1e-2. The branch gets unit gain (FiLM scale N(0, 1) in the
   backbone, LayerNorm weight ~1 in the perceiver), so it is as large as the residual and
   its error is not hidden under the residual's rounding. Outputs with no residual (K2
   and K6 without the tail, K7, K8): max ``|kernel - plain|`` over max ``|plain|``, 6e-3.
   K10-K12 ("rel_ulp"): the same less one bf16 ulp of the output, 6e-3, since one ulp of an
   output in the largest binade is up to 7.8e-3 of the maximum (K11 equals K2 without tail
   bit for bit and is 7.2e-3 from its plain version at stage 3). K11 is also held to K2
   without tail on the same input;
4. end to end, once per route: the main route (``attention_impl``, ``mlp_impl`` auto, auto),
   then W (pallas_windowed, fused), P (pallas, pallas), X (xla, fused) and S (the main
   route with ``stabilise_level_agg=True``: K4 with ``ln_k``).
   Each runs the 1.3 B production config (LoRA, bf16 backbone stored in bf16, bf16
   (de-)aggregation values) at full width and depth with the same seeded random weights,
   FiLM and LoRA gates opened, ``rollout`` over the 721 x 1440 / 13-level batch; per-step
   time, peak memory, per-step launch counts (counts set to 0 just before the roll-out)
   checked against the code; outputs finite and of the right shape; then the same weights
   on a 121 x 240 grid against the port's own CPU run of the same route as the reference;
5. tools: the probe tools as a user runs them, in process, at the full 0.25 degree token
   grid: ``backbone_ablate`` with every variant, ``gemm_probe`` and ``smem_probe`` (counts
   set to 0 just before); K9-K13 must each have launched, and the backbones under
   ``attention_impl`` "pallas" and "pallas_windowed" must agree within the bf16 block bound;
6. the kernels summary line, one entry per kernel (K1-K8: times per forward step, each
   shape's time times its launches per step on the route that runs it, ``launches`` the
   count over that route's roll-out; K9-K13: the sum over one sweep of the tool's cases,
   ``launches`` the count over the tools phase; K2 and K6 carry their no-tail mode under
   ``no_tail``, K4 its ``ln_k`` form under ``ln_k``), the ``nvidia-smi`` line, and the last
   line ``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py``. It needs one card, and exits
non-zero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from datetime import datetime

import numpy as np

STEPS = 2  # roll-out steps of the end-to-end phase
REPS = 10  # timed runs per kernel and shape, after 2 warm-up runs
LEVELS = (50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000)
SURF, STATIC, ATMOS = ("2t", "10u", "10v", "msl"), ("lsm", "z", "slt"), ("z", "u", "v", "t", "q")
TOL = {
    "roll3d": 0.0, "window_attention": 6e-3, "mlp_adaln_residual": 6e-3, "perceiver_core": 1e-2,
    "linear_adaln_residual": 6e-3, "window_attention_windowed": 6e-3, "sdpa_windows": 6e-3,
    "mlp_fused": 6e-3, "mlp_t": 6e-3, "attn_probe": 6e-3, "attn5d_direct": 6e-3,
    "gemm_blocked": 6e-3, "smem_probe": 0.0,
}
ATTN_SRC = "aurora_tpu_torch/csrc/window_attention.cu"
PROBES_SRC = "aurora_tpu_torch/csrc/probes.cu"
SOURCES = {
    "roll3d": ("aurora_tpu_torch/csrc/roll.cu", "aurora_tpu/ops/roll.py:30"),
    "window_attention": (ATTN_SRC, "aurora_tpu/model/swin3d.py:810"),
    "mlp_adaln_residual": ("aurora_tpu_torch/csrc/mlp.cu", "aurora_tpu/ops/mlp.py:318"),
    "perceiver_core": ("aurora_tpu_torch/csrc/resampler.cu", "aurora_tpu/ops/resampler.py:77"),
    "linear_adaln_residual": ("aurora_tpu_torch/csrc/mlp.cu", "aurora_tpu/ops/mlp.py:539"),
    "window_attention_windowed": (ATTN_SRC, "aurora_tpu/model/swin3d.py:686"),
    "sdpa_windows": (ATTN_SRC, "aurora_tpu/model/swin3d.py:599"),
    "mlp_fused": ("aurora_tpu_torch/csrc/mlp.cu", "aurora_tpu/ops/mlp.py:205"),
    "mlp_t": (PROBES_SRC, "tools/backbone_ablate.py:429"),
    "attn_probe": (PROBES_SRC, "tools/backbone_ablate.py:508"),
    "attn5d_direct": (PROBES_SRC, "tools/backbone_ablate.py:818"),
    "gemm_blocked": (PROBES_SRC, "tools/gemm_probe.py:92"),
    "smem_probe": (PROBES_SRC, "tools/vmem_probe.py:19"),
}
# Launches per forward step of each backbone route, from the code: 48 Swin blocks (stage
# depths 6+6, 10+10, 8+8), the odd-index half shifted (two rolls each) on every route; one
# attention kernel per block (K2, K6, or K5 after the plain attention of "xla"); one MLP
# kernel per block (K3, or K8 under mlp_impl "pallas"); K3 in the two perceiver MLP
# halves and K4 in the aggregation and de-aggregation cores on every route. Under
# stabilise_level_agg the aggregation's K4 takes one launch more, counted on its own: the
# statistics of k for ln_k.
_ALWAYS = {"roll3d": 48, "perceiver_core": 2}
_MAIN = {**_ALWAYS, "window_attention": 48, "mlp_adaln_residual": 50}
ROUTES = {  # name: (config knobs, launches per step of the kernels it runs)
    "main": (dict(attention_impl="auto", mlp_impl="auto"), _MAIN),
    "W": (dict(attention_impl="pallas_windowed", mlp_impl="fused"),
          {**_ALWAYS, "window_attention_windowed": 48, "mlp_adaln_residual": 50}),
    "P": (dict(attention_impl="pallas", mlp_impl="pallas"),
          {**_ALWAYS, "window_attention": 48, "mlp_fused": 48, "mlp_adaln_residual": 2}),
    "X": (dict(attention_impl="xla", mlp_impl="fused"),
          {**_ALWAYS, "linear_adaln_residual": 48, "mlp_adaln_residual": 50}),
    "S": (dict(attention_impl="auto", mlp_impl="auto", stabilise_level_agg=True),
          {**_MAIN, "perceiver_k_stats": 1}),
}
TOOL_KERNELS = ("mlp_t", "attn_probe", "attn5d_direct", "gemm_blocked", "smem_probe")
# The route whose roll-out gives a kernel's launches and per-step weights in the summary
# (K7 runs on no route: its times are weighted as if it ran once per block). K9-K13 run in
# the tools phase.
HOME = {"roll3d": "main", "window_attention": "main", "mlp_adaln_residual": "main",
        "perceiver_core": "main", "linear_adaln_residual": "X", "window_attention_windowed": "W",
        "sdpa_windows": None, "mlp_fused": "P", **dict.fromkeys(TOOL_KERNELS, "tools")}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def cuda_ms(fn, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(REPS):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


# ------------------------------------------------------------------------------ kernels


def case(name, label, per_step, kernel, plain, bound, check, residual=None, library=None,
         mode=None, also=None) -> dict:
    return dict(name=name, label=label, per_step=per_step, kernel=kernel, plain=plain,
                bound=bound, check=check, residual=residual, library=library, mode=mode,
                also=also)


def kernel_cases():
    """One dict per kernel, mode and shape: name, label, mode (K2/K6: "tail" or "no tail",
    K4: None or "ln_k"), launches per step on the route that runs it (1 per case of a
    tool's sweep), the kernel, its plain version and the library call (callables), the
    check ("exact", "branch" with the residual its output adds a branch to, "rel", or
    "rel_ulp": "branch" with a zero residual), the bound, and for K11 a second reference (``also``: K2 without tail)."""
    import torch
    import torch.nn.functional as F

    from aurora_tpu_torch.ops import mlp, probes, resampler, roll, window_attention
    from aurora_tpu_torch.ops.masks import bias_from_groups, group_ids_tensor, window_group_ids
    from aurora_tpu_torch.tools import bound_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rn(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

    stages = [  # (C, H, W, D, heads, blocks per step)
        (4, 180, 360, 512, 8, 12),
        (4, 90, 180, 1024, 16, 20),
        (4, 45, 90, 2048, 32, 16),
    ]
    ws, ss = (2, 6, 12), (1, 3, 6)
    for C, H, W, D, heads, nblk in stages:
        x = rn(1, C, H, W, D)
        nb = 2 * x.numel() * 2
        # A shifted block rolls by -ss before its attention and by +ss after it.
        for shifts in ((-ss[0], -ss[1], -ss[2]), ss):
            yield case(
                "roll3d", f"(1,{C},{H},{W},{D}) shifts {shifts}", nblk // 2,
                kernel=lambda x=x, s=shifts: roll.roll3d(x, s),
                plain=lambda x=x, s=shifts: roll.roll3d_plain(x, s),
                library=lambda x=x, s=shifts: torch.roll(x, s, dims=(1, 2, 3)),
                check="exact", bound=bound_ms(nbytes=nb),
            )
        del x
        Hp, Wp = H + (-H) % ws[1], W + (-W) % ws[2]
        xp = rn(1, C, Hp, Wp, D)
        M = C * Hp * Wp
        nW, N, dh = M // 144, 144, D // heads
        xw = rn(1, nW, N, D)
        wqkv, bqkv = rn(D, 3 * D, std=0.02), rn(3 * D, std=0.02)
        # FiLM: shift N(0, 0.1), scale N(0, 1).
        tail = (rn(D, D, std=0.02), rn(D, std=0.02, dtype=torch.float32),
                rn(1, D, std=0.1, dtype=torch.float32), rn(1, D, dtype=torch.float32))
        fl_attn = 2 * M * D * 3 * D + 4 * nW * heads * N * N * dh
        fl_proj = 2 * M * D * D
        # Shifted blocks mask by group id; unshifted ones have no mask, pad tokens included.
        for groups in (window_group_ids(C, H, W, ws, ss), None):
            kind = "masked" if groups is not None else "unmasked"
            for t in (tail, None):
                mode = "tail" if t is not None else "no tail"
                fl = fl_attn + (fl_proj if t is not None else 0)
                nb = 2 * M * D * 2 + (4 if t is not None else 3) * D * D * 2
                kw = dict(mode=mode, check="branch" if t is not None else "rel",
                          bound=bound_ms(flops_bf16=fl, nbytes=nb))
                # K2 with the tail runs on the main route, without it on route P; K6 with
                # the tail on route W, without it under (pallas_windowed, pallas/xla).
                yield case(
                    "window_attention", f"(1,{C},{Hp},{Wp},{D}) heads {heads}, {kind}, {mode}",
                    nblk // 2, residual=xp,
                    kernel=lambda xp=xp, gr=groups, h=heads, t=t:
                        window_attention.window_attention_tail(xp, wqkv, bqkv, gr, ws, h, t),
                    plain=lambda xp=xp, gr=groups, h=heads, t=t:
                        window_attention.window_attention_tail_plain(xp, wqkv, bqkv, gr, ws, h, t),
                    **kw,
                )
                yield case(
                    "window_attention_windowed",
                    f"(1,{nW},{N},{D}) heads {heads}, {kind}, {mode}", nblk // 2, residual=xw,
                    kernel=lambda xw=xw, gr=groups, h=heads, t=t:
                        window_attention.window_attention_windowed(xw, wqkv, bqkv, gr, h, t),
                    plain=lambda xw=xw, gr=groups, h=heads, t=t:
                        window_attention.window_attention_windowed_plain(
                            xw, wqkv, bqkv, gr, h, t),
                    **kw,
                )
            # K7 on packed qkv; the library yardstick is SDPA on the same q, k, v (views
            # (nW, heads, N, dh) of the packed rows) with the same -100/0 mask.
            qkv = rn(1, nW, N, 3 * D)
            q, k, v = (t.contiguous() for t in
                       qkv.view(nW, N, 3, heads, dh).permute(2, 0, 3, 1, 4).unbind(0))
            mask = None
            if groups is not None:
                mask = bias_from_groups(group_ids_tensor(groups, dev), bf)[:, None]
            yield case(
                "sdpa_windows", f"(1,{nW},{N},{3 * D}) heads {heads}, {kind}", nblk // 2,
                kernel=lambda qkv=qkv, gr=groups, h=heads:
                    window_attention.sdpa_windows(qkv, gr, h),
                plain=lambda qkv=qkv, gr=groups, h=heads:
                    window_attention.sdpa_windows_plain(qkv, gr, h),
                library=lambda q=q, k=k, v=v, m=mask:
                    F.scaled_dot_product_attention(q, k, v, attn_mask=m),
                check="rel",
                bound=bound_ms(flops_bf16=4 * nW * heads * N * N * dh, nbytes=4 * M * D * 2),
            )
        del xp, xw, qkv, q, k, v
        rows = C * H * W
        film = (rn(1, D, std=0.1, dtype=torch.float32), rn(1, D, dtype=torch.float32))
        yield mlp_case(rn, f"backbone ({rows},{D})", rows, D, 4 * D, nblk, film)
        # K8 (route P) and K5 (route X) at the same rows.
        xr = rn(1, rows, D)
        w8 = (rn(D, 4 * D, std=0.02), rn(4 * D, std=0.02, dtype=torch.float32),
              rn(4 * D, D, std=0.02), rn(D, std=0.02, dtype=torch.float32))
        yield case(
            "mlp_fused", f"backbone ({rows},{D}), hidden {4 * D}", nblk,
            kernel=lambda xr=xr, w=w8: mlp.mlp_fused(xr, *w),
            plain=lambda xr=xr, w=w8: mlp.mlp_fused_plain(xr, *w), check="rel",
            bound=bound_ms(flops_bf16=16 * rows * D * D, nbytes=2 * rows * D * 2 + 16 * D * D),
        )
        sc = rn(1, rows, D)
        w5 = (rn(D, D, std=0.02), rn(D, std=0.02, dtype=torch.float32))
        yield case(
            "linear_adaln_residual", f"({rows},{D})", nblk, residual=sc,
            kernel=lambda xr=xr, sc=sc, w=w5, f=film: mlp.linear_adaln_residual(xr, *w, sc, *f),
            plain=lambda xr=xr, sc=sc, w=w5, f=film:
                mlp.linear_adaln_residual_plain(xr, *w, sc, *f),
            check="branch",
            bound=bound_ms(flops_bf16=2 * rows * D * D, nbytes=3 * rows * D * 2 + D * D * 2),
        )
        del xr, sc
    for label, rows, D in (("agg", 64800 * 3, 512), ("de-agg", 64800 * 13, 1024)):
        # LayerNorm affine in the FiLM slot: bias ~0, weight ~1.
        ln2 = (rn(1, D, std=0.1, dtype=torch.float32), 1 + rn(1, D, std=0.1, dtype=torch.float32))
        yield mlp_case(rn, f"perceiver {label} ({rows},{D})", rows, D, 2048, 1, ln2)
    for label, K, D, h, Q in (("agg", 13, 512, 16, 3), ("de-agg", 3, 1024, 16, 13)):
        M, inner, dh = 64800, D, D // h
        a = dict(
            ctx=rn(K, M, D, dtype=torch.float32), wk=rn(D, inner, std=0.05, dtype=torch.float32),
            wv=rn(D, inner, std=0.05, dtype=torch.float32), qh=rn(Q, h, dh, dtype=torch.float32),
            wout=rn(inner, D, std=0.05, dtype=torch.float32),
            ln1_w=1 + rn(D, std=0.1, dtype=torch.float32),
            ln1_b=rn(D, std=0.1, dtype=torch.float32),
            queries=rn(Q, D, dtype=torch.float32),
        )
        kw = dict(scale=dh**-0.5, value_bf16=True)
        f32 = 2 * K * M * D * inner + 2 * K * M * Q * inner
        b16 = 2 * K * M * D * inner + 2 * M * Q * inner * D
        nb = K * M * D * 4 + M * Q * D * 2 + D * inner * 6 + inner * D * 2
        yield case(
            "perceiver_core", f"{label} ctx ({K},{M},{D}) Q {Q}", 1,
            kernel=lambda a=a, kw=kw: resampler.perceiver_core(**a, **kw),
            plain=lambda a=a, kw=kw: resampler.perceiver_core_plain(**a, **kw),
            check="branch", residual=a["queries"][None],
            bound=bound_ms(flops_bf16=b16, flops_f32=f32, nbytes=nb),
        )
        if label == "agg":
            # K4 with ln_k (stabilise_level_agg): the aggregation only. The LayerNorm of k
            # adds ~8 f32 operations per value of k to the function's work.
            lnk = (1 + rn(inner, std=0.1, dtype=torch.float32),
                   rn(inner, std=0.1, dtype=torch.float32))
            yield case(
                "perceiver_core", f"{label} ctx ({K},{M},{D}) Q {Q}, ln_k", 1, mode="ln_k",
                kernel=lambda a=a, kw=kw, lnk=lnk: resampler.perceiver_core(**a, **kw, lnk=lnk),
                plain=lambda a=a, kw=kw, lnk=lnk:
                    resampler.perceiver_core_plain(**a, **kw, lnk=lnk),
                check="branch", residual=a["queries"][None],
                bound=bound_ms(flops_bf16=b16, flops_f32=f32 + 8 * K * M * inner, nbytes=nb),
            )
        del a
    yield from probe_cases(rn)


def probe_cases(rn):
    """The cases of the probe kernels K9-K13, at the shapes the tools sweep."""
    import torch

    from aurora_tpu_torch.ops import probes, window_attention
    from aurora_tpu_torch.tools import bound_ms
    from aurora_tpu_torch.tools.gemm_probe import FC2, PROJ
    from aurora_tpu_torch.tools.smem_probe import SWEEP_KIB

    f32 = torch.float32
    ws, N = (2, 6, 12), 144
    stages = [(4, 180, 360, 512, 8), (4, 90, 180, 1024, 16), (4, 45, 90, 2048, 32)]
    for C, H, W, D, heads in stages:
        # K9 at unit gain (sc N(0, 1)), every row block R of the tool that divides L.
        L, Hd = C * H * W, 4 * D
        x = rn(L, D)
        a = (x, rn(D, Hd, std=0.02), rn(Hd, 1, std=0.02, dtype=f32), rn(Hd, D, std=0.02),
             rn(D, 1, std=0.02, dtype=f32), rn(D, 1, std=0.1, dtype=f32), rn(D, 1, dtype=f32))
        for R in (1800, 3600, 5400):
            if L % R:
                continue
            yield case(
                "mlp_t", f"({L},{D}) R {R}, {L // R} blocks", 1, residual=x,
                kernel=lambda a=a, R=R: probes.mlp_t(*a, R),
                plain=lambda a=a: probes.mlp_t_plain(*a), check="branch",
                bound=bound_ms(flops_bf16=4 * L * D * Hd, nbytes=2 * L * D * 2 + 2 * D * Hd * 2),
            )
        del x, a
        # K11 on the padded grid, against its plain version and K2 without tail.
        Hp, Wp = H + (-H) % ws[1], W + (-W) % ws[2]
        nW = C * Hp * Wp // N
        x5, wqkv, bqkv = rn(1, C, Hp, Wp, D), rn(D, 3 * D, std=0.02), rn(3 * D, std=0.02)
        fl = 2 * nW * N * D * 3 * D + 4 * nW * N * N * D
        for mode in probes.ATTN5D_MODES:
            yield case(
                "attn5d_direct", f"(1,{C},{Hp},{Wp},{D}) heads {heads}, {mode}", 1,
                kernel=lambda x5=x5, w=wqkv, b=bqkv, h=heads, m=mode:
                    probes.attn5d_direct(x5, w, b, ws, h, m),
                plain=lambda x5=x5, w=wqkv, b=bqkv, h=heads, m=mode:
                    probes.attn5d_direct_plain(x5, w, b, ws, h, m),
                also=lambda x5=x5, w=wqkv, b=bqkv, h=heads:
                    window_attention.window_attention_tail(x5, w, b, None, ws, h, None),
                check="rel_ulp",
                bound=bound_ms(flops_bf16=fl, nbytes=2 * nW * N * D * 2 + 3 * D * D * 2),
            )
        del x5
    # K10: the seven modes at the stage-1 shape.
    nW, D, heads = 1800, 512, 8
    xw, wqkv, bqkv = rn(1, nW, N, D), rn(D, 3 * D, std=0.02), rn(1, 3 * D, std=0.02)
    proj, core = 2 * nW * N * D * 3 * D, 4 * nW * N * N * D
    for mode in probes.ATTN_PROBE_MODES:
        yield case(
            "attn_probe", f"(1,{nW},{N},{D}) heads {heads}, {mode}", 1,
            kernel=lambda m=mode: probes.attn_probe(xw, wqkv, bqkv, heads, m),
            plain=lambda m=mode: probes.attn_probe_plain(xw, wqkv, bqkv, heads, m),
            check="rel_ulp",
            bound=bound_ms(flops_bf16=proj + (0 if mode == "no_core" else core),
                           nbytes=2 * nW * N * D * 2 + 3 * D * D * 2),
        )
    del xw
    # K12: the proj and fc2 shapes under every row block of the tool; cuBLAS beside it.
    for name, (M, K, Nn, blocks) in (("proj", PROJ), ("fc2", FC2)):
        a, w = rn(M, K), rn(K, Nn, std=0.02)
        for MB in blocks:
            if M % MB:  # as the tool: 512 and 1024 do not divide 259200
                continue
            yield case(
                "gemm_blocked", f"{name} ({M},{K})x({K},{Nn}) MB {MB}, {M // MB} blocks", 1,
                kernel=lambda a=a, w=w, MB=MB: probes.gemm_blocked(a, w, MB),
                plain=lambda a=a, w=w: probes.gemm_blocked_plain(a, w),
                library=lambda a=a, w=w: torch.matmul(a, w), check="rel_ulp",
                bound=bound_ms(flops_bf16=2 * M * K * Nn, nbytes=2 * (M * K + K * Nn + M * Nn)),
            )
        del a, w
    # K13 with the largest scratch of the tool's sweep that the card's opt-in maximum allows.
    x = rn(8, 128, dtype=f32)
    nbytes = max(k * 1024 for k in SWEEP_KIB if k * 1024 <= probes.smem_optin_bytes())
    yield case(
        "smem_probe", f"(8,128) f32, {nbytes} bytes of shared memory", 1,
        kernel=lambda: probes.smem_probe(x, nbytes), plain=lambda: probes.smem_probe_plain(x),
        check="exact", bound=bound_ms(nbytes=2 * x.numel() * 4),
    )


def mlp_case(rn, label, rows, D, Hd, per_step, shift_scale):
    """Both callers pass scale_bias = 0: the blocks' FiLM and the perceiver's LN affine."""
    import torch

    from aurora_tpu_torch.ops import mlp
    from aurora_tpu_torch.tools import bound_ms

    x = rn(1, rows, D)
    a = (
        rn(D, Hd, std=0.02), rn(Hd, std=0.02, dtype=torch.float32), rn(Hd, D, std=0.02),
        rn(D, std=0.02, dtype=torch.float32), *shift_scale,
    )
    fl = 4 * rows * D * Hd
    nb = 2 * rows * D * 2 + 2 * D * Hd * 2
    return case(
        "mlp_adaln_residual", label, per_step,
        kernel=lambda: mlp.mlp_adaln_residual(x, *a),
        plain=lambda: mlp.mlp_adaln_residual_plain(x, *a),
        check="branch", residual=x, bound=bound_ms(flops_bf16=fl, nbytes=nb),
    )


def _totals() -> dict:
    return dict(max_abs_err=0.0, err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None,
                by={"bytes": 0.0, "operations": 0.0})


def run_kernel_phases() -> dict:
    """Check and time every case; returns per-step totals keyed by (name, mode)."""
    import torch

    from aurora_tpu_torch.tools import branch_err, rel_err

    summary: dict = {}
    for case in kernel_cases():
        name = case["name"]
        got = case["kernel"]()
        want = case["plain"]()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name} {case['label']}: {got.shape}/{got.dtype} vs "
                                 f"{want.shape}/{want.dtype}")
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name} {case['label']}: non-finite output")
        if case["check"] == "exact":
            err, rel = (got.float() - want.float()).abs().max().item(), None
            ok = torch.equal(got, want)
        else:
            if case["check"] == "branch":
                err, rel = branch_err(got, want, case["residual"])
            elif case["check"] == "rel_ulp":
                err, rel = branch_err(got, want, torch.zeros((), device=got.device))
            else:
                err = (got.float() - want.float()).abs().max().item()
                rel = rel_err(got, want)
            ok = rel <= TOL[name]
        vs_also = None
        if case["also"] is not None:
            vs_also = branch_err(got, case["also"](), torch.zeros((), device=got.device))[1]
            ok = ok and vs_also <= TOL[name]
        del got, want
        ms = cuda_ms(case["kernel"])
        plain_ms = cuda_ms(case["plain"])
        lib_ms = cuda_ms(case["library"]) if case["library"] else None
        b, by = case["bound"]
        emit(dict(phase="kernel", kernel=name, mode=case["mode"], shape=case["label"],
                  ok=bool(ok), max_abs_err=err, rel_err=rel, check=case["check"],
                  tol=TOL[name], ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b,
                  bound_by=by, per_step=case["per_step"],
                  **({} if vs_also is None else {"vs_k2_no_tail": vs_also})))
        if not ok:
            raise AssertionError(f"{name} {case['label']}: max abs err {err}, relative error "
                                 f"{rel} (bound {TOL[name]})")
        s = summary.setdefault((name, case["mode"]), _totals())
        n = case["per_step"]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["err"] = max(s["err"], rel or 0.0)
        s["ms"] += n * ms
        s["plain_ms"] += n * plain_ms
        s["bound_ms"] += n * b
        if lib_ms is not None:
            s["library_ms"] = (s["library_ms"] or 0.0) + n * lib_ms
        s["by"][by] += n * b
        torch.cuda.empty_cache()
    return summary


# ------------------------------------------------------------------------------ end to end


def numpy_batch(H: int, W: int, seed: int = 0):
    from aurora_tpu_torch import Batch, Metadata

    rng = np.random.default_rng(seed)
    return Batch(
        surf_vars={k: rng.standard_normal((1, 2, H, W)).astype(np.float32) for k in SURF},
        static_vars={k: np.abs(rng.standard_normal((H, W))).astype(np.float32) for k in STATIC},
        atmos_vars={
            k: rng.standard_normal((1, 2, len(LEVELS), H, W)).astype(np.float32) for k in ATMOS
        },
        metadata=Metadata(
            lat=np.linspace(90, -90, H), lon=np.linspace(0, 360, W, endpoint=False),
            time=(datetime(2020, 6, 1, 12),), atmos_levels=LEVELS,
        ),
    )


def open_gates(model, seed: int = 1, std: float = 0.05) -> None:
    """Seeded noise in every FiLM modulation weight and LoRA B: at fresh init both are zero
    and every Swin block is an identity, so the kernels would never reach the output."""
    import torch

    g = torch.Generator(device=model.device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ("modulation" in name and name.endswith("weight")) or name.endswith(".B"):
                p.copy_(torch.randn(p.shape, generator=g, device=p.device) * std)


def run_route(name: str, steps: int, ref_grid: tuple[int, int]) -> dict:
    """The roll-out of one backbone route; returns the launches over it."""
    import torch

    from aurora_tpu_torch import LARGE_CONFIG, Aurora, cast_backbone_params, rollout
    from aurora_tpu_torch.ops import _lib

    knobs, counts = ROUTES[name]
    expected = {k: counts.get(k, 0) for k in _lib.LAUNCHES}
    cfg = LARGE_CONFIG.replace(use_lora=True, autocast=True, agg_bf16=True, deagg_bf16=True,
                               **knobs)
    t0 = time.perf_counter()
    model = Aurora(cfg, device="cuda", seed=0)
    open_gates(model)
    cast_backbone_params(model)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    init_s = time.perf_counter() - t0
    batch = numpy_batch(721, 1440)

    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    step_s, per_step = [], []
    preds = []
    t_prev = time.perf_counter()
    before = dict(_lib.LAUNCHES)
    for pred in rollout(model, batch, steps=steps):
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_s.append(now - t_prev)
        per_step.append({k: _lib.LAUNCHES[k] - before[k] for k in _lib.LAUNCHES})
        before = dict(_lib.LAUNCHES)
        preds.append(pred)
        t_prev = now
    launches = dict(_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for i, got in enumerate(per_step):
        if got != expected:
            raise AssertionError(f"route {name} step {i}: launches {got} != {expected}")
    for i, pred in enumerate(preds):
        for k, v in {**pred.surf_vars, **pred.atmos_vars}.items():
            want = (1, 1, 720, 1440) if k in pred.surf_vars else (1, 1, len(LEVELS), 720, 1440)
            if tuple(v.shape) != want or v.dtype != torch.float32:
                raise AssertionError(f"route {name} step {i} {k}: {tuple(v.shape)} {v.dtype}")
            if not torch.isfinite(v).all():
                raise AssertionError(f"route {name} step {i} {k}: non-finite values")
        if pred.metadata.rollout_step != i + 1:
            raise AssertionError("roll-out step not advanced")
    del preds
    emit(dict(phase="end_to_end", route=name, **knobs,
              grid="721x1440 (720x1440 after crop)", levels=13, params=n_params, init_s=init_s,
              steps=steps, step_s=step_s, peak_mem_gib=peak / 2**30,
              launches_per_step=per_step[-1], launches=launches))

    # Reference on a small input: the same weights on the port's CPU run of the same route.
    H, W = ref_grid
    small = numpy_batch(H, W, seed=1)
    got = model(small)
    torch.cuda.synchronize()
    cpu = model.to("cpu")
    del model
    torch.cuda.empty_cache()
    want = cpu(small)
    errs = {}
    for k in SURF:
        errs[k] = _mean_rel(got.surf_vars[k], want.surf_vars[k])
    for k in ATMOS:
        errs[k] = _mean_rel(got.atmos_vars[k], want.atmos_vars[k])
    worst = max(errs.values())
    emit(dict(phase="reference", route=name, grid=f"{H}x{W}",
              against="port CPU route (plain versions)", mean_rel=errs, worst=worst, tol=1e-2))
    if not worst <= 1e-2:
        raise AssertionError(f"route {name}: card vs CPU route: mean rel {worst} > 1e-2")
    return launches


def _mean_rel(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).abs().mean() / (b.abs().mean() + 1e-30)).item()


# ------------------------------------------------------------------------------ tools


def run_tools() -> dict:
    """The probe tools as a user runs them, in process; returns the launches over them."""
    from aurora_tpu_torch.ops import _lib
    from aurora_tpu_torch.tools import backbone_ablate, gemm_probe, smem_probe

    _lib.reset_launches()
    t0 = time.perf_counter()
    ablate = backbone_ablate.main(["--variants", ",".join(backbone_ablate.VARIANTS)])
    gemm = gemm_probe.main([])
    smem = smem_probe.main([])
    launches = dict(_lib.LAUNCHES)
    # cuBLAS alone per forward step: each stage's GEMM time times its blocks per step.
    blocks = {0: 12, 1: 20, 2: 16}
    g = {(r["stage"], r["gemm"]): r["ms"] for r in ablate if "gemm" in r}
    per_step = {
        combo: sum(blocks[st] * sum(g[st, n] for n in combo.split("+")) for st in blocks)
        for combo in ("qkv+proj", "fc1+fc2", "proj")
    }
    check = next(r for r in ablate if r["label"] == "attn5d_check")
    # The tools have printed one line per result; this line keeps what later phases read.
    emit(dict(phase="tools", seconds=time.perf_counter() - t0, launches=launches,
              cublas_gemms_ms_per_step=per_step, attn5d_check=check,
              results=dict(backbone_ablate=len(ablate), gemm_probe=len(gemm),
                           smem_probe=len(smem)), smem_probe=smem[-1]))
    missing = [k for k in TOOL_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"tools: kernels never launched: {missing}")
    # The two attention routes are one body with two row addressings; a bf16 block is held
    # to 2e-2 between routes (tests/test_torch_routes.py).
    if not check["rel_delta"] <= 2e-2:
        raise AssertionError(f"attn5d_check: pallas vs pallas_windowed differ by {check}")
    return launches


# ------------------------------------------------------------------------------ main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on the card only")
        return 1
    from aurora_tpu_torch.ops import _lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit(dict(phase="device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
              name=torch.cuda.get_device_name(0), count=torch.cuda.device_count()))

    secs = _lib.build(force=True)
    ptxas = {}
    for n in _lib.SOURCES:
        lines = (_lib.BUILD_DIR / f"lib{n}.ptxas.txt").read_text().splitlines()
        ptxas[n] = [ln.strip() for ln in lines if "registers" in ln or "spill" in ln]
    emit(dict(phase="build", seconds=secs, ptxas=ptxas))

    summary = run_kernel_phases()
    launches = {}
    for route in ROUTES:
        launches[route] = run_route(route, STEPS, (121, 240))
        missing = [k for k, n in ROUTES[route][1].items() if launches[route][k] == 0]
        if missing:
            raise AssertionError(f"route {route}: kernels never launched: {missing}")
    launches["tools"] = run_tools()

    def entry(s: dict, n_launches: int) -> dict:
        return dict(launches=n_launches, max_abs_err=s["max_abs_err"], err=s["err"],
                    ms=s["ms"], plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
                    bound_by=max(s["by"], key=s["by"].get), library_ms=s["library_ms"])

    kernels = []
    for name in TOL:
        src, replaces = SOURCES[name]
        home = HOME[name]
        main_mode = "tail" if (name, "tail") in summary else None
        e = dict(name=name, ok=True, route="cuda", source=src, replaces=replaces,
                 home_route=home, **entry(summary[name, main_mode],
                                          launches[home][name] if home else 0))
        if (name, "no tail") in summary:
            # K2 without the tail runs on route P; K6 without it on no route driven here.
            n = launches["P"][name] if name == "window_attention" else 0
            e["no_tail"] = entry(summary[name, "no tail"], n)
        if (name, "ln_k") in summary:
            # K4 with ln_k runs in route S's aggregation: once per statistics launch.
            e["ln_k"] = entry(summary[name, "ln_k"], launches["S"]["perceiver_k_stats"])
        kernels.append(e)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
