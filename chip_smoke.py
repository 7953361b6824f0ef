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
   max(flops / peak, bytes / 3.35 TB/s) (K4: of the folded work its kernels do, with the
   bound of the TPU kernel's work beside it). Roll (both signs of the shift) and the
   shared-memory probe must be exact. K2-K6 with their tail and K9 add a
   branch to a residual (``x + LN(.) * scale + shift``) and round the sum to bf16; their
   error is the largest ``|kernel - plain|`` less one bf16 ulp of the output (the two may
   round one f32 value apart), over the largest ``|plain - residual|``, the branch's size:
   block 6e-3, perceiver core 1e-2. The branch gets unit gain (FiLM scale N(0, 1) in the
   backbone, LayerNorm weight ~1 in the perceiver), so it is as large as the residual and
   its error is not hidden under the residual's rounding. Outputs with no residual (K2
   and K6 without the tail, K7, K8): max ``|kernel - plain|`` over max ``|plain|``, 6e-3.
   K10-K12 ("rel_ulp"): the same less one bf16 ulp of the output, 6e-3, since one ulp of an
   output in the largest binade is up to 7.8e-3 of the maximum. K11 runs K2 without tail's
   launches in two work orders: in both modes it must give K2 without tail's bits on the
   same input. K13's bound is the larger of its byte bound and an empty kernel's launch,
   timed the same way in the same run: no kernel takes less. K9 is also
   held to K3 at scale_bias 0 on the same inputs by the "branch" measure (6e-3; feature-major
   tiles sum in another order). K10's ``baseline`` must give K6 without tail's bits on the
   same windows, ``batched_heads`` ``baseline``'s and ``bf16_batched`` ``bf16_core``'s. K2 and K6
   are one function with two row addressings: K6 on ``window_partition(xp)``, reversed,
   must be K2's bits on ``xp`` (every K2 case, with and without the tail); a K2 and a K6
   case at the 121 x 240 grid's stage 1 (7200 = 112 x 64 + 32 rows) have a ragged last
   piece; K2 at stage 3, masked, must give the real tokens the same bits with garbage in
   the pad tokens. K2, K6, K3 and K8 are checked again on the output of their last timed
   run. K12's outputs under every row block of a shape must be
   the same bits (all of the tool's row blocks end in a ragged 64-row piece: 2160 = 33 x 64
   + 48, 3240 = 50 x 64 + 40, 540 = 8 x 64 + 28, 1080 = 16 x 64 + 56; an M = 3240 case per
   weight shape adds an odd number of pieces, whose last tile has one). K7 at stage 3, whose
   grid is padded to 48 x 96, must give the real tokens the same bits with garbage in the
   pad tokens' q, k and v. K4 also runs at the 121 x 240 grid's M = 1800 columns (a ragged
   last tile of rows; no count towards the sums);
4. end to end, once per route: the main route (``attention_impl``, ``mlp_impl`` auto, auto),
   then W (pallas_windowed, fused), P (pallas, pallas), X (xla, fused) and S (the main
   route with ``stabilise_level_agg=True``: K4 with ``ln_k``).
   Each runs the 1.3 B production config (LoRA, bf16 backbone stored in bf16, bf16
   (de-)aggregation values) at full width and depth with the same seeded random weights,
   FiLM and LoRA gates opened, ``rollout`` over the 721 x 1440 / 13-level batch; per-step
   time, peak memory, per-step launch counts (counts set to 0 just before the roll-out)
   checked against the code; outputs finite and of the right shape; then a 121 x 240 grid
   against the port's own CPU run of the same route: the route's model at two blocks per
   backbone stage (the second shifted), seeded on the card, whose reference run must launch
   every kernel of its route.
   After the main route's roll-out, the breakdown: ``perf_breakdown``, ``encoder_breakdown``
   and ``decoder_breakdown`` as a user runs them, in process, on the main route's model at
   720 x 1440 (one JSON line per row, with the launches of one call of its part); the level
   aggregation and de-aggregation must have launched K4 and K3, the backbone K1-K3. Then the
   roll-outs, on the same model, as ``tools.bench`` measures them: ``rollout``,
   ``rollout_scan`` and ``rollout_scan(host_offload=True)``, 4 steps each from one
   721 x 1440 batch of host arrays (step times, peak memory, steps per second, the idle share
   of two steady steps from ``torch.profiler``); launches per step as the main route's; the
   three the same bits step by step (or within 1e-3 mean relative); the host-offload peak
   within one prediction of a 2-step host-offload roll-out's; the caller's arrays unchanged.
   Then the drivers, on the same model: a 721 x 1440 initial condition written with
   ``Batch.to_netcdf`` (the land-sea mask 0 around the tracker's first fix), the
   command-line ``forecast`` (``aurora_tpu_torch.cli.main``, 2 steps, ``--track``) with its
   seconds split (reading, each step, each file's writing and bytes, the tracker), its files
   the same bits as ``rollout``'s predictions of the same model (or within 1e-3 mean
   relative) and its track the tracker's on the card's predictions and on their host copies;
   ``evaluate`` of step 2 against step 1 on the card (finite scores); ``Batch.regrid(1.0)``
   of a prediction with the native library built (one field through the scipy form beside
   it, within 1e-12); ``tools.rollout_bench`` at 3 steps; ``tools.train_speed_probe`` at
   121 x 240 over two arms;
5. train: K1-K8's gradients through their ``Function`` (the kernel forward, the backward
   of the plain math with bf16 products) against autograd of the plain versions on the card,
   every differentiable input, on inputs cut to a few thousand rows, windows or columns
   (FiLM at unit gain): max ``|Δ|`` over max ``|reference gradient|`` (at least 1e-3 of the
   call's largest, for a gradient that is zero in exact arithmetic), less one bf16 ulp for a
   bf16 gradient, within the forward's bounds (roll exact, bf16 6e-3, K4 1e-2), the output's
   autograd node the kernel's ``Function``; the backward's and plain autograd's times at the
   main path's shape, where the chunk plans cut into several chunks, and the last timed
   result of each held to the other by the same measure and bound. Then the production
   model's LoRA train step at 721 x 1440 as ``tools.train_bench`` runs it (``remat`` at the
   JAX recipe's scope "full"; a warm-up and 1 timed step) and a K = 2 roll-out train step
   with ``lora_mode="all"`` (2 updates): every
   LoRA parameter a finite, non-zero gradient and moved (in the roll-out each step's bank, bank
   0's gradient not bank 1's), every frozen parameter its bits, the losses finite, each
   step's launches as ``tools.train_bench.expected_launches`` derives them, peak memory under
   80 GB; the K = 2 roll-out at two blocks per backbone stage (its full-depth time is
   ``tools.rollout_train_bench``'s). Then the LoRA step's model with ``drop_path=0.2``, one
   step with a generator: its launches as ``expected_launches(stochastic=True)`` derives them
   (K1 in every shifted block, K2 and K3 only in the two blocks at rate 0), every LoRA
   parameter a finite gradient, non-zero and moved unless its block's attention branch was
   dropped (then exactly zero), peak under 80 GB. Then the model at two blocks per backbone
   stage, seeded on the card, one LoRA train step at 121 x 240 against the port's CPU run of
   it: loss within 1e-2 relative, the concatenated LoRA gradient within 5e-2 relative L2;
   again with ``drop_path=0.2, drop_rate=0.1`` and the masks drawn on the CPU for both runs
   (every block stochastic: K1, plain attention and MLP); then 10^4 Bernoulli draws on the
   card, the kept fraction within 5 binomial standard deviations;
6. tools: the probe tools as a user runs them, in process, at the full 0.25 degree token
   grid: ``backbone_ablate`` with every variant, ``gemm_probe`` and ``smem_probe`` (counts
   set to 0 just before); K9-K13 must each have launched, and the backbones under
   ``attention_impl`` "pallas" and "pallas_windowed" must agree within the bf16 block bound;
7. variants: the released models AirPollution (451 x 900, patch 3), Wave (721 x 1440),
   HighRes (1801 x 3600, patch 10) and 12h (721 x 1440), each at its full width, depth and
   grid with the production knobs. The weights are each released checkpoint's keys and
   shapes (``tests/data/ckpt_manifests.json``) filled with seeded values at the scale of the
   port's init (FiLM and LoRA ``B`` opened), loaded through the port's checkpoint code:
   AirPollution from a ``.ckpt`` file written with ``torch.save`` (``load_checkpoint_local``),
   the others in memory (``convert_reference_checkpoint``). Each rolls out 3 steps through
   ``tools.variant_bench`` / ``tools.highres_bench`` (12h through the same roll-out), counts
   set to 0 just before: step times, peak memory, launches per step checked against the code;
   the outputs are the user's variables after the hooks (no ``_mod``, sin/cos or density
   channel) at the right shapes, finite but for the wave model's NaN where it predicts no
   waves. Then the variant's own config, widths, hooks and grid at two blocks per backbone
   stage (the second shifted: it must launch K1 and K2), seeded on the card, on a reference
   grid (121 x 240; HighRes 241 x 480) against the port's CPU run of the same weights: mean
   relative error <= 1e-2 per output variable where both are finite,
   and the points where the wave NaN masks differ (a density within the card's error of 1/2)
   at most 5%. ``AuroraSmallPretrained`` (D = 256) must raise the kernels' ``ValueError``;
8. the seconds of each phase, then the kernels summary line, one entry per kernel (K1-K8:
   times per forward step, each shape's time times its launches per step on the route that
   runs it, ``launches`` the count over that route's roll-out, and the backward's
   ``grad_err`` (the worst over the cut shapes and ``bwd_shape``), ``bwd_ms``,
   ``plain_bwd_ms`` and ``bwd_rel_err`` (each input's error) at ``bwd_shape``, one call at
   the main path's shape; K9-K13: the sum over one sweep of the tool's cases,
   ``launches`` the count over the tools phase; K2 and K6 carry their no-tail mode under
   ``no_tail``, K4 its ``ln_k`` form under ``ln_k`` and the bound of the TPU kernel's work
   under ``bound_of_tpu_work_ms``), the ``nvidia-smi`` line, and the last
   line ``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py``. It needs one card, and exits
non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# Roll-out steps of the end-to-end and variants phases. ``rollout`` uploads the caller's
# history once, before the first step, so the second step is the first steady one.
STEPS = 3
# Roll-out steps of the rollout_scan phase, and of its short host-offload roll-out whose peak
# memory the full one's is held to.
SCAN_STEPS, SHORT_STEPS = 4, 2
# Bound on the mean relative difference between the three roll-outs if a kernel turns out
# not to give the same bits from run to run (they are expected to be equal).
SCAN_AGREE_TOL = 1e-3
REPS = 10  # timed runs per kernel and shape, after 2 warm-up runs
LEVELS = (50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000)
SURF, ATMOS = ("2t", "10u", "10v", "msl"), ("z", "u", "v", "t", "q")
TOL = {
    "roll3d": 0.0, "window_attention": 6e-3, "mlp_adaln_residual": 6e-3, "perceiver_core": 1e-2,
    "linear_adaln_residual": 6e-3, "window_attention_windowed": 6e-3, "sdpa_windows": 6e-3,
    "mlp_fused": 6e-3, "mlp_t": 6e-3, "attn_probe": 6e-3, "attn5d_direct": 6e-3,
    "gemm_blocked": 6e-3, "smem_probe": 0.0,
}
ATTN_SRC = "aurora_tpu_torch/csrc/window_attention.cu"
PROBES_SRC = "aurora_tpu_torch/csrc/probes.cu"
ATTN5D_SRC = "aurora_tpu_torch/csrc/attn5d_direct.cu"
MLP_T_SRC = "aurora_tpu_torch/csrc/mlp_t.cu"
ATTN_PROBE_SRC = "aurora_tpu_torch/csrc/attn_probe.cu"
SOURCES = {
    "roll3d": ("aurora_tpu_torch/csrc/roll.cu", "aurora_tpu/ops/roll.py:30"),
    "window_attention": (ATTN_SRC, "aurora_tpu/model/swin3d.py:810"),
    "mlp_adaln_residual": ("aurora_tpu_torch/csrc/mlp.cu", "aurora_tpu/ops/mlp.py:318"),
    "perceiver_core": ("aurora_tpu_torch/csrc/resampler.cu", "aurora_tpu/ops/resampler.py:77"),
    "linear_adaln_residual": ("aurora_tpu_torch/csrc/mlp.cu", "aurora_tpu/ops/mlp.py:539"),
    "window_attention_windowed": (ATTN_SRC, "aurora_tpu/model/swin3d.py:686"),
    "sdpa_windows": ("aurora_tpu_torch/csrc/sdpa.cu", "aurora_tpu/model/swin3d.py:599"),
    "mlp_fused": ("aurora_tpu_torch/csrc/mlp.cu", "aurora_tpu/ops/mlp.py:205"),
    "mlp_t": (MLP_T_SRC, "tools/backbone_ablate.py:429"),
    "attn_probe": (ATTN_PROBE_SRC, "tools/backbone_ablate.py:508"),
    "attn5d_direct": (ATTN5D_SRC, "tools/backbone_ablate.py:818"),
    "gemm_blocked": ("aurora_tpu_torch/csrc/gemm.cu", "tools/gemm_probe.py:92"),
    "smem_probe": (PROBES_SRC, "tools/vmem_probe.py:19"),
}
# Launches per forward step of each backbone route, from the code: 48 Swin blocks (stage
# depths 6+6, 10+10, 8+8), the odd-index half shifted (two rolls each) on every route; one
# attention kernel per block (K2, K6, or K5 after the plain attention of "xla"); one MLP
# kernel per block (K3, or K8 under mlp_impl "pallas"); K3 in the two perceiver MLP
# halves and K4 in the aggregation and de-aggregation cores on every route (route S: the
# aggregation's with ln_k).
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
    "S": (dict(attention_impl="auto", mlp_impl="auto", stabilise_level_agg=True), _MAIN),
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


def cuda_ms(fn) -> float:
    """Median device time of ``fn`` over REPS runs (``tools.time_ms``: CUDA events, each run
    behind a memset that keeps the queue ahead of the host and leaves the L2 cold)."""
    import torch

    from aurora_tpu_torch.tools import time_ms

    return time_ms(fn, torch.device("cuda", torch.cuda.current_device()), REPS)


# ------------------------------------------------------------------------------ kernels


def case(name, label, per_step, kernel, plain, bound, check, residual=None, library=None,
         mode=None, same_bits=None, extra=None, recheck=False) -> dict:
    return dict(name=name, label=label, per_step=per_step, kernel=kernel, plain=plain,
                bound=bound, check=check, residual=residual, library=library, mode=mode,
                same_bits=same_bits, extra=extra, recheck=recheck)


def kernel_cases():
    """One dict per kernel, mode and shape: name, label, mode (K2/K6: "tail" or "no tail",
    K4: None or "ln_k"), launches per step on the route that runs it (1 per case of a
    tool's sweep), the kernel, its plain version and the library call (callables), the
    check ("exact", "branch" with the residual its output adds a branch to, "rel", or
    "rel_ulp": "branch" with a zero residual), the bound, for K12 a key (``same_bits``: the
    outputs of consecutive cases with one key must be the same bits), for K7, K3, K2, K9-K11
    and K13 one more check (``extra``: a callable that returns fields for the case's line and
    raises on failure) and for K2, K6,
    K3 and K8 ``recheck``: the check is made again on the output of the last timed run."""
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
                def k2_extra(xp=xp, gr=groups, h=heads, t=t, pad=(Hp, Wp) != (H, W)):
                    more = k6_equals_k2(xp, wqkv, bqkv, gr, ws, h, t)
                    if gr is not None and t is not None and pad:
                        more.update(k2_pad_tokens_isolated(xp, wqkv, bqkv, gr, ws, h, t))
                    return more

                yield case(
                    "window_attention", f"(1,{C},{Hp},{Wp},{D}) heads {heads}, {kind}, {mode}",
                    nblk // 2, residual=xp,
                    kernel=lambda xp=xp, gr=groups, h=heads, t=t:
                        window_attention.window_attention_tail(xp, wqkv, bqkv, gr, ws, h, t),
                    plain=lambda xp=xp, gr=groups, h=heads, t=t:
                        window_attention.window_attention_tail_plain(xp, wqkv, bqkv, gr, ws, h, t),
                    extra=k2_extra, recheck=True, **kw,
                )
                yield case(
                    "window_attention_windowed",
                    f"(1,{nW},{N},{D}) heads {heads}, {kind}, {mode}", nblk // 2, residual=xw,
                    kernel=lambda xw=xw, gr=groups, h=heads, t=t:
                        window_attention.window_attention_windowed(xw, wqkv, bqkv, gr, h, t),
                    plain=lambda xw=xw, gr=groups, h=heads, t=t:
                        window_attention.window_attention_windowed_plain(
                            xw, wqkv, bqkv, gr, h, t),
                    recheck=True, **kw,
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
                extra=(lambda qkv=qkv, gr=groups, h=heads: pad_tokens_isolated(qkv, gr, h))
                if groups is not None and (Hp, Wp) != (H, W) else None,
            )
        del xp, xw, qkv, q, k, v
        rows = C * H * W
        film = (rn(1, D, std=0.1, dtype=torch.float32), rn(1, D, dtype=torch.float32))
        # Stage 3's 16200 rows are no multiple of 64: the ragged case.
        yield mlp_case(rn, f"backbone ({rows},{D})", rows, D, 4 * D, nblk, film,
                       ragged=rows % 64 != 0)
        # K8 (route P) and K5 (route X) at the same rows.
        xr = rn(1, rows, D)
        w8 = (rn(D, 4 * D, std=0.02), rn(4 * D, std=0.02, dtype=torch.float32),
              rn(4 * D, D, std=0.02), rn(D, std=0.02, dtype=torch.float32))
        yield case(
            "mlp_fused", f"backbone ({rows},{D}), hidden {4 * D}", nblk,
            kernel=lambda xr=xr, w=w8: mlp.mlp_fused(xr, *w),
            plain=lambda xr=xr, w=w8: mlp.mlp_fused_plain(xr, *w), check="rel", recheck=True,
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
    # K2 and K6 at the 121 x 240 grid's stage 1 (the routes' reference runs): 7200 rows, whose
    # last 64-row piece is ragged. Masked, with the tail. Count nothing towards the sums.
    C, H, W, D, heads = 4, 30, 60, 512, 8
    xp, nW = rn(1, C, H, W, D), C * H * W // 144
    xw = rn(1, nW, 144, D)
    groups = window_group_ids(C, H, W, ws, ss)
    wqkv, bqkv = rn(D, 3 * D, std=0.02), rn(3 * D, std=0.02)
    tail = (rn(D, D, std=0.02), rn(D, std=0.02, dtype=torch.float32),
            rn(1, D, std=0.1, dtype=torch.float32), rn(1, D, dtype=torch.float32))
    kw = dict(mode="tail", check="branch", recheck=True, bound=bound_ms(
        flops_bf16=8 * C * H * W * D * D + 4 * nW * heads * 144 * 144 * 64,
        nbytes=2 * C * H * W * D * 2 + 4 * D * D * 2))
    yield case(
        "window_attention", f"(1,{C},{H},{W},{D}) heads {heads}, 121 x 240, ragged, masked", 0,
        residual=xp,
        kernel=lambda: window_attention.window_attention_tail(xp, wqkv, bqkv, groups, ws, heads, tail),
        plain=lambda: window_attention.window_attention_tail_plain(
            xp, wqkv, bqkv, groups, ws, heads, tail), **kw,
    )
    yield case(
        "window_attention_windowed", f"(1,{nW},144,{D}) heads {heads}, 121 x 240, ragged, masked",
        0, residual=xw,
        kernel=lambda: window_attention.window_attention_windowed(xw, wqkv, bqkv, groups, heads, tail),
        plain=lambda: window_attention.window_attention_windowed_plain(
            xw, wqkv, bqkv, groups, heads, tail), **kw,
    )
    del xp, xw
    for label, rows, D in (("agg", 64800 * 3, 512), ("de-agg", 64800 * 13, 1024)):
        # LayerNorm affine in the FiLM slot: bias ~0, weight ~1.
        ln2 = (rn(1, D, std=0.1, dtype=torch.float32), 1 + rn(1, D, std=0.1, dtype=torch.float32))
        yield mlp_case(rn, f"perceiver {label} ({rows},{D})", rows, D, 2048, 1, ln2)
    # Two batch elements of 200 rows: the tile of rows 128..255 has both FiLM rows. Counts
    # nothing towards the per-step sums.
    film2 = (rn(2, 512, std=0.1, dtype=torch.float32), rn(2, 512, dtype=torch.float32))
    yield mlp_case(rn, "B = 2, (2,200,512): a tile straddles the FiLM rows", 200, 512, 2048, 0,
                   film2, B=2)
    # K4 at the 0.25 degree grid's M = 64800 token columns, then at the 121 x 240 grid's 1800
    # (13 x 1800 and 3 x 1800 rows: ragged last row tiles; counts nothing towards the sums).
    for M, per_step in ((64800, 1), (1800, 0)):
        for label, K, D, h, Q in (("agg", 13, 512, 16, 3), ("de-agg", 3, 1024, 16, 13)):
            yield from perceiver_cases(rn, label, K, M, D, h, Q, per_step)
    yield from probe_cases(rn)


def perceiver_cases(rn, label, K, M, D, h, Q, per_step):
    """K4 on the (de-)aggregation's shapes; with ln_k for the aggregation (route S). The
    bound is that of the folded work the kernels do (f32 logits from (D, Q h) weights; the v
    product and the out-projection in bf16, with ln_k also the product with the centred
    weights in three bf16 parts); the bound of the TPU kernel's work (the f32 k projection,
    logits from k) beside it."""
    import torch

    from aurora_tpu_torch.ops import resampler
    from aurora_tpu_torch.tools import bound_ms

    f32 = torch.float32
    inner, dh = D, D // h
    a = dict(
        ctx=rn(K, M, D, dtype=f32), wk=rn(D, inner, std=0.05, dtype=f32),
        wv=rn(D, inner, std=0.05, dtype=f32), qh=rn(Q, h, dh, dtype=f32),
        wout=rn(inner, D, std=0.05, dtype=f32), ln1_w=1 + rn(D, std=0.1, dtype=f32),
        ln1_b=rn(D, std=0.1, dtype=f32), queries=rn(Q, D, dtype=f32),
    )
    kw = dict(scale=dh**-0.5, value_bf16=True)
    b16 = 2 * K * M * D * inner + 2 * M * Q * inner * D
    nb = K * M * D * 4 + M * Q * D * 2 + D * inner * 6 + inner * D * 2
    lnks = [None]
    if label == "agg":
        lnks.append((1 + rn(inner, std=0.1, dtype=f32), rn(inner, std=0.1, dtype=f32)))
    for lnk in lnks:
        # With ln_k, ctx Wc in three bf16 products (the kernels' split form).
        split = 3 * 2 * K * M * D * inner if lnk is not None else 0
        # The TPU kernel's work: the f32 k projection and logits from k; ln_k adds ~8 f32
        # operations per value of k.
        tpu = 2 * K * M * D * inner + 2 * K * M * Q * inner + (8 * K * M * inner if lnk else 0)
        tpu_bound = bound_ms(flops_bf16=b16, flops_f32=tpu, nbytes=nb)[0]
        yield case(
            "perceiver_core", f"{label} ctx ({K},{M},{D}) Q {Q}" + (", ln_k" if lnk else ""),
            per_step, mode="ln_k" if lnk is not None else None,
            kernel=lambda lnk=lnk: resampler.perceiver_core(**a, **kw, lnk=lnk),
            plain=lambda lnk=lnk: resampler.perceiver_core_plain(**a, **kw, lnk=lnk),
            check="branch", residual=a["queries"][None],
            bound=bound_ms(flops_bf16=b16 + split, flops_f32=2 * K * M * D * Q * h, nbytes=nb),
            extra=lambda b=tpu_bound: dict(bound_of_tpu_work_ms=b),
        )


def pad_tokens_isolated(qkv, groups, heads) -> dict:
    """K7 on a padded grid: garbage in the pad tokens' q, k and v must leave every real
    token's output the same bits (pad tokens have a group id of their own, the largest)."""
    import torch

    from aurora_tpu_torch.ops import window_attention

    pad = torch.as_tensor(groups == groups.max(), device=qkv.device)  # (nW, N)
    if not pad.any() or pad.all():
        raise AssertionError("pad-token check: the grid has no pad tokens")
    clean = window_attention.sdpa_windows(qkv, groups, heads)
    dirty_in = torch.where(pad[None, :, :, None], torch.full_like(qkv, 7.0), qkv)
    dirty = window_attention.sdpa_windows(dirty_in, groups, heads)
    torch.cuda.synchronize()
    real_equal = torch.equal(clean[:, ~pad], dirty[:, ~pad])
    pad_moved = not torch.equal(clean[:, pad], dirty[:, pad])
    if not (real_equal and pad_moved):
        raise AssertionError(f"pad-token check: real tokens bit-equal {real_equal}, pad tokens "
                             f"changed {pad_moved}")
    return dict(pad_tokens=int(pad.sum()), real_tokens_bit_equal=True, pad_tokens_changed=True)


def k6_equals_k2(xp, wqkv, bqkv, groups, ws, heads, tail) -> dict:
    """K6 on the partitioned windows of ``xp``, reversed, must be K2's bits on ``xp``: one
    function, two row addressings (packed rows through a 2D map, windows in place through a
    5D one)."""
    import torch

    from aurora_tpu_torch.ops import window_attention as wa

    _, C, H, W, _ = xp.shape
    k2 = wa.window_attention_tail(xp, wqkv, bqkv, groups, ws, heads, tail)
    k6 = wa.window_attention_windowed(wa.window_partition(xp, ws).contiguous(), wqkv, bqkv,
                                      groups, heads, tail)
    torch.cuda.synchronize()
    if not torch.equal(wa.window_reverse(k6, ws, C, H, W), k2):
        raise AssertionError("K6 on window_partition(xp), reversed, differs from K2 on xp")
    return dict(k6_on_partition_equals_k2=True)


def k2_pad_tokens_isolated(xp, wqkv, bqkv, groups, ws, heads, tail) -> dict:
    """K2 on a padded grid, masked: garbage in the pad tokens of ``xp`` must leave every real
    token's output the same bits (pad tokens have a group id of their own, the largest; in
    a shifted block they lie where the roll put them; proj and the LayerNorm work row by
    row)."""
    import torch

    from aurora_tpu_torch.ops import window_attention as wa

    _, Cp, Hp, Wp, _ = xp.shape
    pad_w = torch.as_tensor(groups == groups.max(), device=xp.device)  # (nW, N)
    pad = wa.window_reverse(pad_w[None, :, :, None], ws, Cp, Hp, Wp)[0, ..., 0]
    clean = wa.window_attention_tail(xp, wqkv, bqkv, groups, ws, heads, tail)
    dirty = wa.window_attention_tail(
        torch.where(pad[None, ..., None], torch.full_like(xp, 7.0), xp), wqkv, bqkv, groups, ws,
        heads, tail)
    torch.cuda.synchronize()
    real_equal = torch.equal(clean[:, ~pad], dirty[:, ~pad])
    pad_moved = not torch.equal(clean[:, pad], dirty[:, pad])
    if not (real_equal and pad_moved):
        raise AssertionError(f"K2 pad-token check: real tokens bit-equal {real_equal}, pad "
                             f"tokens changed {pad_moved}")
    return dict(pad_tokens=int(pad.sum()), real_tokens_bit_equal=True, pad_tokens_changed=True)


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
                "mlp_t", f"({L},{D}) R {R}, {L // R} units", 1, residual=x,
                kernel=lambda a=a, R=R: probes.mlp_t(*a, R),
                plain=lambda a=a: probes.mlp_t_plain(*a), check="branch",
                bound=bound_ms(flops_bf16=4 * L * D * Hd, nbytes=2 * L * D * 2 + 2 * D * Hd * 2),
                extra=lambda a=a, R=R: k9_against_k3(a, R),
            )
        del x, a
        # K11 on the padded grid, against its plain version; K2 without tail's bits.
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
                check="rel_ulp",
                bound=bound_ms(flops_bf16=fl, nbytes=2 * nW * N * D * 2 + 3 * D * D * 2),
                extra=lambda x5=x5, w=wqkv, b=bqkv, h=heads, m=mode: same_bits_as(
                    lambda: probes.attn5d_direct(x5, w, b, ws, h, m), "K2 without tail",
                    lambda: window_attention.window_attention_tail(x5, w, b, None, ws, h, None)),
            )
        del x5
    # K10: the seven modes at the stage-1 shape.
    nW, D, heads = 1800, 512, 8
    xw, wqkv, bqkv = rn(1, nW, N, D), rn(D, 3 * D, std=0.02), rn(1, 3 * D, std=0.02)
    proj, core = 2 * nW * N * D * 3 * D, 4 * nW * N * N * D
    same = {"baseline": ("K6 without tail", lambda: window_attention.window_attention_windowed(
                xw, wqkv, bqkv.reshape(-1), None, heads)),
            "batched_heads": ("baseline", lambda: probes.attn_probe(xw, wqkv, bqkv, heads,
                                                                     "baseline")),
            "bf16_batched": ("bf16_core", lambda: probes.attn_probe(xw, wqkv, bqkv, heads,
                                                                     "bf16_core"))}
    for mode in probes.ATTN_PROBE_MODES:
        yield case(
            "attn_probe", f"(1,{nW},{N},{D}) heads {heads}, {mode}", 1,
            kernel=lambda m=mode: probes.attn_probe(xw, wqkv, bqkv, heads, m),
            plain=lambda m=mode: probes.attn_probe_plain(xw, wqkv, bqkv, heads, m),
            check="rel_ulp",
            bound=bound_ms(flops_bf16=proj + (0 if mode == "no_core" else core),
                           nbytes=2 * nW * N * D * 2 + 3 * D * D * 2),
            extra=(lambda m=mode: same_bits_as(
                lambda: probes.attn_probe(xw, wqkv, bqkv, heads, m), *same[m]))
            if mode in same else None,
        )
    del xw
    # K12: the proj and fc2 shapes under every row block of the tool; cuBLAS beside it. Then
    # 3240 rows of each under row blocks that give an odd number of 64-row pieces (51); these
    # count nothing towards the sweep's sums (per_step 0).
    for name, (M, K, Nn, blocks) in (("proj", PROJ), ("fc2", FC2)):
        for rows, row_blocks, n in ((M, blocks, 1), (3240, (540, 1080, 3240), 0)):
            a, w = rn(rows, K), rn(K, Nn, std=0.02)
            for MB in row_blocks:
                if rows % MB:  # as the tool: 512 and 1024 do not divide 259200
                    continue
                pieces = (rows // MB) * -(-MB // 64)
                yield case(
                    "gemm_blocked",
                    f"{name} ({rows},{K})x({K},{Nn}) MB {MB}, {rows // MB} row blocks, {pieces} pieces",
                    n, kernel=lambda a=a, w=w, MB=MB: probes.gemm_blocked(a, w, MB),
                    plain=lambda a=a, w=w: probes.gemm_blocked_plain(a, w),
                    library=lambda a=a, w=w: torch.matmul(a, w), check="rel_ulp",
                    same_bits=f"{name} {rows}",
                    bound=bound_ms(flops_bf16=2 * rows * K * Nn,
                                   nbytes=2 * (rows * K + K * Nn + rows * Nn)),
                )
            del a, w
    # K13 with the largest scratch of the tool's sweep that the card's opt-in maximum allows.
    # Its bound: the larger of its bytes' time and a launch's floor (a kernel that does
    # nothing, timed the same way in this run), since no kernel takes less than a launch.
    x = rn(8, 128, dtype=f32)
    nbytes = max(k * 1024 for k in SWEEP_KIB if k * 1024 <= probes.smem_optin_bytes())
    byte_bound, by = bound_ms(nbytes=2 * x.numel() * 4)
    empty_ms = cuda_ms(lambda: probes.empty_launch(x.device))
    yield case(
        "smem_probe", f"(8,128) f32, {nbytes} bytes of shared memory", 1,
        kernel=lambda: probes.smem_probe(x, nbytes), plain=lambda: probes.smem_probe_plain(x),
        check="exact", bound=(max(byte_bound, empty_ms), by),
        extra=lambda: dict(empty_kernel_ms=empty_ms, byte_bound_ms=byte_bound),
    )


def k9_against_k3(a, R) -> dict:
    """K9 against K3 at scale_bias = 0 on the same inputs (sc / sh as one FiLM row), by the
    branch measure and its 6e-3 bound: one function, the products summed in another order
    (feature-major tiles), so bits are not expected."""
    import torch

    from aurora_tpu_torch.ops import mlp, probes
    from aurora_tpu_torch.tools import branch_err

    x, w1, b1, w2, b2, sh, sc = a
    got = probes.mlp_t(*a, R)
    k3 = mlp.mlp_adaln_residual(x[None], w1, b1.reshape(-1), w2, b2.reshape(-1),
                                sh.reshape(1, -1), sc.reshape(1, -1))[0]
    torch.cuda.synchronize()
    err = branch_err(got, k3, x)[1]
    if not err <= TOL["mlp_t"]:
        raise AssertionError(f"K9 R {R} against K3 at scale_bias 0: branch error {err}")
    return dict(vs_k3_branch_err=err)


def same_bits_as(kernel, what, other) -> dict:
    """K10's and K11's schedules, K6 and K2: ``kernel()`` must give ``other()``'s bits."""
    import torch

    got, want = kernel(), other()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"not the bits of {what}")
    return {f"same_bits_as_{what.replace(' ', '_')}": True}


def mlp_case(rn, label, rows, D, Hd, per_step, shift_scale, B=1, ragged=False):
    """Both callers pass scale_bias = 0: the blocks' FiLM and the perceiver's LN affine."""
    import torch

    from aurora_tpu_torch.ops import mlp
    from aurora_tpu_torch.tools import bound_ms

    x = rn(B, rows, D)
    a = (
        rn(D, Hd, std=0.02), rn(Hd, std=0.02, dtype=torch.float32), rn(Hd, D, std=0.02),
        rn(D, std=0.02, dtype=torch.float32), *shift_scale,
    )
    fl = 4 * B * rows * D * Hd
    nb = 2 * B * rows * D * 2 + 2 * D * Hd * 2
    return case(
        "mlp_adaln_residual", label, per_step,
        kernel=lambda: mlp.mlp_adaln_residual(x, *a),
        plain=lambda: mlp.mlp_adaln_residual_plain(x, *a),
        check="branch", residual=x, bound=bound_ms(flops_bf16=fl, nbytes=nb), recheck=True,
        extra=(lambda: rows_past_end_untouched(x, a)) if ragged else None,
    )


def rows_past_end_untouched(x, a) -> dict:
    """K3 and K8 on rows that are no multiple of a tile's 64, written into the first rows of
    a larger buffer filled with a sentinel: those rows must be the wrappers' bits, and the
    rows behind them must keep the sentinel."""
    import torch

    from aurora_tpu_torch.ops import _lib, mlp

    B, L, D = x.shape
    M, spare, sentinel = B * L, 256, -32768.0
    if M % 64 == 0:
        raise AssertionError(f"ragged check: {M} rows are a multiple of 64")
    ops = mlp._mlp_operands(x, *a[:4])
    fn = _lib.kernel("mlp", "mlp_rows", mlp._MLP_ROWS_ARGS)
    film = (a[4].float().reshape(B, D).contiguous(), a[5].float().reshape(B, D).contiguous(),
            0.0, L, 1e-5)
    for what, f, ref in (("mlp_adaln_residual", film, mlp.mlp_adaln_residual(x, *a)),
                         ("mlp_fused", None, mlp.mlp_fused(x, *a[:4]))):
        buf = torch.full((M + spare, D), sentinel, dtype=x.dtype, device=x.device)
        mlp._mlp_rows(fn, x.view(M, D), ops, buf[:M], f)
        torch.cuda.synchronize()
        same = torch.equal(buf[:M], ref.view(M, D))
        kept = bool((buf[M:] == sentinel).all())
        if not (same and kept):
            raise AssertionError(f"ragged check, {what}: first {M} rows bit-equal {same}, the "
                                 f"{spare} rows behind them untouched {kept}")
    return dict(ragged_rows=M, rows_behind_untouched=spare)


def _totals() -> dict:
    return dict(max_abs_err=0.0, err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None,
                by={"bytes": 0.0, "operations": 0.0})


def run_kernel_phases() -> dict:
    """Check and time every case; returns per-step totals keyed by (name, mode)."""
    import torch

    from aurora_tpu_torch.tools import branch_err, rel_err

    summary: dict = {}
    bits_key, bits_ref = None, None  # the output the next cases of one key must equal
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
        more = {}
        if case["same_bits"] != bits_key:
            bits_key, bits_ref = case["same_bits"], (got if case["same_bits"] else None)
        elif bits_key is not None:
            more["same_bits_as_first_row_block"] = torch.equal(got, bits_ref)
            ok = ok and more["same_bits_as_first_row_block"]
        if case["extra"] is not None:
            more.update(case["extra"]())
        del got
        if case["recheck"]:
            # The same check on the output of the last timed run: a race between one launch's
            # writes of the hidden activations and the next one's reads shows only now and then.
            last = []

            def timed(last=last):
                last[:] = [case["kernel"]()]

            ms = cuda_ms(timed)
            if case["check"] == "branch":
                more["last_run_rel_err"] = branch_err(last[0], want, case["residual"])[1]
            else:
                more["last_run_rel_err"] = rel_err(last[0], want)
            ok = ok and more["last_run_rel_err"] <= TOL[name]
            del last[:]
        else:
            ms = cuda_ms(case["kernel"])
        del want
        plain_ms = cuda_ms(case["plain"])
        lib_ms = cuda_ms(case["library"]) if case["library"] else None
        b, by = case["bound"]
        more["of_bound"] = b / ms
        if lib_ms is not None:
            more["vs_library"] = ms / lib_ms
        emit(dict(phase="kernel", kernel=name, mode=case["mode"], shape=case["label"],
                  ok=bool(ok), max_abs_err=err, rel_err=rel, check=case["check"],
                  tol=TOL[name], ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b,
                  bound_by=by, per_step=case["per_step"], **more))
        if not ok:
            raise AssertionError(f"{name} {case['label']}: max abs err {err}, relative error "
                                 f"{rel} (bound {TOL[name]}) {more}")
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
        for k in ("empty_kernel_ms", "byte_bound_ms"):  # K13: the two sides of its bound
            if k in more:
                s[k] = more[k]
        if "bound_of_tpu_work_ms" in more:  # K4: the TPU kernel's work, beside the folded
            s["bound_of_tpu_work_ms"] = s.get("bound_of_tpu_work_ms", 0.0) + n * more[
                "bound_of_tpu_work_ms"]
        torch.cuda.empty_cache()
    return summary


# ------------------------------------------------------------------------------ end to end


def run_route(name: str, steps: int, ref_grid: tuple[int, int], then=None) -> dict:
    """The roll-out of one backbone route; returns the launches over it. ``then(model)``
    runs after the roll-out's checks, before the reference."""
    import torch

    from aurora_tpu_torch import rollout
    from aurora_tpu_torch.ops import _lib
    from aurora_tpu_torch.tools.perf_breakdown import build_model, numpy_batch, production_config

    knobs, counts = ROUTES[name]
    expected = {k: counts.get(k, 0) for k in _lib.LAUNCHES}
    # The production model (LoRA, bf16 backbone stored in bf16, bf16 (de-)aggregation values),
    # FiLM and LoRA gates opened.
    cfg = production_config().replace(**knobs)
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    init_s = time.perf_counter() - t0
    batch = numpy_batch(cfg, 721, 1440)

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
    if then is not None:
        then(model)

    # Reference on a small input, the card against the port's CPU run of the same route: the
    # route's model at two blocks per backbone stage (the second shifted, so K1 and the
    # masked attention run), seeded on the card.
    t0 = time.perf_counter()
    H, W = ref_grid
    small = numpy_batch(cfg, H, W, seed=1)
    del model
    torch.cuda.empty_cache()
    cfg = cfg.replace(encoder_depths=(2, 2, 2), decoder_depths=(2, 2, 2))
    model = build_model(cfg, "cuda")
    before = dict(_lib.LAUNCHES)
    got = model(small)
    torch.cuda.synchronize()
    ref_launches = {k: n - before[k] for k, n in _lib.LAUNCHES.items() if n != before[k]}
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
              depths=(cfg.encoder_depths, cfg.decoder_depths), launches=ref_launches,
              against="port CPU route (plain versions)", mean_rel=errs, worst=worst, tol=1e-2,
              seconds=time.perf_counter() - t0))
    missing = [k for k in counts if not ref_launches.get(k)]
    if missing:
        raise AssertionError(f"route {name}: the reference run never launched {missing}")
    if not worst <= 1e-2:
        raise AssertionError(f"route {name}: card vs CPU route: mean rel {worst} > 1e-2")
    return launches


def _mean_rel(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).abs().mean() / (b.abs().mean() + 1e-30)).item()


# ------------------------------------------------------------------------------ breakdown

# Kernels each part of the breakdown must launch: K4 and K3 in the level aggregation and
# de-aggregation, K1-K3 in the backbone.
BREAKDOWN_KERNELS = {
    ("perf_breakdown", "encoder"): ("perceiver_core", "mlp_adaln_residual"),
    ("perf_breakdown", "backbone (bf16)"): ("roll3d", "window_attention", "mlp_adaln_residual"),
    ("perf_breakdown", "decoder"): ("perceiver_core", "mlp_adaln_residual"),
    ("encoder_breakdown", "encoder FULL"): ("perceiver_core", "mlp_adaln_residual"),
    ("encoder_breakdown", "level aggregation"): ("perceiver_core", "mlp_adaln_residual"),
    ("decoder_breakdown", "deaggregate FULL"): ("perceiver_core", "mlp_adaln_residual"),
    ("decoder_breakdown", "  K4 perceiver_core"): ("perceiver_core",),
    ("decoder_breakdown", "  K3 MLP half"): ("mlp_adaln_residual",),
}


def run_breakdown(model) -> None:
    """The three breakdown tools as a user runs them, in process, on the main route's model
    at 720 x 1440 (``perf_breakdown`` on the 721 x 1440 batch it crops). Each row must have
    launched the kernels of its part."""
    import torch

    from aurora_tpu_torch.tools import decoder_breakdown, encoder_breakdown, perf_breakdown

    t0 = time.perf_counter()
    seen = set()
    for tool in (perf_breakdown, encoder_breakdown, decoder_breakdown):
        name = tool.__name__.rsplit(".", 1)[1]
        for r in tool.main(["--steps", "3"], model=model):
            emit(dict(phase="breakdown", tool=name, **r))
            need = BREAKDOWN_KERNELS.get((name, r["label"]), ())
            missing = [k for k in need if not r["launches"].get(k)]
            if missing:
                raise AssertionError(f"breakdown {name} {r['label']!r}: kernels never "
                                     f"launched: {missing}")
            seen.add((name, r["label"]))
        torch.cuda.empty_cache()
    absent = sorted(set(BREAKDOWN_KERNELS) - seen)
    if absent:
        raise AssertionError(f"breakdown: rows missing {absent}")
    emit(dict(phase="breakdown", seconds=time.perf_counter() - t0))


# ------------------------------------------------------------------------------ roll-outs


def run_rollouts(model) -> None:
    """The port's three roll-outs on the main route's model, as ``tools.bench`` measures
    them (``bench.measure``: every step's time, launches and peak memory, steps per second,
    the idle share of two steady steps), each of SCAN_STEPS steps from one 721 x 1440 batch
    of host arrays: ``rollout``, ``rollout_scan`` and ``rollout_scan(host_offload=True)``.
    Launches per step as ``ROUTES["main"]``; the three agree step by step (the same bits, or
    within SCAN_AGREE_TOL mean relative); the host-offload roll-out's peak memory exceeds a
    SHORT_STEPS one's by less than one prediction; the caller's arrays are unchanged."""
    import numpy as np
    import torch

    from aurora_tpu_torch.ops import _lib
    from aurora_tpu_torch.tools import bench

    t0 = time.perf_counter()
    model, batch = bench.build("main", model.device, model=model)
    groups = ("surf_vars", "static_vars", "atmos_vars")
    before = {(g, k): np.array(v) for g in groups for k, v in getattr(batch, g).items()}
    expected = ROUTES["main"][1]
    rows, first = {}, None
    for kind in bench.ROLLOUTS:
        _lib.reset_launches()
        row, preds = bench.measure(model, batch, kind, SCAN_STEPS)
        row["launches"] = dict(_lib.LAUNCHES)  # over its timed, profiled and free-running runs
        preds = [p.to_numpy() for p in preds]
        torch.cuda.empty_cache()
        rows[kind] = row
        missing = [k for k in expected if not row["launches"][k]]
        if missing:
            raise AssertionError(f"{kind}: kernels never launched: {missing}")
        for i, got in enumerate(row["launches_per_step"]):
            if got != expected:
                raise AssertionError(f"{kind} step {i}: launches {got} != {expected}")
        for i, p in enumerate(preds):
            for k, v in {**p.surf_vars, **p.atmos_vars}.items():
                if not np.isfinite(v).all():
                    raise AssertionError(f"{kind} step {i} {k}: non-finite values")
        if first is None:
            first = preds
        else:
            row["against_loop"] = agreement(first, preds)
            if not row["against_loop"]["worst_mean_rel"] <= SCAN_AGREE_TOL:
                raise AssertionError(f"{kind} against rollout: {row['against_loop']}")
        emit(dict(phase="rollout_scan", **row))
    short = bench.timed(model, batch, "scan_offload", SHORT_STEPS)[0]["peak_mem_gib"]
    full = rows["scan_offload"]["peak_mem_gib"]
    pred_gib = sum(v.nbytes for v in {**first[0].surf_vars, **first[0].atmos_vars}.values())
    pred_gib /= 2**30
    changed = [gk for gk, v in before.items() if not np.array_equal(getattr(batch, gk[0])[gk[1]], v)]
    emit(dict(phase="rollout_scan", seconds=time.perf_counter() - t0,
              offload_peak_mem_gib={SHORT_STEPS: short, SCAN_STEPS: full},
              prediction_gib=pred_gib, callers_arrays_changed=changed))
    if not full - short < pred_gib:
        raise AssertionError(f"host offload: peak {full} GiB at {SCAN_STEPS} steps against "
                             f"{short} at {SHORT_STEPS}: more than one prediction "
                             f"({pred_gib} GiB)")
    if changed:
        raise AssertionError(f"the roll-outs wrote to the caller's arrays {changed}")


def agreement(want: list, got: list) -> dict:
    """Whether two roll-outs' predictions (host arrays) are the same bits, step by step, and
    their worst mean relative difference."""
    import numpy as np

    same, worst = True, 0.0
    for w, g in zip(want, got, strict=True):
        for k, a in {**w.surf_vars, **w.atmos_vars}.items():
            b = (g.surf_vars if k in w.surf_vars else g.atmos_vars)[k]
            if not np.array_equal(a, b):
                same = False
                a64, b64 = a.astype(np.float64), b.astype(np.float64)
                worst = max(worst, float(np.abs(a64 - b64).mean() / (np.abs(a64).mean() + 1e-30)))
    return dict(bit_equal=same, worst_mean_rel=worst)


# ------------------------------------------------------------------------------ drivers

DRIVER_STEPS = 2  # forecast steps of the command-line driver
TRACK_FIX = (25.3, 129.2)  # the tracker's first fix (lat, lon); the land-sea mask is 0 around it
DRIVERS_DIR = "build/drivers"  # the phase's files, under the checkout, removed at its end


def run_drivers(model) -> None:
    """The operational drivers on the main route's model. An initial condition of the
    721 x 1440 grid written with ``Batch.to_netcdf`` (the land-sea mask 0 within 6 degrees of
    TRACK_FIX, so the tracker takes its MSL path); ``python -m aurora_tpu_torch forecast``'s
    ``main`` (DRIVER_STEPS steps, ``--track``) with its seconds split as it reports them; its
    files held to ``rollout`` of the same model and batch (the same bits, or within
    SCAN_AGREE_TOL mean relative) and its track to the tracker's on the card's predictions and
    on their host copies (the same track); ``evaluate`` of step 2 against step 1 on the card;
    ``Batch.regrid(1.0)`` of a prediction with the native library built, and one field through
    the scipy form beside the native one; ``tools.rollout_bench`` at 3 steps;
    ``tools.train_speed_probe`` at 121 x 240 over two arms."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch

    from aurora_tpu_torch import Batch, cli, native, rollout
    from aurora_tpu_torch.batch import interpolate_scipy
    from aurora_tpu_torch.tools import rollout_bench, train_speed_probe
    from aurora_tpu_torch.tools.perf_breakdown import numpy_batch
    from aurora_tpu_torch.tracker import Tracker

    t_phase = time.perf_counter()
    work = os.path.abspath(DRIVERS_DIR)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        batch = numpy_batch(model.cfg, 721, 1440, seed=2)
        lat, lon = batch.metadata.lat, batch.metadata.lon
        near = (np.abs(lat - TRACK_FIX[0]) <= 6)[:, None] & (np.abs(lon - TRACK_FIX[1]) <= 6)
        batch.static_vars["lsm"][near] = 0.0
        ic, out = os.path.join(work, "ic.nc"), os.path.join(work, "preds")
        t0 = time.perf_counter()
        batch.to_netcdf(ic)
        ic_write_s = time.perf_counter() - t0

        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main(["forecast", "--input", ic, "--steps", str(DRIVER_STEPS),
                           "--output-dir", out, "--track", "--init-lat", str(TRACK_FIX[0]),
                           "--init-lon", str(TRACK_FIX[1])], model=model)
        forecast_s = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"forecast exited {rc}: {err.getvalue()[-2000:]}")
        timings = json.loads(err.getvalue().strip().splitlines()[-1])["forecast_timings"]

        # The files against rollout's predictions; the tracker on the card's predictions and
        # on their host copies.
        card_track = Tracker(*TRACK_FIX, batch.metadata.time[0])
        host_track = Tracker(*TRACK_FIX, batch.metadata.time[0])
        files, preds, tracker_card_s = [], [], []
        for i, pred in enumerate(rollout(model, batch, DRIVER_STEPS)):
            t0 = time.perf_counter()
            card_track.step(pred)
            tracker_card_s.append(time.perf_counter() - t0)
            host = pred.to_numpy()
            host_track.step(host)
            preds.append(host)
            files.append(Batch.from_netcdf(os.path.join(out, f"prediction-{i:03d}.nc")))
            del pred
        files_vs_rollout = agreement(preds, files)
        same_track = card_track.results() == host_track.results()
        csv_path = os.path.join(work, "card_track.csv")
        card_track.write_csv(csv_path)
        with open(csv_path) as a, open(os.path.join(out, "track.csv")) as b:
            cli_track_same = a.read() == b.read()
        track = card_track.results()

        # evaluate, on the card.
        sout = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sout):
            rc = cli.main(["evaluate", "--pred", os.path.join(out, "prediction-001.nc"),
                           "--target", os.path.join(out, "prediction-000.nc")])
        evaluate_s = time.perf_counter() - t0
        scores = json.loads(sout.getvalue())["scores"]
        score_values = [v for group in scores.values() for ms in group.values()
                        for m in ms.values() for v in (m if isinstance(m, list) else [m])]

        # Regrid: the whole prediction through the native library, one field through both.
        built = native.available()
        pred = files[-1]
        t0 = time.perf_counter()
        coarse = pred.regrid(1.0)
        regrid_native_s = time.perf_counter() - t0
        field = pred.surf_vars["2t"].astype(np.float64)
        grid = (np.asarray(pred.metadata.lat, np.float64),
                np.asarray(pred.metadata.lon, np.float64),
                np.linspace(90, -90, 181), np.linspace(0, 360, 360, endpoint=False))
        t0 = time.perf_counter()
        one_native = native.regrid_bilinear(field, *grid)
        one_native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        one_scipy = interpolate_scipy(field, *grid)
        one_scipy_s = time.perf_counter() - t0
        regrid_rel = float(np.abs(one_native - one_scipy).max() / np.abs(one_scipy).max())
        coarse_ok = all(tuple(v.shape[-2:]) == (181, 360) and bool(torch.isfinite(v).all())
                        for g in (coarse.surf_vars, coarse.atmos_vars) for v in g.values())
        regrid_fields = sum(int(np.prod(v.shape[:-2])) for g in
                            (pred.surf_vars, pred.static_vars, pred.atmos_vars) for v in g.values())
        del coarse, files, preds, pred

        with contextlib.redirect_stdout(io.StringIO()):
            bench = rollout_bench.main(["--steps", "3"], model=model)
            probe = train_speed_probe.main(["--H", "121", "--W", "240", "--steps", "1",
                                            "--arms", "base,blocks"], model=model)
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    row = dict(phase="drivers", grid="721x1440", steps=DRIVER_STEPS, ic_write_s=ic_write_s,
               ic_bytes=timings["input_bytes"], forecast_s=forecast_s, forecast=timings,
               tracker_card_s=tracker_card_s, files_vs_rollout=files_vs_rollout,
               track=dict(lat=track["lat"], lon=track["lon"], fails=card_track.fails),
               track_card_equals_host=same_track, cli_track_csv_equal=cli_track_same,
               evaluate_s=evaluate_s, evaluate_rmse_2t=scores["surf_vars"]["2t"]["rmse"],
               native_regrid_built=built, regrid_native_s=regrid_native_s,
               regrid_fields=regrid_fields, regrid_one_field_native_s=one_native_s,
               regrid_one_field_scipy_s=one_scipy_s, regrid_native_vs_scipy=regrid_rel,
               rollout_bench=dict((k, bench[k]) for k in ("step_s", "tracker_s", "steps_per_s",
                                                          "track_len", "fails")),
               train_speed_probe=probe["arms"], seconds=time.perf_counter() - t_phase)
    emit(row)
    bad = []
    if not built:
        bad.append("the native regrid library did not build")
    if not files_vs_rollout["worst_mean_rel"] <= SCAN_AGREE_TOL:
        bad.append(f"forecast files against rollout: {files_vs_rollout}")
    if not (same_track and cli_track_same and len(track["lat"]) == DRIVER_STEPS + 1):
        bad.append(f"tracks differ: card vs host {same_track}, CLI csv {cli_track_same}")
    if not (rc == 0 and score_values and np.all(np.isfinite(score_values))):
        bad.append(f"evaluate: exit {rc}, non-finite scores")
    if not (coarse_ok and regrid_rel <= 1e-12):
        bad.append(f"regrid: shapes/finite {coarse_ok}, native vs scipy {regrid_rel}")
    if not (bench["track_len"] == 4 and all(r.get("s_per_step") for r in probe["arms"])):
        bad.append(f"rollout_bench track {bench['track_len']}, probe arms {probe['arms']}")
    if bad:
        raise AssertionError(f"drivers: {bad}")


def run_main_phases(model) -> None:
    """What runs on the main route's model after its roll-out: the breakdown tools, the
    three roll-outs, then the drivers."""
    run_breakdown(model)
    run_rollouts(model)
    run_drivers(model)


# ------------------------------------------------------------------------------ training

# Bounds of the gradient checks: the forward's (roll exact, bf16 6e-3, the perceiver core
# 1e-2), of max |kernel path's gradient - plain autograd's| over max |plain autograd's|, less
# one bf16 ulp of the larger where the gradient is bf16 (both sides round it to bf16). A
# gradient that is zero in exact arithmetic (ln_k's bias: a constant over the levels, which
# the softmax over the levels removes) holds only rounding noise on both sides, so the
# denominator is at least GRAD_FLOOR times the largest gradient of the call.
GRAD_TOL = {"roll3d": 0.0, "perceiver_core": 1e-2}
GRAD_FLOOR = 1e-3
BWD_REPS = 3  # timed backward runs per kernel, after one warm-up run
TRAIN_STEPS = 1  # timed steps of the full-width LoRA train step, after a warm-up step
ROLLOUT_K, ROLLOUT_UPDATES = 2, 2
TRAIN_REF_GRID = (121, 240)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-2, 5e-2  # card vs CPU: loss, LoRA gradient (rel. L2)
TWO_BLOCKS = dict(encoder_depths=(2, 2, 2), decoder_depths=(2, 2, 2))
STO_DROP_PATH = 0.2  # the full-width stochastic LoRA step's stochastic-depth rate
STO_REF = dict(drop_path=0.2, drop_rate=0.1)  # the two-block stochastic step's knobs
KEEP_DRAWS, KEEP_RATE = 10_000, 0.8


def grad_cases(rn):
    """One case per kernel (K2 and K6 also without the tail, K4 also with ln_k) on inputs cut
    to a few thousand rows, windows or columns (FiLM at unit gain), with the main path's
    shape of the kernel for timing the backward: ``(name, label, call, plain, make, timed)``
    where ``make(full)`` gives the arguments (every tensor a leaf that requires a gradient)
    and ``timed`` marks the case whose backward is timed, one a kernel: the one the main
    path's train step runs (K2 and K6 with the tail, K4's de-aggregation)."""
    import torch

    from aurora_tpu_torch.ops import mlp, resampler, roll, window_attention as wa
    from aurora_tpu_torch.ops.masks import window_group_ids

    f32 = torch.float32
    ws, ss = (2, 6, 12), (1, 3, 6)

    def leaf(*shape, std=1.0, dtype=torch.bfloat16):
        return rn(*shape, std=std, dtype=dtype).requires_grad_()

    def grid(full):
        return (4, 180, 360) if full else (4, 24, 48)

    def tail(D, on):
        if not on:
            return (None,) * 4
        return (leaf(D, D, std=0.02), leaf(D, std=0.02, dtype=f32),
                leaf(1, D, std=0.1, dtype=f32), leaf(1, D, dtype=f32))

    def k2(masked, with_tail):
        def make(full):
            C, H, W = grid(full)
            g = window_group_ids(C, H, W, ws, ss) if masked else None
            return (leaf(1, C, H, W, 512), leaf(512, 1536, std=0.02), leaf(1536, std=0.02), g,
                    ws, 8, *tail(512, with_tail), 1e-5)
        return make

    def k2_call(fn):
        def call(xp, wqkv, bqkv, g, ws_, h, wp, bp, sh, sc, eps):
            return fn(xp, wqkv, bqkv, g, ws_, h, None if wp is None else (wp, bp, sh, sc), eps)
        return call

    def k6(masked, with_tail):
        def make(full):
            C, H, W = grid(full)
            g = window_group_ids(C, H, W, ws, ss) if masked else None
            return (leaf(1, C * H * W // 144, 144, 512), leaf(512, 1536, std=0.02),
                    leaf(1536, std=0.02), g, 8, *tail(512, with_tail), 1e-5)
        return make

    def k6_call(fn):
        def call(xw, wqkv, bqkv, g, h, wp, bp, sh, sc, eps):
            return fn(xw, wqkv, bqkv, g, h, None if wp is None else (wp, bp, sh, sc), eps)
        return call

    def rows(full):
        return 259200 if full else 4096

    def mlp_args(full, D=512, Hd=2048):
        return (leaf(1, rows(full), D), leaf(D, Hd, std=0.02), leaf(Hd, std=0.02, dtype=f32),
                leaf(Hd, D, std=0.02), leaf(D, std=0.02, dtype=f32))

    def k4(K, D, h, Q, ln_k):
        def make(full):
            M, inner, dh = 64800 if full else 2048, D, D // h
            lnk = (None, None)
            if ln_k:
                lnk = ((1 + rn(inner, std=0.1, dtype=f32)).requires_grad_(),
                       leaf(inner, std=0.1, dtype=f32))
            return (leaf(K, M, D, dtype=f32), leaf(D, inner, std=0.05, dtype=f32),
                    leaf(D, inner, std=0.05, dtype=f32), leaf(Q, h, dh, dtype=f32),
                    leaf(inner, D, std=0.05, dtype=f32),
                    (1 + rn(D, std=0.1, dtype=f32)).requires_grad_(),
                    leaf(D, std=0.1, dtype=f32), leaf(Q, D, dtype=f32), *lnk)
        return make

    def k4_call(fn):
        def call(ctx, wk, wv, qh, wout, l1w, l1b, q, lw, lb):
            return fn(ctx, wk, wv, qh, wout, l1w, l1b, q, scale=qh.shape[-1] ** -0.5,
                      value_bf16=True, lnk=None if lw is None else (lw, lb))
        return call

    yield ("roll3d", "(1,4,24,48,512) shifts (-1,-3,-6); timed (1,4,180,360,512)",
           lambda x: roll.roll3d(x, (-1, -3, -6)), lambda x: roll.roll3d_plain(x, (-1, -3, -6)),
           lambda full: (leaf(1, *grid(full), 512),), True)
    for masked, t in ((True, True), (False, False)):
        label = f"{'masked' if masked else 'unmasked'}, {'tail' if t else 'no tail'}"
        yield ("window_attention", f"(1,4,24,48,512) heads 8, {label}; timed (1,4,180,360,512)",
               k2_call(wa.window_attention_tail), k2_call(wa.window_attention_tail_plain),
               k2(masked, t), t)
        yield ("window_attention_windowed",
               f"(1,32,144,512) heads 8, {label}; timed (1,1800,144,512)",
               k6_call(wa.window_attention_windowed), k6_call(wa.window_attention_windowed_plain),
               k6(masked, t), t)
    yield ("sdpa_windows", "(1,32,144,1536) heads 8, masked; timed (1,1800,144,1536)",
           lambda qkv, g: wa.sdpa_windows(qkv, g, 8), lambda qkv, g: wa.sdpa_windows_plain(qkv, g, 8),
           lambda full: (leaf(1, 1800 if full else 32, 144, 1536),
                         window_group_ids(*grid(full), ws, ss)), True)
    film = lambda: (leaf(1, 512, std=0.1, dtype=f32), leaf(1, 512, dtype=f32))  # noqa: E731
    yield ("mlp_adaln_residual", "(1,4096,512) hidden 2048; timed (1,259200,512)",
           mlp.mlp_adaln_residual, mlp.mlp_adaln_residual_plain,
           lambda full: (*mlp_args(full), *film()), True)
    yield ("mlp_fused", "(1,4096,512) hidden 2048; timed (1,259200,512)",
           mlp.mlp_fused, mlp.mlp_fused_plain, mlp_args, True)
    yield ("linear_adaln_residual", "(1,4096,512); timed (1,259200,512)",
           mlp.linear_adaln_residual, mlp.linear_adaln_residual_plain,
           lambda full: (leaf(1, rows(full), 512), leaf(512, 512, std=0.02),
                         leaf(512, std=0.02, dtype=f32), leaf(1, rows(full), 512), *film()),
           True)
    for label, K, D, h, Q, ln_k in (("agg", 13, 512, 16, 3, False), ("agg", 13, 512, 16, 3, True),
                                    ("de-agg", 3, 1024, 16, 13, False)):
        yield ("perceiver_core",
               f"{label} ctx ({K},2048,{D}) Q {Q}{', ln_k' if ln_k else ''}; timed M 64800",
               k4_call(resampler.perceiver_core), k4_call(resampler.perceiver_core_plain),
               k4(K, D, h, Q, ln_k), label == "de-agg")


def grad_errs(got, want, name) -> list[float]:
    """The check's error of each input's gradient (see GRAD_TOL and GRAD_FLOOR)."""
    import torch

    if name == "roll3d":
        return [0.0 if torch.equal(a, b) else float("inf") for a, b in zip(got, want)]
    scale = max(b.float().abs().max().item() for b in want)
    errs = []
    for a, b in zip(got, want):
        diff = (a.float() - b.float()).abs()
        if a.dtype == torch.bfloat16:  # less one bf16 ulp of the larger of the two
            mant, exp = torch.frexp(torch.maximum(a.float().abs(), b.float().abs()))
            diff = (diff - torch.where(mant > 0, torch.ldexp(torch.ones_like(diff), exp - 8),
                                       0.0)).clamp_min(0)
        errs.append(diff.max().item() / max(b.float().abs().max().item(), GRAD_FLOOR * scale))
    return errs


def run_grad_phases() -> dict:
    """K1-K8's gradients through their ``Function`` against autograd of their plain versions
    on the card, every differentiable input; the backward's time (the recompute with bf16
    products, :mod:`aurora_tpu_torch.ops.ad`) and plain autograd's (f32 products) at the main
    path's shape. Returns per kernel: the worst error and the first case's times."""
    import torch

    from aurora_tpu_torch.ops import _lib
    from aurora_tpu_torch.tools import time_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def rn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    def grads(out, leaves, g):
        return torch.autograd.grad(out, leaves, g, retain_graph=True)

    t0 = time.perf_counter()
    out_summary: dict = {}
    for name, label, call, plain, make, timed in grad_cases(rn):
        args = make(False)
        leaves = [a for a in args if isinstance(a, torch.Tensor) and a.requires_grad]
        before = dict(_lib.LAUNCHES)
        out = call(*args)
        node = type(out.grad_fn).__name__
        if node not in ("_KernelGradBackward", "_RollBackward"):
            raise AssertionError(f"grad {name} {label}: the output's node is {node}, not the "
                                 f"kernel's Function")
        g = rn(*out.shape, dtype=out.dtype)
        got = grads(out, leaves, g)
        want = grads(plain(*args), leaves, g)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in _lib.LAUNCHES.items() if v != before[k]}
        errs = grad_errs(got, want, name)
        finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
        tol = GRAD_TOL.get(name, 6e-3)
        del out, got, want, args, leaves
        times = {}
        if timed:  # the backward alone, at the main path's shape: the graph kept, rerun
            # The last timed run of each backward is kept and the two are held to each other
            # as above: the main path's shape is where the chunk plans cut into several
            # chunks, which the cut shapes never do.
            targs = make(True)
            tleaves = [a for a in targs if isinstance(a, torch.Tensor) and a.requires_grad]
            out = call(*targs)
            g = rn(*out.shape, dtype=out.dtype)
            kept = {}
            times["bwd_ms"] = time_ms(lambda: kept.update(got=grads(out, tleaves, g)), dev,
                                      BWD_REPS, warmup=1)
            del out
            torch.cuda.empty_cache()
            ref = plain(*targs)
            times["plain_bwd_ms"] = time_ms(lambda: kept.update(want=grads(ref, tleaves, g)),
                                            dev, BWD_REPS, warmup=1)
            times["bwd_shape"] = label.split("timed ")[-1]
            del ref, targs, tleaves, g
            times["bwd_rel_err"] = grad_errs(kept["got"], kept["want"], name)
            finite = finite and all(bool(torch.isfinite(a.float()).all()) for a in kept["got"])
            del kept
            torch.cuda.empty_cache()
        worst = max(errs + times.get("bwd_rel_err", []))
        ok = finite and worst <= tol
        emit(dict(phase="grad", kernel=name, shape=label, ok=ok, rel_err=errs, tol=tol,
                  node=node, launches=launched, **times))
        if not ok:
            raise AssertionError(f"grad {name} {label}: errors {errs}, at the timed shape "
                                 f"{times.get('bwd_rel_err')} (bound {tol}), finite {finite}")
        s = out_summary.setdefault(name, dict(grad_err=0.0))
        s.update(times)
        s["grad_err"] = max(s["grad_err"], worst)
    emit(dict(phase="grad", seconds=time.perf_counter() - t0))
    return out_summary


class _Watched:
    """The recipe's optimiser (``adamw(3e-4)`` over the LoRA banks) that also notes, at each
    update, every trainable gradient's norm and whether it is finite; ``update=False`` only
    notes them and clears the gradients (the weights keep their values). Binding it freezes
    the base model, as the recipe's optimiser does."""

    def __init__(self, update: bool = True):
        from aurora_tpu_torch.training import adamw, lora_mask

        self.opt = adamw(3e-4, trainable=lora_mask)
        self.update = update
        self.seen: list[dict] = []
        self.grads: dict = {}

    def init(self, model):
        self.opt.init(model)
        self.params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        return self

    def step(self):
        import torch

        self.grads = {n: p.grad for n, p in self.params.items()}
        norms = torch.stack([g.float().norm(dim=tuple(range(1, g.dim()))) for g in
                             self.grads.values()]).cpu()  # (params, banks)
        self.seen.append(dict(zip(self.grads, norms)))
        if self.update:
            self.opt.step()
        else:
            for p in self.params.values():
                p.grad = None


def _frozen_snapshot(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}


def run_train_step_phase() -> dict:
    """The production model's LoRA train step at full width, as ``tools.train_bench`` runs
    it (``remat`` at the JAX recipe's scope "full"): a warm-up step, then TRAIN_STEPS timed;
    every LoRA parameter a finite, non-zero gradient at every step, and moved; every frozen
    parameter its bits; the losses finite; each step's launches the derived count; peak
    memory under 80 GB."""
    import torch

    from aurora_tpu_torch.tools import train_bench
    from aurora_tpu_torch.training import make_train_step

    t0 = time.perf_counter()
    cfg = train_bench.train_config()
    model = train_bench.build(cfg, "cuda", "lora")
    (surf, static, atmos, batch), (tgt_s, tgt_a) = train_bench.inputs(model, 721, 1440)
    enc = model.prepare_encodings(batch, torch.float32)
    levels = tuple(float(x) for x in batch.metadata.atmos_levels)
    opt = _Watched()
    step = make_train_step(model, opt, levels)
    lora0 = {n: p.detach().clone() for n, p in opt.params.items()}
    frozen = _frozen_snapshot(model)
    tgt_s = {k: v[0] for k, v in tgt_s.items()}
    tgt_a = {k: v[0] for k, v in tgt_a.items()}
    row = train_bench.run_steps(
        lambda i: step(surf, static, atmos, enc, i % 3, tgt_s, tgt_a), TRAIN_STEPS,
        torch.device("cuda"))
    _check_train(model, opt, lora0, frozen, row, train_bench.expected_launches(cfg, lora=True),
                 dict(phase="train", part="LoRA train step", grid="721x1440 (720x1440)",
                      remat_scope=cfg.remat_scope, seconds=time.perf_counter() - t0))
    return model, (surf, static, atmos, enc, levels, tgt_s, tgt_a)


def run_stochastic_step_phase(model, inputs) -> dict:
    """The LoRA train step of the production model at full width and depth with stochastic
    depth (``drop_path`` STO_DROP_PATH, ``drop_rate`` 0: the LoRA train step's model with the
    knob set) on its inputs, one step at 721 x 1440 with a generator: its launches as
    ``expected_launches(stochastic=True)`` derives them (K1 in every shifted block, K2 and K3
    only in the two blocks at rate 0), every LoRA parameter a finite, non-zero gradient and
    moved, the frozen ones their bits, peak memory under 80 GB. A block whose attention
    branch the draw dropped (the batch holds one element) gives its LoRA adapters a zero
    gradient: the draws are recorded, and those adapters must have exactly zero."""
    import torch

    from aurora_tpu_torch.model import nn as tnn
    from aurora_tpu_torch.ops import _lib
    from aurora_tpu_torch.tools import train_bench
    from aurora_tpu_torch.training import make_train_step

    t0 = time.perf_counter()
    draw, drops = tnn.keep_mask, {}

    def recorded(shape, keep, seed, path, device):
        mask = draw(shape, keep, seed, path, device)
        if path[-1] == 0:  # dp1: the attention branch's stochastic depth
            drops[path[:-1]] = not bool(mask.any())
        return mask

    model.set_knobs(drop_path=STO_DROP_PATH)
    cfg = model.cfg
    surf, static, atmos, enc, levels, tgt_s, tgt_a = inputs
    opt = _Watched()
    step = make_train_step(model, opt, levels)
    lora0 = {n: p.detach().clone() for n, p in opt.params.items()}
    frozen = _frozen_snapshot(model)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = dict(_lib.LAUNCHES)
    tnn.keep_mask = recorded
    try:
        t1 = time.perf_counter()
        loss = float(step(surf, static, atmos, enc, 0, tgt_s, tgt_a, generator=gen))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
    finally:
        tnn.keep_mask = draw
    dropped = set()
    for (stage, block), gone in drops.items():
        layers = f"encoder_layers.{stage}" if stage < 100 else f"decoder_layers.{stage - 100}"
        if gone:
            dropped |= {n for n in opt.params if n.startswith(f"backbone.{layers}.blocks.{block}.")}
    launched = {k: v - before[k] for k, v in _lib.LAUNCHES.items() if v != before[k]}
    row = dict(times=[secs], s_per_step=secs, peak_mem_gib=torch.cuda.max_memory_allocated()
               / 2**30, losses=[loss], warmup_s=None, launches_per_step=[launched])
    return _check_train(model, opt, lora0, frozen, row,
                        train_bench.expected_launches(cfg, lora=True, stochastic=True),
                        dict(phase="train", part="stochastic LoRA train step",
                             grid="721x1440 (720x1440)", drop_path=cfg.drop_path,
                             drop_rate=cfg.drop_rate, remat_scope=cfg.remat_scope,
                             note="one step, the first at these knobs",
                             stochastic_blocks=len(drops),
                             attention_branches_dropped=sum(drops.values()),
                             seconds=time.perf_counter() - t0), dropped)


def _check_train(model, opt, lora0, frozen, row, expected, line, dropped=frozenset()) -> dict:
    """``dropped``: the LoRA parameters of blocks whose attention branch stochastic depth
    dropped, whose gradient must be zero (and which then do not move)."""
    import numpy as np
    import torch

    from aurora_tpu_torch.tools import train_bench

    bad_grad = sorted({n for seen in opt.seen for n, v in seen.items()
                       if not (torch.isfinite(v).all() and ((v == 0).all() if n in dropped
                                                            else (v > 0).any()))})
    still = sorted(n for n, p in opt.params.items()
                   if torch.equal(p, lora0[n]) and n not in dropped)
    moved = sorted(n for n, p in model.named_parameters() if n in frozen
                   and not torch.equal(p, frozen[n]))
    wrong = train_bench.launch_mismatches(row["launches_per_step"], expected)
    emit(dict(line, **{k: row[k] for k in ("times", "s_per_step", "peak_mem_gib", "losses",
                                           "warmup_s")}, dropped_lora_params=len(dropped),
              launches_per_step=row["launches_per_step"][-1], expected_launches=expected,
              lora_params=len(opt.params), frozen_params=len(frozen)))
    if bad_grad or still or moved or wrong or not np.all(np.isfinite(row["losses"])) or \
            not row["peak_mem_gib"] < 80e9 / 2**30:
        raise AssertionError(f"{line['part']}: gradients zero or not finite {bad_grad[:4]}, "
                             f"LoRA not moved {still[:4]}, frozen moved {moved[:4]}, launches "
                             f"wrong at steps {wrong}, losses {row['losses']}, peak "
                             f"{row['peak_mem_gib']} GiB")
    return row


def run_rollout_train_phase() -> dict:
    """A K = ROLLOUT_K roll-out train step with ``lora_mode="all"`` at full width,
    ROLLOUT_UPDATES updates: each step's bank a non-zero gradient, bank 0's gradient not bank
    1's, the checks of the single step."""
    import torch

    from aurora_tpu_torch.tools import rollout_train_bench, train_bench
    from aurora_tpu_torch.training import make_rollout_train_step

    t0 = time.perf_counter()
    K = ROLLOUT_K
    cfg = train_bench.train_config(lora_mode="all").replace(**TWO_BLOCKS)
    model = train_bench.build(cfg, "cuda", "lora")
    (surf, static, atmos, batch), (tgt_s, tgt_a) = train_bench.inputs(model, 721, 1440, K)
    enc = model.prepare_encodings(batch, torch.float32)
    abs_t, dyn = rollout_train_bench.step_encodings(model, batch, K)
    levels = tuple(float(x) for x in batch.metadata.atmos_levels)
    opt = _Watched()
    step = make_rollout_train_step(model, opt, levels, K)
    lora0 = {n: p.detach().clone() for n, p in opt.params.items()}
    frozen = _frozen_snapshot(model)
    banks_differ = []

    def update(i):
        loss = step(surf, static, atmos, enc, abs_t, 0, tgt_s, tgt_a, dyn)
        banks_differ.append(all(not torch.equal(g[0], g[1]) for g in opt.grads.values()))
        return loss

    row = train_bench.run_steps(update, ROLLOUT_UPDATES - 1, torch.device("cuda"))
    banks = {n: v[:K].tolist() for n, v in opt.seen[-1].items()}
    dead = sorted(n for n, v in banks.items() if not min(v) > 0)
    row = _check_train(model, opt, lora0, frozen, row,
                       train_bench.expected_launches(cfg, lora=True, K=K),
                       dict(phase="train", part=f"roll-out train step, K = {K}",
                            grid="721x1440 (720x1440)", lora_mode="all",
                            depths=(cfg.encoder_depths, cfg.decoder_depths),
                            remat_scope=cfg.remat_scope, banks_differ=banks_differ,
                            seconds=time.perf_counter() - t0))
    if dead or not all(banks_differ):
        raise AssertionError(f"roll-out train step: banks without a gradient {dead[:4]}, bank 0 "
                             f"and 1 gradients differ {banks_differ}")
    return row


def run_train_references() -> dict:
    """The card against the port's CPU run: the recipe's model at two blocks per backbone
    stage (the second shifted), seeded on the card, one LoRA train step at 121 x 240 without
    remat (the rematerialisation is the same arithmetic, held in float64 on the CPU by the
    tests), on each device deterministic and then with STO_REF's stochastic knobs; the loss
    within TRAIN_LOSS_TOL relative and the concatenated LoRA gradient within TRAIN_GRAD_TOL
    relative L2 error. The stochastic steps take a generator of the same seed on both
    devices and draw every mask on the CPU (``nn.keep_mask`` wrapped to draw there and move
    the mask to the step's device), so that the two runs drop the same branches and
    elements; every block then runs the stochastic route (K1, plain attention and MLP), the
    perceivers K4 and K3."""
    import torch

    from aurora_tpu_torch.model import nn as tnn
    from aurora_tpu_torch.ops import _lib
    from aurora_tpu_torch.tools import train_bench
    from aurora_tpu_torch.training import make_train_step

    t0 = time.perf_counter()
    cfg = train_bench.train_config(remat=False).replace(**TWO_BLOCKS)
    model = train_bench.build(cfg, "cuda", "lora")
    H, W = TRAIN_REF_GRID
    results, seconds = {}, {}
    draw = tnn.keep_mask
    tnn.keep_mask = lambda shape, keep, seed, path, device: draw(
        shape, keep, seed, path, "cpu").to(device)
    try:
        for dev in ("cuda", "cpu"):
            model = model.to(dev)
            (surf, static, atmos, batch), (tgt_s, tgt_a) = train_bench.inputs(model, H, W)
            enc = model.prepare_encodings(batch, torch.float32)
            levels = tuple(float(x) for x in batch.metadata.atmos_levels)
            for stochastic in (False, True):
                t1 = time.perf_counter()
                model.set_knobs(**(STO_REF if stochastic else dict.fromkeys(STO_REF, 0.0)))
                opt = _Watched(update=False)
                step = make_train_step(model, opt, levels)
                gen = torch.Generator().manual_seed(0) if stochastic else None
                before = dict(_lib.LAUNCHES)
                loss = step(surf, static, atmos, enc, 0, {k: v[0] for k, v in tgt_s.items()},
                            {k: v[0] for k, v in tgt_a.items()}, generator=gen)
                launched = {k: v - before[k] for k, v in _lib.LAUNCHES.items()
                            if v != before[k]}
                flat = torch.cat([g.float().flatten().cpu() for g in opt.grads.values()])
                results[dev, stochastic] = (float(loss), flat, launched)
                seconds[dev, stochastic] = time.perf_counter() - t1
            torch.cuda.empty_cache()
    finally:
        tnn.keep_mask = draw
    out, bad = {}, []
    for stochastic in (False, True):
        (lc, gc, launched), (lp, gp, _) = results["cuda", stochastic], results["cpu", stochastic]
        loss_err = abs(lc - lp) / abs(lp)
        grad_err = ((gc - gp).norm() / gp.norm()).item()
        knobs = STO_REF if stochastic else {}
        emit(dict(phase="train", part="stochastic card vs CPU" if stochastic else "card vs CPU",
                  grid=f"{H}x{W}", depths=(cfg.encoder_depths, cfg.decoder_depths), **knobs,
                  loss_card=lc, loss_cpu=lp, loss_rel_err=loss_err, lora_grad_rel_l2=grad_err,
                  tol=(TRAIN_LOSS_TOL, TRAIN_GRAD_TOL), launches=launched,
                  step_s=dict(card=seconds["cuda", stochastic], cpu=seconds["cpu", stochastic]),
                  seconds=time.perf_counter() - t0))
        need = ("roll3d", "roll3d_bwd", "mlp_adaln_residual", "perceiver_core")
        if not stochastic:
            need += ("window_attention",)
        missing = [k for k in need if not launched.get(k)]
        fused = stochastic and launched.get("window_attention")
        if missing or fused or not (loss_err <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL):
            bad.append(f"{knobs}: loss {loss_err}, LoRA gradient {grad_err}, kernels never "
                       f"launched {missing}, K2 in stochastic blocks {fused}")
        out[stochastic] = dict(loss_rel_err=loss_err, lora_grad_rel_l2=grad_err)
    if bad:
        raise AssertionError(f"train card vs CPU: {bad}")
    return out


def run_card_draws() -> dict:
    """KEEP_DRAWS Bernoulli(KEEP_RATE) draws on the card through ``nn.keep_mask``: the kept
    fraction within 5 binomial standard deviations; the same seed and path the same mask,
    another path another."""
    from aurora_tpu_torch.model import nn as tnn

    t0 = time.perf_counter()
    mask = tnn.keep_mask((KEEP_DRAWS,), KEEP_RATE, 7, (0, 1, 2), "cuda")
    kept = mask.float().mean().item()
    sd = (KEEP_RATE * (1 - KEEP_RATE) / KEEP_DRAWS) ** 0.5
    again = bool((mask == tnn.keep_mask((KEEP_DRAWS,), KEEP_RATE, 7, (0, 1, 2), "cuda")).all())
    other = bool((mask != tnn.keep_mask((KEEP_DRAWS,), KEEP_RATE, 7, (0, 1, 3), "cuda")).any())
    emit(dict(phase="train", part="card draws", draws=KEEP_DRAWS, keep=KEEP_RATE, kept=kept,
              binomial_sd=sd, same_seed_same_mask=again, other_path_other_mask=other,
              seconds=time.perf_counter() - t0))
    if not (abs(kept - KEEP_RATE) <= 5 * sd and again and other):
        raise AssertionError(f"card draws: kept {kept} of {KEEP_RATE} (sd {sd}), repeat "
                             f"{again}, other path differs {other}")
    return dict(kept=kept)


def run_train_phases() -> dict:
    """The phase ``train``: the kernels' gradients, the full-width LoRA and roll-out train
    steps, the card against the CPU. Returns the gradient phases' summary, which the kernels
    line reads."""
    import torch

    t0 = time.perf_counter()
    grads = run_grad_phases()
    model, inputs = run_train_step_phase()
    torch.cuda.empty_cache()
    run_stochastic_step_phase(model, inputs)
    del model, inputs
    torch.cuda.empty_cache()
    run_rollout_train_phase()
    torch.cuda.empty_cache()
    run_train_references()
    run_card_draws()
    emit(dict(phase="train", seconds=time.perf_counter() - t0))
    return dict(grads=grads)


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


# ------------------------------------------------------------------------------ variants

MANIFESTS = "tests/data/ckpt_manifests.json"
# Launches per forward step of the released variants, from the code: K1 twice in each shifted
# block (half the blocks), K2 once a block, K3 once a block plus once in each perceiver's
# MLP half, K4 once in the aggregation and once in each de-aggregation. AirPollution
# de-aggregates twice (``level_decoder_alternate`` for the chemistry variables and their
# ``_mod`` heads); the wave model's aggregation is K4 with ``ln_k``, one count as without it;
# HighRes has stage depths (6, 8, 8) / (8, 8, 6), 44 blocks.
_B48 = {"roll3d": 48, "window_attention": 48}
_B44 = {"roll3d": 44, "window_attention": 44}
VARIANT_RUNS = {  # name: (facade, full grid, reference grid, launches per step)
    "pollution": ("AuroraAirPollution", (451, 900), (121, 240),
                  {**_B48, "mlp_adaln_residual": 51, "perceiver_core": 3}),
    "wave": ("AuroraWave", (721, 1440), (121, 240),
             {**_B48, "mlp_adaln_residual": 50, "perceiver_core": 2}),
    "highres": ("AuroraHighRes", (1801, 3600), (241, 480),
                {**_B44, "mlp_adaln_residual": 46, "perceiver_core": 2}),
    "12h": ("Aurora12hPretrained", (721, 1440), (121, 240),
            {**_B48, "mlp_adaln_residual": 50, "perceiver_core": 2}),
}
# The variant loaded from a reference-format ``.ckpt`` file (the most schema migrations);
# the others pass their state dict in memory through the same converter.
VIA_FILE = "pollution"
NAN_FLIP_TOL = 5e-2  # share of points whose wave NaN mask differs between the card and CPU


def reference_weights(manifest: dict, cfg, seed: int) -> dict:
    """A released checkpoint's keys and shapes (``tests/data/ckpt_manifests.json``) filled
    with seeded values at the scale of the port's own init, in reference format (torch
    names and layouts, float32 numpy on the host): linear weights N(0, 0.02) clipped at 2
    sigma, biases N(0, 0.02), LayerNorm weights 1, patch-embed kernels and biases and LoRA
    ``A`` uniform(+-1/sqrt(fan in)), the feature combiners at 0.5 / 0; the FiLM modulations
    and LoRA ``B`` opened at N(0, 0.05), as ``perf_breakdown.build_model`` opens them. Made
    on the card in one pool and copied to the host once."""
    import math

    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    sizes = {k: math.prod(s) for k, s in manifest.items()}
    pool = torch.empty(sum(sizes.values()), device="cuda")
    patch_fan = cfg.max_history_size * cfg.patch_size**2
    spans, off = {}, 0
    for k, shape in manifest.items():
        seg = pool[off:off + sizes[k]]
        spans[k] = (off, tuple(shape))
        off += sizes[k]
        if "feature_combiner" in k:
            seg.fill_(0.5 if k.endswith("weight") else 0.0)
        elif k.endswith("lora_B") or "ln_modulation" in k and k.endswith("weight"):
            seg.normal_(0.0, 0.05, generator=g)
        elif k.endswith("lora_A"):
            b = 1 / math.sqrt(shape[-1])
            seg.uniform_(-b, b, generator=g)
        elif "token_embeds" in k:  # (D, 1, T, P, P) kernels and their bias
            b = 1 / math.sqrt(patch_fan)
            seg.uniform_(-b, b, generator=g)
        elif len(shape) == 1 and k.endswith("weight"):  # LayerNorm
            seg.fill_(1.0)
        else:
            seg.normal_(0.0, 0.02, generator=g).clamp_(-0.04, 0.04)
    host = pool.cpu().numpy()
    del pool
    return {k: host[o:o + math.prod(s)].reshape(s) for k, (o, s) in spans.items()}


def type_of(name: str):
    """The facade class of a variant."""
    import aurora_tpu_torch

    return getattr(aurora_tpu_torch, VARIANT_RUNS[name][0])


def load_variant(name: str, manifest: dict):
    """The production model of one released variant on the card, with its weights loaded
    through the port's checkpoint code: from a ``.ckpt`` file for ``VIA_FILE``, else the
    state dict in memory through ``convert_reference_checkpoint``. Returns the model and a
    dict of what the load took."""
    import tempfile
    from pathlib import Path

    import torch

    from aurora_tpu_torch import cast_backbone_params
    from aurora_tpu_torch.checkpoint import convert_reference_checkpoint
    from aurora_tpu_torch.convert import load_numpy_params
    from aurora_tpu_torch.tools.perf_breakdown import production_config

    cls = type_of(name)
    cfg = production_config(cls.default_config())
    t0 = time.perf_counter()
    sd = reference_weights(manifest, cfg, seed=0)
    info = dict(weights_s=time.perf_counter() - t0,
                values=sum(v.size for v in sd.values()))
    model = cls(cfg, device="cuda", seed=None)
    t0 = time.perf_counter()
    if name == VIA_FILE:
        with tempfile.TemporaryDirectory() as d:
            path = Path(d) / cls.default_checkpoint_name
            torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
            info.update(via="file", file=path.name, file_bytes=path.stat().st_size,
                        save_s=time.perf_counter() - t0)
            del sd
            t0 = time.perf_counter()
            model.load_checkpoint_local(path)
            torch.cuda.synchronize()
            info["load_s"] = time.perf_counter() - t0
    else:
        load_numpy_params(model, convert_reference_checkpoint(sd, cfg))
        torch.cuda.synchronize()
        info.update(via="memory", load_s=time.perf_counter() - t0)
        del sd
    return cast_backbone_params(model), info


def expected_outputs(cfg) -> tuple[set, set]:
    """The variables a prediction of ``cfg``'s model holds after its hooks: the user's raw
    variables (the wave model's angles and densities folded back), no ``_mod`` head."""
    surf = cfg.surf_vars
    if cfg.variant == "wave":
        surf = ("2t", "10u", "10v", "msl") + cfg.density_channel_surf_vars
    return set(surf), set(cfg.atmos_vars)


def run_variant(name: str, manifest: dict, steps: int) -> None:
    """One released variant: the weights through the checkpoint path, a roll-out of
    ``steps`` steps at its full grid through the tools (launches per step checked, counts set
    to 0 just before), the outputs' variables, shapes and values, then the same weights on
    the reference grid against the port's own CPU run."""
    import torch

    from aurora_tpu_torch.ops import _lib
    from aurora_tpu_torch.tools import highres_bench, variant_bench

    facade, (H, W), (h, w), expected = VARIANT_RUNS[name]
    model, info = load_variant(name, manifest)
    cfg = model.cfg
    _lib.reset_launches()
    if name in variant_bench.VARIANTS:
        r = variant_bench.main(["--variants", name, "--steps", str(steps)],
                               models={name: model})[0]
    elif name == "highres":
        r = highres_bench.main(["--steps", str(steps)], model=model)[0]
    else:  # The 12 h model: the base variables, through the same roll-out.
        r = variant_bench.run_rollout(model, variant_bench.raw_batch(cfg, H, W, device="cuda"),
                                      steps)
    launches = dict(_lib.LAUNCHES)
    for i, got in enumerate(r["launches_per_step"]):
        if got != expected:
            raise AssertionError(f"variant {name} step {i}: launches {got} != {expected}")
    surf, atmos = expected_outputs(cfg)
    Hc, Wc = H - H % cfg.patch_size, W
    want_shapes = {**{k: [1, 1, Hc, Wc] for k in surf},
                   **{k: [1, 1, len(LEVELS), Hc, Wc] for k in atmos}}
    if r["outputs"] != want_shapes:
        raise AssertionError(f"variant {name}: outputs {r['outputs']} != {want_shapes}")
    may_nan = set(cfg.density_channel_surf_vars)
    bad = {k: (r["nan_points"][k], r["inf_points"][k]) for k in want_shapes
           if r["inf_points"][k] or (r["nan_points"][k] and k not in may_nan)}
    if bad or r["rollout_step"] != steps:
        raise AssertionError(f"variant {name}: non-finite outputs {bad}")
    emit(dict(phase="variant", variant=name, facade=facade, grid=f"{H}x{W}",
              patch_size=cfg.patch_size, params=sum(p.numel() for p in model.parameters()),
              **info, steps=steps, step_s=r["step_s"], peak_mem_gib=r["peak_mem_gib"],
              launches_per_step=r["launches_per_step"][-1], expected_per_step=expected,
              launches=launches, nan_points={k: v for k, v in r["nan_points"].items() if v}))

    # The reference: the variant's own config, widths, hooks and grid at two blocks per
    # backbone stage (one unshifted, one shifted: K1 and K2's masked attention run on the
    # variant's own token grid), seeded on the card, on the reference grid; the card against
    # the port's CPU run of the same weights.
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    shallow = cfg.replace(encoder_depths=(2,) * len(cfg.encoder_depths),
                          decoder_depths=(2,) * len(cfg.decoder_depths))
    model = variant_bench.build_variant(type_of(name), "cuda", cfg=shallow)
    small = variant_bench.raw_batch(cfg, h, w, seed=1, absolute=name != "highres")
    before = dict(_lib.LAUNCHES)
    got = model(small)
    torch.cuda.synchronize()
    ref_launches = {k: n - before[k] for k, n in _lib.LAUNCHES.items() if n != before[k]}
    cpu = model.to("cpu")
    del model
    torch.cuda.empty_cache()
    want = cpu(small)
    del cpu
    errs, flips = {}, {}
    for k in sorted(surf | atmos):
        g = (got.surf_vars if k in surf else got.atmos_vars)[k].double().cpu()
        c = (want.surf_vars if k in surf else want.atmos_vars)[k].double()
        both = torch.isfinite(g) & torch.isfinite(c)
        errs[k] = _mean_rel(g[both], c[both])
        flips[k] = int((torch.isnan(g) != torch.isnan(c)).sum())
    worst = max(errs.values())
    flip_share = sum(flips.values()) / sum(v.numel() for v in {
        **want.surf_vars, **want.atmos_vars}.values())
    emit(dict(phase="reference", variant=name, grid=f"{h}x{w}",
              depths=(shallow.encoder_depths, shallow.decoder_depths), launches=ref_launches,
              against="port CPU run (plain versions)", mean_rel=errs, worst=worst, tol=1e-2,
              nan_mask_differs={k: v for k, v in flips.items() if v}, nan_flip_share=flip_share,
              seconds=time.perf_counter() - t0))
    missing = [k for k in ("roll3d", "window_attention") if not ref_launches.get(k)]
    if missing:
        raise AssertionError(f"variant {name}: the reference run never launched {missing}")
    if not worst <= 1e-2:
        raise AssertionError(f"variant {name}: card vs CPU: mean rel {worst} > 1e-2")
    # A density point flips where the predicted density is within the card's error of 1/2;
    # no other variable may be NaN on one side only.
    if flip_share > NAN_FLIP_TOL or any(v for k, v in flips.items() if k not in may_nan):
        raise AssertionError(f"variant {name}: NaN masks differ at {flips}")


def small_refused_on_card() -> None:
    """``AuroraSmallPretrained`` (D = 256) on the card with the production knobs: its forward
    raises the kernels' ``ValueError`` for the width before any kernel launches; nothing
    falls back to a plain version."""
    from aurora_tpu_torch import AuroraSmallPretrained
    from aurora_tpu_torch.ops import _lib
    from aurora_tpu_torch.tools import variant_bench
    from aurora_tpu_torch.tools.perf_breakdown import production_config

    model = AuroraSmallPretrained(production_config(AuroraSmallPretrained.default_config()),
                                  device="cuda")
    _lib.reset_launches()
    try:
        model(variant_bench.raw_batch(model.cfg, 121, 240, seed=1))
    except ValueError as e:
        launched = sum(_lib.LAUNCHES.values())
        emit(dict(phase="variant", variant="small", refused=str(e), launches=launched))
        if "256" not in str(e) or launched:
            raise AssertionError(f"AuroraSmallPretrained: refused for another reason: {e}")
        return
    raise AssertionError("AuroraSmallPretrained ran on the card")


def run_variants(steps: int) -> None:
    manifests = json.loads(open(MANIFESTS).read())
    t0 = time.perf_counter()
    for name, (facade, *_rest) in VARIANT_RUNS.items():
        run_variant(name, manifests[facade], steps)
    small_refused_on_card()
    emit(dict(phase="variants", seconds=time.perf_counter() - t0))


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
              name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
              cpu_threads=torch.get_num_threads(), cpus=os.cpu_count()))

    secs = _lib.build(force=True)
    ptxas = {}
    for n in _lib.SOURCES:
        lines = (_lib.BUILD_DIR / f"lib{n}.ptxas.txt").read_text().splitlines()
        ptxas[n] = [ln.strip() for ln in lines if "registers" in ln or "spill" in ln]
    emit(dict(phase="build", seconds=secs, ptxas=ptxas))

    seconds = {"build": secs}
    mark = time.perf_counter()

    def lap(phase: str) -> None:
        nonlocal mark
        now = time.perf_counter()
        seconds[phase] = now - mark
        mark = now

    summary = run_kernel_phases()
    lap("kernels")
    launches = {}
    for route in ROUTES:
        launches[route] = run_route(route, STEPS, (121, 240),
                                    then=run_main_phases if route == "main" else None)
        missing = [k for k, n in ROUTES[route][1].items() if launches[route][k] == 0]
        if missing:
            raise AssertionError(f"route {route}: kernels never launched: {missing}")
        lap(f"route {route}")
    train = run_train_phases()
    lap("train")
    launches["tools"] = run_tools()
    lap("tools")
    run_variants(STEPS)
    lap("variants")
    emit(dict(phase="seconds", **seconds, total=sum(seconds.values())))

    def entry(s: dict, n_launches: int) -> dict:
        more = {k: s[k] for k in ("bound_of_tpu_work_ms", "empty_kernel_ms", "byte_bound_ms")
                if k in s}
        return dict(launches=n_launches, max_abs_err=s["max_abs_err"], err=s["err"],
                    ms=s["ms"], plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
                    bound_by=max(s["by"], key=s["by"].get), library_ms=s["library_ms"], **more)

    kernels = []
    for name in TOL:
        src, replaces = SOURCES[name]
        home = HOME[name]
        main_mode = "tail" if (name, "tail") in summary else None
        # The backward (K1-K8): the worst gradient error of the train phase, the backward's
        # and plain autograd's ms at the main path's shape; none for the probe kernels.
        bwd = train["grads"].get(name, dict(grad_err=None, bwd_ms=None, plain_bwd_ms=None,
                                            bwd_shape=None, bwd_rel_err=None))
        e = dict(name=name, ok=True, route="cuda", source=src, replaces=replaces,
                 home_route=home, **entry(summary[name, main_mode],
                                          launches[home][name] if home else 0), **bwd)
        if (name, "no tail") in summary:
            # K2 without the tail runs on route P; K6 without it on no route driven here.
            n = launches["P"][name] if name == "window_attention" else 0
            e["no_tail"] = entry(summary[name, "no tail"], n)
        if (name, "ln_k") in summary:
            # K4 with ln_k is route S's aggregation: one of its two K4 launches a step.
            e["ln_k"] = entry(summary[name, "ln_k"], launches["S"][name] // 2)
        kernels.append(e)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
