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
   K7, ``torch.matmul`` for K12), median of REPS (5) runs after 2 warm-up runs (the plain
   version: its check's own call, once), and the bound
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
   last tile of rows; no count towards the sums). K5 also at the small model's D = 256 in
   bf16. The float32 forms of K1-K8 (the facades' default config, ``f32_cases``) at the
   1.3 B model's and the small model's shapes, each against its plain version with full-f32
   products (TF32 off): K1 the same bits, K2, K3, K5, K6, K7 and K8 within 9e-5 by the
   branch measure less one float32 ulp (no residual: over the largest output), K4 within
   1e-4, and the plain version with TF32 products must fail the same bound by the same
   measure (``tf32_control_err``); timed over 3 runs, the plain versions once (K7 also
   ``F.scaled_dot_product_attention`` in float32 on the same masked windows). Float32 K3,
   K8, K4 and K5, and K2's and K6's qkv and proj, take each product as three TF32 products of
   split operands: their bound is that work at the TF32 peak (K2/K6's core at the FFMA pipes'
   rate), the FFMA bound beside it (``ffma_bound_ms``); K7, the core alone, prints the bound
   of its products as three TF32 products beside its FFMA bound (``tf32x3_bound_ms``); at
   stage 1 and at D = 256 the weights' split that the card writes for K3, K2 and K6 must be
   ``mlp.tf32_split``'s bits of the same transposes, and so in every float32 case for K5's W
   and K4's Wv and Wout (K4 also prints the error of its last chunk's logits against a
   float64 product, ``logits_rel_err``; float32 K4 also at the air-pollution model's
   de-aggregation, (3, 45000, 1024) Q 13, and with ``ln_k`` at the aggregation, the wave
   model's one launch a step). K4 with its bias inputs (``bk``, ``bv``, ``bout``; no config
   creates them, so no path launches them) at the aggregation's (13, 64800, 512) Q 3,
   without and with ``ln_k``, in bf16 values (1e-2) and in float32 (1e-4). K6 on
   ``window_partition(xp)``, reversed, must give float32 K2's bits; in float32 garbage in
   stage 3's pad tokens may move a real token by a rounding (the plain version's too),
   within 1e-6 of the branch (K2, K6) or of the output (K7);
4. train (the card-against-CPU steps described last run first, so that their CPU half, on
   the host thread, overlaps the rest): K1-K8's gradients through their ``Function`` (the
   kernel forward, the backward of the plain math with bf16 products) against autograd of
   the plain versions on the card, every differentiable input, on inputs cut to a few
   thousand rows, windows or columns, and K3 once more with its tokens alone asking for a
   gradient (LoRA training), which its hand-written input gradient (``csrc/mlp_grad.cu``)
   takes, launched once, with the bound of its four products
   (FiLM at unit gain): max ``|Δ|`` over max ``|reference gradient|`` (at least 1e-3 of the
   call's largest, for a gradient that is zero in exact arithmetic), less one bf16 ulp for a
   bf16 gradient, within the forward's bounds (roll exact, bf16 6e-3, K4 1e-2), the output's
   autograd node the kernel's ``Function``; the backward's and plain autograd's times (the
   latter one call) at the main path's shape, where the chunk plans cut into several chunks,
   and the last timed result of each held to the other by the same measure and bound. Then
   the production
   model's LoRA train step at 721 x 1440 and two blocks per backbone stage (its full-depth
   time is ``tools.train_bench``'s) as ``tools.train_bench`` runs it (``remat`` at the
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
   card, the kept fraction within 5 binomial standard deviations. Float32 (the default
   config, ``Aurora()``: no ``autocast``, nothing cast to bf16, the backward's products full
   float32): K1-K8's gradients at the same cut shapes in float32 through their ``Function``
   against the plain math's in float64 on the same inputs, within 1e-4 relative L2 per input
   (for an input whose float64 gradient is below 1e-6 of the call's largest, such as ln_k's
   bias gradient, zero in exact arithmetic, against 1e-2 of the call's largest RMS gradient
   instead), every launch float32, and at the main path's shape
   one backward timed after a warm-up beside plain autograd's in float32; the default
   config's LoRA step (``remat`` "full") at two blocks a stage on 721 x 1440 (a warm-up and 1
   timed step, the bf16 step's checks, every launch and parameter float32); then the same
   model without remat, one step on 121 x 240 against the port's CPU run of it (queued on
   the host thread): loss within 1e-4 relative, LoRA gradient within 1e-3 relative L2;
5. end to end, once per route: the main route (``attention_impl``, ``mlp_impl`` auto, auto),
   then W (pallas_windowed, fused), P (pallas, pallas), X (xla, fused) and S (the main
   route with ``stabilise_level_agg=True``: K4 with ``ln_k``).
   Each runs the 1.3 B production config (LoRA, bf16 backbone stored in bf16, bf16
   (de-)aggregation values) at full width with the same seeded random weights, FiLM and LoRA
   gates opened, the main route at full depth and W, P, X, S at two blocks per backbone stage
   (the second shifted; every kernel still runs on every stage's token grid), ``rollout``
   over the 721 x 1440 / 13-level batch (made once); per-step time, peak memory, per-step
   launch counts (counts set to 0 just before the roll-out) checked against the code (scaled
   to the depth); outputs finite and of the right shape; then a 121 x 240 grid against the
   port's own CPU run of the same route: the route's model at two blocks per backbone stage
   (the second shifted), seeded on the card, whose reference run must launch every kernel of
   its route.
   After the main route's roll-out, the breakdown: ``perf_breakdown``, ``encoder_breakdown``
   and ``decoder_breakdown`` as a user runs them, in process, on the main route's model at
   720 x 1440 (one timed run of each part after 2 warm-ups; one JSON line per row, with the
   launches of one call of its part); the level aggregation and de-aggregation must have
   launched K4 and K3, the backbone K1-K3. Then the
   roll-outs, on the same model, as ``tools.bench`` measures them: ``rollout``,
   ``rollout_scan`` and ``rollout_scan(host_offload=True)``, 3 steps each from one
   721 x 1440 batch of host arrays (step times, peak memory, steps per second); launches per
   step as the main route's; the three the same bits step by step (or within 1e-3 mean
   relative); the host-offload peak within one prediction of a 2-step host-offload
   roll-out's; the caller's arrays unchanged.
   Then the drivers, on the same model: a 721 x 1440 initial condition written with
   ``Batch.to_netcdf`` (the land-sea mask 0 around the tracker's first fix), the
   command-line ``forecast`` (``aurora_tpu_torch.cli.main``, 2 steps, ``--track``) with its
   seconds split (reading, each step, each file's writing and bytes, the tracker), its files
   the same bits as ``rollout``'s predictions of the same model (or within 1e-3 mean
   relative) and its track the tracker's on the card's predictions and on their host copies;
   ``evaluate`` of step 2 against step 1 on the card (finite scores); ``Batch.regrid(1.0)``
   of a prediction with the native library built (one field through the scipy form beside
   it, within 1e-12); ``tools.rollout_bench`` at 3 steps; ``tools.train_speed_probe`` at
   121 x 240 over two arms. Every reference's CPU half (the CPU forward and the comparison)
   runs on one host thread while the card goes on (``_Deferred``); the run waits for them
   before its summary;
5b. float32: ``Aurora()`` in its default config (float32 all through, as the JAX package's
   CLI and registry build it), seeded, gates opened, ``rollout`` 2 steps over the same
   721 x 1440 batch: step times, peak memory, launches per step the main route's, every
   K1-K4 launch writing float32. Then the serving stack (the ``serving`` line): the
   model's weights written once with ``checkpoint.save_params`` as the artifact of the
   registry's ``aurora-0.25-finetuned``, ``foundry.http_server.serve`` on a loopback port with
   a token (a bad token must get 401), the port's ``FoundryClient`` + ``submit`` over a
   ``LocalFileChannel`` asking for 1 step of the batch written to netCDF and read back: the
   served task loads the artifact into the registry's model (the facade's default config)
   on the card, on the server's worker thread; the client's predictions must be the
   roll-out's bits, the served roll-out's launches the main route's a step (counts set to 0
   just before ``submit``), all on float32 tokens; the forecast's parts (the artifact's
   bytes and write time, the upload, the task's weight load and input read, each step and
   each prediction file's write and bytes, the polling wait, the client's read-back, submit
   to last prediction). Then the config at two blocks a stage (the second shifted), one
   model moved between routes by ``Aurora.set_knobs`` for routes W, P and X and a model of
   its own for route S (``stabilise_level_agg``: K4 with ``ln_k`` in the aggregation, which
   adds parameters): each route (``run_f32_route``) rolls out one step over the 721 x 1440
   batch with launches per step as ``route_launches`` derives them, every one on float32
   tokens; then the main route and those four on 121 x 240 against the port's CPU run:
   mean relative error <= 1e-4 per variable. Then ``AuroraPretrained()`` in its default
   config (float32, no LoRA), seeded, gates opened: one step at full depth over the same
   batch (launches the main route's, all float32), and its config at two blocks a stage on
   121 x 240 against the port's CPU run within 1e-4;
5d. deep_resampler: the 1.3 B model (D = 512) with resamplers of depth 2 (``enc_depth =
   dec_depth = 2``) at two blocks a backbone stage, with the production knobs and in
   ``Aurora``'s default config (float32), seeded, gates opened: one roll-out step each over
   the 721 x 1440 batch (counts set to 0 just before), launches per step as
   ``tools.train_bench.resampler_launches`` derives them (K3 two more than at depth 1, K4
   as many; under the production knobs the deeper layers' two K3 launches float32, the rest
   bf16), the outputs finite, float32, of the grid's shapes, peak memory; with the production
   knobs also layer 1 of the aggregation and of the de-aggregation alone at 64800 columns
   (``deeper_layer_ms``); then the same model on 121 x 240 against the port's CPU run, mean
   relative error per variable <= 1e-2 (bf16) and <= 1e-4 (float32);
5c. small:
   ``AuroraSmallPretrained`` (D = 256) twice, in its default config
   (``AuroraSmallPretrained()``, float32) and with the production knobs (bf16), seeded
   weights, each on the main route (a 2-step roll-out at 721 x 1440) and on route X (one
   step; ``set_knobs``), counts set to 0 just before each: step times, peak memory, launches
   per step against ``SMALL_RUN`` / ``SMALL_X_RUN`` and those at D = 256 (main: K2 4, K3 5,
   K4 1, ``SMALL_D256``; X: K5 4, K3 5, K4 1, ``SMALL_X_D256``) counted by width and dtype
   (every launch float32, or every launch bf16); then the same model, full depth, on both
   routes on the 121 x 240 grid against the port's CPU run, mean relative error <= 1e-4 in
   float32, <= 1e-2 in bf16. Its D = 256 kernel cases run in phase 3, in bf16 (K2 with the
   tail masked and unmasked and without it masked, K6, K3 in the backbone and the
   aggregation, K8, K5, K4 with and without ``ln_k``; K2 must give K6's bits) and in
   float32 (K2, K6, K7, K3, K8, K5, K4);
6. variants: the released models AirPollution (451 x 900,
   patch 3), Wave (721 x 1440), HighRes (1801 x 3600, patch 10) and 12h (721 x 1440), each
   at its full width, depth and grid in two forms of one set of weights: the facade's
   default config (float32 all through, ``default_config()`` asserted: the serving
   registry's and the command-line interface's model) and the production knobs (the model's
   parameters copied on the card, the backbone cast to bf16). The weights are each released
   checkpoint's keys and shapes (``tests/data/ckpt_manifests.json``) filled with seeded
   values at the scale of the port's init (FiLM and LoRA ``B`` opened), loaded in memory
   through the port's checkpoint code (``convert_reference_checkpoint``) into the float32
   model for AirPollution; the other three are seeded on the card (the converter is held bit
   for bit on the CPU). Each form rolls out 2 steps through ``tools.variant_bench`` /
   ``tools.highres_bench`` (12h through the same roll-out), counts set to 0 just before: step
   times, peak memory, launches per step checked against the code, every launch writing the
   form's dtype; the outputs are the user's variables after the hooks (no ``_mod``, sin/cos
   or density channel) at the right shapes, float32, finite but for the wave model's NaN
   where it predicts no waves. Then the variant's own config, widths, hooks and grid at two
   blocks per backbone stage (the second shifted: it must launch K1 and K2), seeded on the
   card (AirPollution's weights: the released checkpoint's keys of those blocks through a
   ``.ckpt`` file written with ``torch.save``, ``load_checkpoint_local``), in both forms, on
   a reference grid (121 x 240; HighRes 241 x 480) against the port's CPU run of the same
   weights: mean relative error per output variable where both are finite <= 1e-4 in
   float32, <= 1e-2 in bf16, and the points where the wave NaN masks differ (a density
   within the card's error of 1/2) at most 5%;
7. tools, beside the host thread's queue (their patches reach their own thread's calls
   only): the probe tools as a user runs them, in
   process, at the full 0.25 degree token grid: ``backbone_ablate`` with every variant,
   ``gemm_probe`` and ``smem_probe`` (counts set to 0 just before); K9-K13 must each have
   launched, and the backbones under ``attention_impl`` "pallas" and "pallas_windowed" must
   agree within the bf16 block bound; then ``kernel_slate``'s four rows (the patch
   embeddings in float32, the patch merge and split in bf16, at 720 x 1440 against their
   floors; no kernel of the port, no launch);
7b. parallel: ``tools.multihost_sim``'s two ranks, started beside the build and held there
   once their host side is ready (imports, the optimiser's first-step imports), released after
   every timed phase, so that nothing timed shares the card with them (one gloo group over a
   ``FileStore``, both on the one card, every collective on CUDA tensors), each on its half of the JAX tool's batch of 2
   on the tool's card layout, 13 levels on 121 x 240
   (``AuroraSmallPretrained(use_lora=True)`` in float32, ``make_mesh(data=2)``; K4 takes 13
   levels, not the JAX tool's 4, and the window kernels 144-token windows, which 33 x 64's
   smallest stage cannot hold), against the same work in this process on the whole batch: the
   forward and a one-step ``rollout``, the LoRA step's averaged gradients and its parameters
   where the gradient is resolved within 1e-5 max-rel, a K = 2 roll-out step's averaged
   gradients within the tool's ``ROLLOUT_GRAD_TOL``, the losses within 1e-6 relative, the
   full fine-tune step under ``shard_params`` (its probe within 1e-5, each rank's AdamW
   moments of a split parameter half of it), every rank launching K1-K4; then a one-rank NCCL group and one all-reduce;
7c. lat_lon: four ranks of ``tools.multihost_sim --config production`` under
   ``make_mesh(data=1, lat=2, lon=2)`` (one gloo group, all on the one card), started held
   once the build is done and released with the parallel phase's ranks (the two phases
   overlap on the card, after every timed phase), each with the main route's 1.3 B
   production model (the same seeded weights) on its block of the same 720 x 1440 batch:
   ``Aurora.forward`` and a 1-step ``rollout``, every prediction gathered (``gather_batch``)
   and held to the main route's one-process step 1, kept on the host, within 1e-2 mean
   relative error per variable; every rank launching K1-K4; the blocks seeing the second
   stage's over-pad by (0, 6, 12), its odd 45 rows at the merge, the third stage's uneven
   rows, halos over both lines and the first stage's shifted blocks sending 4 x 2,211,840
   bytes a rank; each rank's step times (four ranks sharing one card: not a scaling figure)
   and halo bytes per block; then, on the same ranks, (a) the train phase's bf16 LoRA step
   (two blocks a stage, remat "full", its 720 x 1440 batch) held to that phase's first step
   kept on the host (loss 1e-2 relative, the lat / lon-summed LoRA gradient 5e-2 relative L2)
   and (b) the float32 small model's LoRA and K = 2 roll-out steps on the parallel phase's
   121 x 240 batch of 2, held to that phase's one-process run (losses 1e-6 relative, LoRA
   gradients 1e-5 max-rel where |g| >= 1e-6, roll-out gradients 1e-4), every rank launching
   K1-K4 in each, with each rank's step time, halo bytes and what the gradient check reads
   had rank 0 skipped the plane's sum;
8. the seconds of each phase, then the kernels summary line, one entry per kernel (K1-K8:
   times per forward step, each shape's time times its launches per step on the route that
   runs it, ``launches`` the count over that route's roll-out, and the backward's
   ``grad_err`` (the worst over the cut shapes and ``bwd_shape``), ``bwd_ms``,
   ``plain_bwd_ms`` and ``bwd_rel_err`` (each input's error) at ``bwd_shape``, one call at
   the main path's shape (K3's input gradient the same keys and ``bound_ms`` under
   ``input_grad``), and the same keys for the float32 backward in the ``f32`` entry
   of the mode the train step runs; K9-K13: the sum over one sweep of the tool's cases,
   ``launches`` the count over the tools phase; K2 and K6 carry their no-tail mode under
   ``no_tail``, K4 its ``ln_k`` form under ``ln_k`` (launches: route S's aggregation; in
   float32 the wave model's), its bias forms under ``bias`` and ``ln_k, bias`` (launches 0)
   and the bound of the TPU kernel's work under
   ``bound_of_tpu_work_ms``; K2, K6, K3, K8 and K4 the small model's D = 256 shapes
   under ``d256`` by mode, times per small-model step (K5 on route X); K1-K8 their float32
   forms under ``f32`` by mode, times per step of the float32 model at 48 blocks on the
   route that runs the form (``HOME_F32``) and launches over that route's float32 roll-out,
   with the small model's float32 D = 256 shapes under ``f32`` ``d256``), the ``nvidia-smi``
   line, and the last line ``{"ok": true, "device": {...}}``.

The phases run in the order 1, 2, 3, 4, 6, 5b, 5d, 5c, routes W, P, X and
S, the main route with its breakdown, roll-outs and drivers, 7, 7b, 7c, 8: those that queue
most of the references' CPU halves first, so that the host thread's queue drains beside the
main route's long phases and the tools.

Run from the repository root: ``python3 chip_smoke.py``. It needs one card, and exits
non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

T_START = time.perf_counter()  # the process's first statement after the standard imports

# Roll-out steps of the routes' phases. ``rollout`` uploads the caller's
# history once, before the first step, so the second step is the first steady one.
STEPS = 3
# Roll-out steps of the rollout_scan phase, and of its short host-offload roll-out whose peak
# memory the full one's is held to.
SCAN_STEPS, SHORT_STEPS = 3, 2
# Bound on the mean relative difference between the three roll-outs if a kernel turns out
# not to give the same bits from run to run (they are expected to be equal).
SCAN_AGREE_TOL = 1e-3
REPS = 5  # timed runs per kernel and shape, after 2 warm-up runs
# The 1.3 B model's backbone stages on the 720 x 1440 grid: (C, H, W, D, heads, blocks a step).
F32_STAGES = ((4, 180, 360, 512, 8, 12), (4, 90, 180, 1024, 16, 20), (4, 45, 90, 2048, 32, 16))
LEVELS = (50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000)
TOL = {
    "roll3d": 0.0, "window_attention": 6e-3, "mlp_adaln_residual": 6e-3, "perceiver_core": 1e-2,
    "linear_adaln_residual": 6e-3, "window_attention_windowed": 6e-3, "sdpa_windows": 6e-3,
    "mlp_fused": 6e-3, "mlp_t": 6e-3, "attn_probe": 6e-3, "attn5d_direct": 6e-3,
    "gemm_blocked": 6e-3, "smem_probe": 0.0,
}
# The float32 forms (the facades' default config): K2 and K3 within the TPU's own float32 Swin
# block on the chip (9.2e-5, KERNEL_ONCHIP.json) by the branch measure less one float32 ulp,
# K4 within 1e-4 (tighter than the TPU's float32 perceiver core's 3.0e-3, which a K4 that
# rounded through TF32 would pass), K1 the same bits. Each case also checks the plain
# version with TF32 products by the same measure (``tf32_control_err``): the bound must fail
# that control.
TOL_F32 = {"roll3d": 0.0, "window_attention": 9e-5, "mlp_adaln_residual": 9e-5,
           "perceiver_core": 1e-4, "linear_adaln_residual": 9e-5,
           "window_attention_windowed": 9e-5, "sdpa_windows": 9e-5, "mlp_fused": 9e-5}
# Card vs the port's CPU run of a float32 model (the facades' default config), mean relative
# error per output variable.
F32_REF_TOL = 1e-4
# Timed runs of the float32 kernels (up to ~0.2 s each at the de-aggregation's MLP), after 2
# warm-up runs. A plain version's time is its check's own call (``once_ms``): 10-100x a
# kernel's, it is no yardstick, and timed repetitions of it held no check.
REPS_F32 = 3
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
# The float32 forms' sources (the same C entries' files as ``SOURCES`` name for bf16).
SOURCES_F32 = {
    "roll3d": "aurora_tpu_torch/csrc/roll.cu",
    "window_attention": "aurora_tpu_torch/csrc/window_attention_f32.cu + gemm_tf32x3_sm90.cuh",
    "mlp_adaln_residual": "aurora_tpu_torch/csrc/mlp_f32.cu + gemm_tf32x3_sm90.cuh",
    "perceiver_core": "aurora_tpu_torch/csrc/resampler_f32.cu + gemm_tf32x3_sm90.cuh",
    "linear_adaln_residual": "aurora_tpu_torch/csrc/mlp_f32.cu + gemm_tf32x3_sm90.cuh",
    "window_attention_windowed":
        "aurora_tpu_torch/csrc/window_attention_f32.cu + gemm_tf32x3_sm90.cuh",
    "sdpa_windows": "aurora_tpu_torch/csrc/window_attention_f32.cu",
    "mlp_fused": "aurora_tpu_torch/csrc/mlp_f32.cu + gemm_tf32x3_sm90.cuh",
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
# The float32 roll-out that gives each float32 form's launches in the summary, by (kernel,
# mode): "f32" the full-depth ``Aurora()`` on the main route, "f32W", "f32P", "f32X" its
# config at two blocks a stage on routes W, P and X, "f32wave" the wave model in its default
# config at full depth (K4 with ln_k: its aggregation, one of its two K4 launches a step).
# K7 and K6 without the tail run on no float32 route driven here.
HOME_F32 = {("roll3d", None): "f32", ("window_attention", "tail"): "f32",
            ("mlp_adaln_residual", None): "f32", ("perceiver_core", None): "f32",
            ("window_attention", "no tail"): "f32P", ("mlp_fused", None): "f32P",
            ("window_attention_windowed", "tail"): "f32W", ("linear_adaln_residual", None): "f32X",
            ("perceiver_core", "ln_k"): "f32wave"}


# The lines go to the standard output the script started with, whole and under one lock: the
# host thread emits references' lines while a phase on the main thread may have redirected
# ``sys.stdout`` to capture a tool's output (``run_drivers``).
_OUT, _OUT_LOCK = sys.stdout, threading.Lock()


def emit(obj) -> None:
    with _OUT_LOCK:
        _OUT.write(json.dumps(obj) + "\n")
        _OUT.flush()


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def once_ms(fn):
    """``(ms, fn())``: one call of ``fn`` between two CUDA events."""
    import torch

    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e), out


def cuda_ms(fn, reps: int = REPS, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` runs after ``warmup`` (``tools.time_ms``:
    CUDA events, each run behind a memset that keeps the queue ahead of the host and leaves
    the L2 cold)."""
    import torch

    from aurora_tpu_torch.tools import time_ms

    return time_ms(fn, torch.device("cuda", torch.cuda.current_device()), reps, warmup)


# ------------------------------------------------------------------------------ kernels


def case(name, label, per_step, kernel, plain, bound, check, residual=None, library=None,
         mode=None, same_bits=None, extra=None, recheck=False, small=False, f32=False,
         bounds=None) -> dict:
    """``bounds``: other bounds of the same work printed beside ``bound`` and summed per step
    (float32: ``ffma_bound_ms``, the products at the FFMA pipes' rate, beside K3's and K8's
    three-part bound; ``tf32x3_bound_ms``, the products as three TF32 products, beside the
    FFMA bound of the other float32 forms)."""
    return dict(name=name, label=label, per_step=per_step, kernel=kernel, plain=plain,
                bound=bound, check=check, residual=residual, library=library, mode=mode,
                same_bits=same_bits, extra=extra, recheck=recheck, small=small, f32=f32,
                bounds=bounds or {})


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

    from aurora_tpu_torch.ops import probes, resampler, roll, window_attention
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
        yield mlp_fused_case(rn, f"backbone ({rows},{D}), hidden {4 * D}", rows, D, nblk)
        yield linear_case(rn, f"({rows},{D})", rows, D, nblk)
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
    # K4's bias inputs at the aggregation's shape, without and with ln_k (on no path).
    yield from perceiver_cases(rn, "agg", 13, 64800, 512, 16, 3, 0, biases=True)
    yield from small_cases(rn)
    yield from f32_cases(rn)
    yield from probe_cases(rn)


# The small model's (AuroraSmallPretrained, D = 256) launches per step at D = 256, from the
# code: K2 in the 2 + 2 blocks of the backbone's first encoder and last decoder stage (one of
# each pair shifted, so masked), K3 in those 4 blocks and in the aggregation's MLP half, K4 in
# the aggregation (D_out = 256; the de-aggregation's is the decoder's 512).
SMALL_D256 = {"window_attention": 4, "mlp_adaln_residual": 5, "perceiver_core": 1}
# On route X (attention_impl "xla", mlp_impl "fused") K5 takes the place of K2 with the tail.
SMALL_X_D256 = {"linear_adaln_residual": 4, "mlp_adaln_residual": 5, "perceiver_core": 1}


def small_cases(rn):
    """K2 (and K6, which takes the same widths) with and without the tail, K3 (and K8, which
    shares its shape rule) and K4 (with and without ``ln_k``) at the small model's D = 256
    shapes on the 720 x 1440 grid: the (4, 180, 360) x 256 token grid, heads 4, and the
    level aggregation (13 levels of 64800 columns, 8 heads of 32, D_out 256). ``per_step``:
    the small model's launches a step (``SMALL_D256``); kernels or modes the small model does
    not run count 0. K2 must give K6's bits on the partitioned windows."""
    import torch

    from aurora_tpu_torch.ops import window_attention
    from aurora_tpu_torch.ops.masks import window_group_ids
    from aurora_tpu_torch.tools import bound_ms

    ws, ss = (2, 6, 12), (1, 3, 6)
    C, H, W, D, heads = 4, 180, 360, 256, 4
    xp = rn(1, C, H, W, D)
    M = C * H * W
    nW, N = M // 144, 144
    xw = window_attention.window_partition(xp, ws).contiguous()
    wqkv, bqkv = rn(D, 3 * D, std=0.02), rn(3 * D, std=0.02)
    tail = (rn(D, D, std=0.02), rn(D, std=0.02, dtype=torch.float32),
            rn(1, D, std=0.1, dtype=torch.float32), rn(1, D, dtype=torch.float32))
    fl_attn = 2 * M * D * 3 * D + 4 * nW * heads * N * N * (D // heads)
    # K2 with the tail masked and unmasked (the small model's shifted and unshifted blocks),
    # without it masked; K6 with the tail, masked.
    for groups in (window_group_ids(C, H, W, ws, ss), None):
        kind = "masked" if groups is not None else "unmasked"
        for t in (tail, None) if groups is not None else (tail,):
            mode = "tail" if t is not None else "no tail"
            kw = dict(mode=mode, check="branch" if t is not None else "rel", small=True,
                      recheck=True, bound=bound_ms(
                          flops_bf16=fl_attn + (2 * M * D * D if t is not None else 0),
                          nbytes=2 * M * D * 2 + (4 if t is not None else 3) * D * D * 2))
            yield case(
                "window_attention", f"D 256: (1,{C},{H},{W},{D}) heads {heads}, {kind}, {mode}",
                2 if t is not None else 0, residual=xp,
                kernel=lambda gr=groups, t=t:
                    window_attention.window_attention_tail(xp, wqkv, bqkv, gr, ws, heads, t),
                plain=lambda gr=groups, t=t:
                    window_attention.window_attention_tail_plain(xp, wqkv, bqkv, gr, ws, heads, t),
                extra=lambda gr=groups, t=t: k6_equals_k2(xp, wqkv, bqkv, gr, ws, heads, t), **kw)
    groups = window_group_ids(C, H, W, ws, ss)
    yield case(
        "window_attention_windowed", f"D 256: (1,{nW},{N},{D}) heads {heads}, masked, tail", 0,
        residual=xw,
        kernel=lambda: window_attention.window_attention_windowed(xw, wqkv, bqkv, groups, heads,
                                                                  tail),
        plain=lambda: window_attention.window_attention_windowed_plain(xw, wqkv, bqkv, groups,
                                                                       heads, tail),
        mode="tail", check="branch", small=True, recheck=True,
        bound=bound_ms(flops_bf16=fl_attn + 2 * M * D * D, nbytes=2 * M * D * 2 + 4 * D * D * 2))
    del xp, xw
    film = (rn(1, D, std=0.1, dtype=torch.float32), rn(1, D, dtype=torch.float32))
    ln2 = (rn(1, D, std=0.1, dtype=torch.float32), 1 + rn(1, D, std=0.1, dtype=torch.float32))
    for c in (mlp_case(rn, f"D 256: backbone ({M},{D})", M, D, 4 * D, 4, film),
              mlp_case(rn, f"D 256: perceiver agg ({64800 * 3},{D})", 64800 * 3, D, 4 * D, 1, ln2)):
        yield dict(c, small=True)
    yield mlp_fused_case(rn, f"D 256: backbone ({M},{D}), hidden {4 * D}", M, D, 0, small=True)
    # K5 at D = 256: route X's tail in the small model's 4 blocks of that width.
    yield linear_case(rn, f"D 256: ({M},{D})", M, D, SMALL_X_D256["linear_adaln_residual"],
                      small=True)
    for c in perceiver_cases(rn, "agg", 13, 64800, D, 8, 3, 1):
        # The small model's aggregation has no ln_k: that mode counts nothing.
        yield dict(c, small=True, label="D 256: " + c["label"],
                   per_step=c["per_step"] if c["mode"] is None else 0)


def f32_cases(rn):
    """The float32 forms of K1-K8 (the facades' default config) at the 1.3 B model's shapes
    on the 720 x 1440 grid and at the small model's D = 256 ones: K1 on each stage's token
    grid, both shifts; K2 and K6 with the tail (masked and unmasked: the model's shifted and
    unshifted blocks) and without it, and K7, at each stage and at D = 256 (K2 giving K6's
    bits; stage 3's masked cases with garbage in their pad tokens), a ragged 121 x 240 case of
    K2 and K6; K3 at each stage, the perceiver MLP halves' shapes, D = 256 and two FiLM rows
    in one tile of rows, stage 3's ragged rows with the rows behind them untouched (K3 and
    K8), the weights' split bits at stage 1 and D = 256; K8 and K5 at each stage and at D =
    256; K4's aggregation (with and without ln_k) and de-aggregation at both models' shapes and
    at the 121 x 240 grid's 1800 columns.
    ``per_step``: launches per step of the float32 model on the route that runs the kernel at
    48 blocks (main: K2 48 with the tail, K3 50, K4 2; P: K2 48 without the tail, K8 48; W: K6
    48 with the tail; X: K5 48; K7, on no route, as if once a block), or of the small one at
    D = 256 (``SMALL_D256``; route X: K5 4, ``SMALL_X_D256``); forms no float32 route runs
    count 0."""
    import torch

    from aurora_tpu_torch.ops import roll
    from aurora_tpu_torch.tools import bound_ms

    f32 = torch.float32
    for C, H, W, D, heads, nblk in F32_STAGES:
        x = rn(1, C, H, W, D, dtype=f32)
        for shifts in ((-1, -3, -6), (1, 3, 6)):
            yield case(
                "roll3d", f"f32 (1,{C},{H},{W},{D}) shifts {shifts}", nblk // 2, f32=True,
                kernel=lambda x=x, s=shifts: roll.roll3d(x, s),
                plain=lambda x=x, s=shifts: roll.roll3d_plain(x, s),
                library=lambda x=x, s=shifts: torch.roll(x, s, dims=(1, 2, 3)),
                check="exact", bound=bound_ms(nbytes=2 * x.numel() * 4),
            )
        del x
        half = nblk // 2  # a stage's shifted (masked) blocks, and its unshifted ones
        yield from attention_f32_cases(rn, C, H, W, D, heads, {
            ("window_attention", "tail"): half, ("window_attention", "no tail"): half,
            ("window_attention_windowed", "tail"): half, ("sdpa_windows", None): half},
            split_check=D == 512)
        film = (rn(1, D, std=0.1, dtype=f32), rn(1, D, dtype=f32))
        rows = C * H * W
        yield mlp_case(rn, f"f32 backbone ({rows},{D})", rows, D, 4 * D, nblk, film,
                       ragged=rows % 64 != 0, f32=True, split_check=True)
        yield mlp_fused_case(rn, f"f32 backbone ({rows},{D}), hidden {4 * D}", rows, D, nblk,
                             f32=True)
        yield linear_case(rn, f"f32 ({rows},{D})", rows, D, nblk, f32=True)
    # The 121 x 240 grid's stage 1: 7200 rows, a ragged last tile of rows. Counts nothing.
    yield from attention_f32_cases(rn, 4, 30, 60, 512, 8, {}, "121 x 240, ragged: ",
                                   tails=(True,), groups=("masked",), sdpa=False)
    for label, rows, D in (("agg", 64800 * 3, 512), ("de-agg", 64800 * 13, 1024)):
        ln2 = (rn(1, D, std=0.1, dtype=f32), 1 + rn(1, D, std=0.1, dtype=f32))
        yield mlp_case(rn, f"f32 perceiver {label} ({rows},{D})", rows, D, 2048, 1, ln2,
                       f32=True)
    film2 = (rn(2, 512, std=0.1, dtype=f32), rn(2, 512, dtype=f32))
    yield mlp_case(rn, "f32 B = 2, (2,200,512): a tile straddles the FiLM rows", 200, 512,
                   2048, 0, film2, B=2, f32=True)
    for M, per_step in ((64800, 1), (1800, 0)):
        for label, K, D, h, Q in (("agg", 13, 512, 16, 3), ("de-agg", 3, 1024, 16, 13)):
            for c in perceiver_cases(rn, label, K, M, D, h, Q, per_step, f32=True):
                # ln_k: the wave model's aggregation in its default config, one a step.
                yield dict(c, per_step=per_step if c["mode"] is None or label == "agg" else 0)
    # The air-pollution model's second de-aggregation (its chemistry variables) at its
    # 451 x 900 grid, patch 3: 45000 columns (its first runs the same shape). Counts nothing
    # towards the 1.3 B model's step.
    for c in perceiver_cases(rn, "de-agg", 3, 45000, 1024, 16, 13, 0, f32=True):
        yield dict(c, label=c["label"].replace("f32 ", "f32 AirPollution: ", 1))
    # K4's bias inputs in float32 at the aggregation's shape, without and with ln_k.
    yield from perceiver_cases(rn, "agg", 13, 64800, 512, 16, 3, 0, f32=True, biases=True)
    # The small model (D = 256) in float32: K2 2 + 2 a step with the tail (main route), K5 4
    # (route X); its routes W and P are not driven.
    C, H, W, D, heads = 4, 180, 360, 256, 4
    M = C * H * W
    yield from attention_f32_cases(rn, C, H, W, D, heads, {("window_attention", "tail"): 2},
                                   "D 256: ", small=True, split_check=True)
    film = (rn(1, D, std=0.1, dtype=f32), rn(1, D, dtype=f32))
    ln2 = (rn(1, D, std=0.1, dtype=f32), 1 + rn(1, D, std=0.1, dtype=f32))
    for c in (mlp_case(rn, f"f32 D 256: backbone ({M},{D})", M, D, 4 * D, 4, film, f32=True,
                       split_check=True),
              mlp_case(rn, f"f32 D 256: perceiver agg ({64800 * 3},{D})", 64800 * 3, D, 4 * D,
                       1, ln2, f32=True)):
        yield dict(c, small=True)
    yield mlp_fused_case(rn, f"f32 D 256: backbone ({M},{D}), hidden {4 * D}", M, D, 0,
                         f32=True, small=True)
    yield linear_case(rn, f"f32 D 256: ({M},{D})", M, D, SMALL_X_D256["linear_adaln_residual"],
                      f32=True, small=True)
    for c in perceiver_cases(rn, "agg", 13, 64800, D, 8, 3, 1, f32=True):
        yield dict(c, small=True, label=c["label"].replace("f32 ", "f32 D 256: ", 1),
                   per_step=1 if c["mode"] is None else 0)


def attention_f32_cases(rn, C, H, W, D, heads, per_step, prefix="", tails=(True, False),
                        groups=("masked", "unmasked"), sdpa=True, small=False,
                        split_check=False):
    """K2 and K6 in float32 on the (1, C, H, W, D) grid padded to whole windows (K6 on its
    partitioned windows), with and without the tail, masked and unmasked; with ``sdpa`` K7 on
    packed qkv of the same windows, masked and unmasked (``F.scaled_dot_product_attention`` in
    float32 with the -100/0 mask beside it). Each against its plain version with full-f32
    products; K2's and K6's bound their qkv and proj as three TF32 products and the core at
    the FFMA rate, the FFMA bound of all of it beside it. Every K2 case also checks that K6 on
    ``window_partition(xp)``, reversed, gives its bits; on a padded grid, masked, garbage in
    the pad tokens must leave the real tokens within PAD_F32_TOL (K2 and K6 with the tail,
    K7). ``split_check``: the masked cases with the tail also hold the card's split of Wqkv and
    Wproj to ``mlp.tf32_split``'s bits (:func:`window_split_bits_equal`). ``per_step``:
    launches a step of each (kernel, mode) on the route that runs it (absent: 0)."""
    import torch
    import torch.nn.functional as F

    from aurora_tpu_torch.ops import window_attention
    from aurora_tpu_torch.ops.masks import bias_from_groups, group_ids_tensor, window_group_ids
    from aurora_tpu_torch.tools import bound_ms

    f32 = torch.float32
    ws, ss = (2, 6, 12), (1, 3, 6)
    Hp, Wp = H + (-H) % ws[1], W + (-W) % ws[2]
    xp = rn(1, C, Hp, Wp, D, dtype=f32)
    xw = window_attention.window_partition(xp, ws).contiguous()
    M = C * Hp * Wp
    nW, N, dh = M // 144, 144, D // heads
    wqkv, bqkv = rn(D, 3 * D, std=0.02, dtype=f32), rn(3 * D, std=0.02, dtype=f32)
    tail = (rn(D, D, std=0.02, dtype=f32), rn(D, std=0.02, dtype=f32),
            rn(1, D, std=0.1, dtype=f32), rn(1, D, dtype=f32))
    fl_core = 4 * nW * heads * N * N * dh
    padded = (Hp, Wp) != (H, W)
    for kind in groups:
        gr = window_group_ids(C, H, W, ws, ss) if kind == "masked" else None
        for with_tail in tails:
            t = tail if with_tail else None
            mode = "tail" if with_tail else "no tail"
            products = 2 * M * D * 3 * D + (2 * M * D * D if with_tail else 0)
            nb = 2 * M * D * 4 + (4 if with_tail else 3) * D * D * 4
            kw = dict(f32=True, small=small, mode=mode, check="branch" if with_tail else "rel",
                      recheck=True,
                      bound=bound_ms(flops_tf32x3=products, flops_f32=fl_core, nbytes=nb),
                      bounds=dict(ffma_bound_ms=bound_ms(flops_f32=products + fl_core,
                                                         nbytes=nb)[0]))
            pad = with_tail and gr is not None and padded
            split = split_check and with_tail and gr is not None

            def k2_extra(gr=gr, t=t, pad=pad, split=split):
                more = k6_equals_k2(xp, wqkv, bqkv, gr, ws, heads, t)
                if pad:
                    more.update(k2_pad_tokens_isolated(xp, wqkv, bqkv, gr, ws, heads, t))
                if split:
                    more.update(window_split_bits_equal(xp, wqkv, bqkv, gr, ws, heads, t))
                return more

            def k6_extra(gr=gr, t=t, pad=pad, split=split):
                more = {}
                if pad:
                    more.update(k2_pad_tokens_isolated(xp, wqkv, bqkv, gr, ws, heads, t,
                                                       windowed=True))
                if split:
                    more.update(window_split_bits_equal(xw, wqkv, bqkv, gr, None, heads, t))
                return more

            yield case(
                "window_attention",
                f"f32 {prefix}(1,{C},{Hp},{Wp},{D}) heads {heads}, {kind}, {mode}",
                per_step.get(("window_attention", mode), 0),
                residual=xp if with_tail else None, extra=k2_extra,
                kernel=lambda gr=gr, t=t:
                    window_attention.window_attention_tail(xp, wqkv, bqkv, gr, ws, heads, t),
                plain=full_f32(lambda gr=gr, t=t: window_attention.window_attention_tail_plain(
                    xp, wqkv, bqkv, gr, ws, heads, t)), **kw,
            )
            yield case(
                "window_attention_windowed",
                f"f32 {prefix}(1,{nW},{N},{D}) heads {heads}, {kind}, {mode}",
                per_step.get(("window_attention_windowed", mode), 0),
                residual=xw if with_tail else None, extra=k6_extra if pad or split else None,
                kernel=lambda gr=gr, t=t:
                    window_attention.window_attention_windowed(xw, wqkv, bqkv, gr, heads, t),
                plain=full_f32(lambda gr=gr, t=t:
                               window_attention.window_attention_windowed_plain(
                                   xw, wqkv, bqkv, gr, heads, t)), **kw,
            )
    if not sdpa:
        return
    # K7 on packed qkv; the library yardstick is SDPA in float32 on the same q, k, v (views
    # (nW, heads, N, dh) of the packed rows) with the same -100/0 mask.
    qkv = rn(1, nW, N, 3 * D, dtype=f32)
    q, k, v = (t.contiguous() for t in
               qkv.view(nW, N, 3, heads, dh).permute(2, 0, 3, 1, 4).unbind(0))
    for kind in groups:
        gr = window_group_ids(C, H, W, ws, ss) if kind == "masked" else None
        mask = None if gr is None else bias_from_groups(group_ids_tensor(gr, qkv.device),
                                                        f32)[:, None]
        yield case(
            "sdpa_windows", f"f32 {prefix}(1,{nW},{N},{3 * D}) heads {heads}, {kind}",
            per_step.get(("sdpa_windows", None), 0), f32=True, small=small,
            kernel=lambda gr=gr: window_attention.sdpa_windows(qkv, gr, heads),
            plain=full_f32(lambda gr=gr: window_attention.sdpa_windows_plain(qkv, gr, heads)),
            library=lambda m=mask: F.scaled_dot_product_attention(q, k, v, attn_mask=m),
            check="rel", bound=bound_ms(flops_f32=fl_core, nbytes=4 * M * D * 4),
            extra=(lambda gr=gr: pad_tokens_isolated(qkv, gr, heads))
            if gr is not None and padded else None,
        )


def linear_case(rn, label, rows, D, per_step, f32=False, small=False):
    """K5 on (1, rows, D) tokens and shortcut with FiLM at unit gain (shift N(0, 0.1), scale
    N(0, 1), scale_bias 0), against its plain version (with full-f32 products in float32)."""
    import torch

    from aurora_tpu_torch.ops import mlp
    from aurora_tpu_torch.tools import bound_ms

    dt = torch.float32 if f32 else torch.bfloat16
    e = 4 if f32 else 2
    x, sc = rn(1, rows, D, dtype=dt), rn(1, rows, D, dtype=dt)
    w = (rn(D, D, std=0.02, dtype=dt), rn(D, std=0.02, dtype=torch.float32))
    film = (rn(1, D, std=0.1, dtype=torch.float32), rn(1, D, dtype=torch.float32))
    fl = 2 * rows * D * D
    nb = 3 * rows * D * e + D * D * e
    return case(
        "linear_adaln_residual", label, per_step, residual=sc, f32=f32, small=small,
        kernel=lambda: mlp.linear_adaln_residual(x, *w, sc, *film),
        plain=full_f32(lambda: mlp.linear_adaln_residual_plain(x, *w, sc, *film)),
        check="branch", recheck=True,
        # float32: three TF32 products of the product, the FFMA bound beside it
        bound=bound_ms(**{"flops_tf32x3" if f32 else "flops_bf16": fl}, nbytes=nb),
        bounds=dict(ffma_bound_ms=bound_ms(flops_f32=fl, nbytes=nb)[0]) if f32 else None,
        extra=(lambda: linear_split_bits_equal(x, w, sc, film)) if f32 else None,
    )


def linear_split_bits_equal(x, w, sc, film) -> dict:
    """Float32 K5 with the weight's split scratch given (filled with NaN first): the hi and lo
    parts of W^T that the card's split kernel writes there must be ``mlp.tf32_split``'s bits,
    and the output the wrapper's bits."""
    import torch

    from aurora_tpu_torch.ops import mlp

    D = x.shape[-1]
    ops = {"w": w[0], "b": w[1], "shift": film[0].reshape(1, D), "scale": film[1].reshape(1, D)}
    ws = torch.full((2 * D * D,), float("nan"), device=x.device)
    out = torch.empty_like(x)
    mlp._linear_adaln_residual_call(mlp._linear_entry(x), x, ops, sc, 0.0, out, wsplit=ws)
    if not torch.equal(out, mlp.linear_adaln_residual(x, *w, sc, *film)):
        raise AssertionError("linear_adaln_residual: a given split scratch changed the output")
    return split_is_tf32_split(ws, (w[0],), "linear_adaln_residual")


def mlp_fused_case(rn, label, rows, D, per_step, f32=False, small=False):
    """K8 on (1, rows, D) tokens, hidden 4 D, against its plain version (with full-f32
    products in float32)."""
    import torch

    from aurora_tpu_torch.ops import mlp
    from aurora_tpu_torch.tools import bound_ms

    dt = torch.float32 if f32 else torch.bfloat16
    e = 4 if f32 else 2
    x = rn(1, rows, D, dtype=dt)
    w = (rn(D, 4 * D, std=0.02, dtype=dt), rn(4 * D, std=0.02, dtype=torch.float32),
         rn(4 * D, D, std=0.02, dtype=dt), rn(D, std=0.02, dtype=torch.float32))
    fl = 16 * rows * D * D
    nb = 2 * rows * D * e + 8 * D * D * e
    return case(
        "mlp_fused", label, per_step, f32=f32, small=small,
        kernel=lambda: mlp.mlp_fused(x, *w), plain=full_f32(lambda: mlp.mlp_fused_plain(x, *w)),
        check="rel", recheck=True,
        # float32: the kernel's work is three TF32 products of each product; the FFMA bound
        # of the same products beside it
        bound=bound_ms(**{"flops_tf32x3" if f32 else "flops_bf16": fl}, nbytes=nb),
        bounds=dict(ffma_bound_ms=bound_ms(flops_f32=fl, nbytes=nb)[0]) if f32 else None,
    )


def perceiver_cases(rn, label, K, M, D, h, Q, per_step, f32=False, biases=False):
    """K4 on the (de-)aggregation's shapes; with ln_k for the aggregation (route S; in
    float32 the wave model's default config). The bound is that of the folded work the
    kernels do (f32 logits from (D, Q h) weights; the v product and the out-projection in
    bf16, with ln_k also the product with the centred weights in three bf16 parts; with
    ``f32``, the float32 form, all of it in f32 and ln_k's product once); the bound of the
    TPU kernel's work (the f32 k projection, logits from k) beside it. With ``biases``, the
    same cases with ``bk``, ``bv`` and ``bout`` instead (modes "bias" and "ln_k, bias"; no
    config creates them, so no path launches them)."""
    import torch

    from aurora_tpu_torch.ops import resampler
    from aurora_tpu_torch.tools import bound_ms

    fp = torch.float32
    inner, dh = D, D // h
    a = dict(
        ctx=rn(K, M, D, dtype=fp), wk=rn(D, inner, std=0.05, dtype=fp),
        wv=rn(D, inner, std=0.05, dtype=fp), qh=rn(Q, h, dh, dtype=fp),
        wout=rn(inner, D, std=0.05, dtype=fp), ln1_w=1 + rn(D, std=0.1, dtype=fp),
        ln1_b=rn(D, std=0.1, dtype=fp), queries=rn(Q, D, dtype=fp),
    )
    kw = dict(scale=dh**-0.5, value_bf16=not f32)
    vo = 2 * K * M * D * inner + 2 * M * Q * inner * D  # v and the out-projection
    if f32:
        nb = K * M * D * 4 + M * Q * D * 4 + D * inner * 8 + inner * D * 4
    else:
        nb = K * M * D * 4 + M * Q * D * 2 + D * inner * 6 + inner * D * 2
    lnks = [None]
    if label == "agg":
        lnks.append((1 + rn(inner, std=0.1, dtype=fp), rn(inner, std=0.1, dtype=fp)))
    # The biases of to_kv (split) and to_out, as large as the values they are added to.
    b = dict(bk=rn(inner, std=0.5, dtype=fp), bv=rn(inner, std=0.5, dtype=fp),
             bout=rn(D, std=0.5, dtype=fp)) if biases else {}
    if biases:
        nb += (2 * inner + D) * 4
    for lnk in lnks:
        # The TPU kernel's work: the f32 k projection and logits from k; ln_k adds ~8 f32
        # operations per value of k.
        tpu = 2 * K * M * D * inner + 2 * K * M * Q * inner + (8 * K * M * inner if lnk else 0)
        logits = 2 * K * M * D * Q * h
        if f32:
            # Every product as three TF32 products (with ln_k also ctx Wc, for the sums of
            # squares); the FFMA bound of the same work beside it.
            wc = 2 * K * M * D * inner if lnk is not None else 0
            bound = bound_ms(flops_tf32x3=logits + vo + wc, nbytes=nb)
            tpu_bound = bound_ms(flops_f32=tpu + vo, nbytes=nb)[0]
            bounds = dict(ffma_bound_ms=bound_ms(flops_f32=logits + vo + wc, nbytes=nb)[0])
        else:
            # With ln_k, ctx Wc in three bf16 products (the kernels' split form).
            split = 3 * 2 * K * M * D * inner if lnk is not None else 0
            bound = bound_ms(flops_bf16=vo + split, flops_f32=logits, nbytes=nb)
            tpu_bound = bound_ms(flops_bf16=vo, flops_f32=tpu, nbytes=nb)[0]
            bounds = None
        mode = ", ".join(m for m, on in (("ln_k", lnk is not None), ("bias", biases)) if on)
        yield case(
            "perceiver_core",
            ("f32 " if f32 else "") + f"{label} ctx ({K},{M},{D}) Q {Q}"
            + (", ln_k" if lnk else "") + (", bk bv bout" if biases else ""),
            per_step, mode=mode or None, f32=f32,
            kernel=lambda lnk=lnk: resampler.perceiver_core(**a, **kw, lnk=lnk, **b),
            plain=full_f32(lambda lnk=lnk: resampler.perceiver_core_plain(**a, **kw, lnk=lnk,
                                                                           **b)),
            check="branch", residual=a["queries"][None], bound=bound, bounds=bounds,
            extra=lambda tb=tpu_bound, lnk=lnk: dict(
                bound_of_tpu_work_ms=tb,
                **(perceiver_split_bits_equal(a, dh**-0.5, lnk) if f32 and not biases
                   else {})),
        )


def perceiver_split_bits_equal(a, scale, lnk) -> dict:
    """Float32 K4 with the weights' split scratch and the chunk's v-and-logits scratch given
    (filled with NaN first): the hi and lo parts of Wv^T and Wout^T that the card's split
    kernels write there must be ``mlp.tf32_split``'s bits, and the output the wrapper's bits.
    The fold's own parts of Wkq^T must be TF32 values whose sum is the float64 fold within
    2^-21 of its largest (zeros in the padded logit columns). Prints the error of the last
    chunk's logits (left in the scratch) against the float64 product of its context rows and
    the folded weights, over their largest."""
    import torch

    from aurora_tpu_torch.ops import _lib, resampler

    K, M, D = a["ctx"].shape
    Q, h, dh = a["qh"].shape
    inner, D_out, QH = h * dh, a["wout"].shape[1], Q * h
    ln_k = lnk is not None
    NS = inner + resampler.perceiver_logit_columns(QH)
    NT = NS + (inner if ln_k else 0)
    chunks = resampler.perceiver_column_chunks(M, K, D, inner, Q, h, D_out, ln_k, f32=True)
    nan = float("nan")
    ws = torch.full((resampler.perceiver_split_bytes(D, inner, QH, D_out, ln_k) // 4,), nan,
                    device=a["ctx"].device)
    vl = torch.full((K * chunks[0][1], NS), nan, device=a["ctx"].device)
    fn = _lib.kernel("resampler_f32", "perceiver_core_f32", resampler._PERCEIVER_CORE_F32_ARGS)
    out = resampler._perceiver_core_f32_call(fn, *a.values(), scale, 1e-5, lnk, wsplit=ws, vl=vl)
    if not torch.equal(out, resampler.perceiver_core(**a, scale=scale, value_bf16=False,
                                                     lnk=lnk)):
        raise AssertionError("perceiver_core: given scratch changed the output")
    torch.cuda.synchronize()
    ctx_t = ws[:2 * NT * D].view(2 * NT, D)  # [Wv | Wkq | Wc]^T's hi rows, then its lo rows
    wv_parts = torch.cat([ctx_t[:inner].reshape(-1), ctx_t[NT:NT + inner].reshape(-1)])
    more = split_is_tf32_split(torch.cat([wv_parts, ws[2 * NT * D:]]), (a["wv"], a["wout"]),
                               "perceiver_core")
    # the last chunk's logits; with ln_k the raw logits of the folded Wkq' (as the fold makes)
    m0, mc = chunks[-1]
    f64 = torch.float64
    w = a["wk"].to(f64)
    if ln_k:
        w = (w - w.mean(-1, keepdim=True)) * lnk[0].to(f64)
    wkq = scale * torch.einsum("chd,qhd->cqh", w.view(D, h, dh), a["qh"].to(f64))
    want = a["ctx"][:, m0:m0 + mc].to(f64).reshape(K * mc, D) @ wkq.reshape(D, QH)
    got = vl[:K * mc, inner:inner + QH].to(f64)
    more["logits_rel_err"] = ((got - want).abs().max() / want.abs().max()).item()
    # the fold's own split: TF32 parts (low 13 bits zero), hi + lo the folded Wkq^T within
    # 2^-21 of its largest (the f32 rounding of the fold and lo's own), zeros in the padding
    hi, lo = ctx_t[inner:NS], ctx_t[NT + inner:NT + NS]
    if ((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF).any():
        raise AssertionError("perceiver_core: the fold's split parts are not TF32 values")
    ref = torch.zeros(NS - inner, D, dtype=f64, device=hi.device)
    ref[:QH] = wkq.reshape(D, QH).t()
    more["fold_split_rel_err"] = ((hi.to(f64) + lo.to(f64) - ref).abs().max()
                                  / ref.abs().max()).item()
    if more["fold_split_rel_err"] > 2.0**-21:
        raise AssertionError(f"perceiver_core: the fold's split is {more['fold_split_rel_err']} "
                             "from the float64 fold")
    return more


def pad_tokens_isolated(qkv, groups, heads) -> dict:
    """K7 on a padded grid: garbage in the pad tokens' q, k and v must leave every real
    token's output the same bits in bf16, within PAD_F32_TOL of the clean output's largest in
    float32 (pad tokens have a group id of their own, the largest; see PAD_F32_TOL), and must
    change the pad tokens' outputs."""
    import torch

    from aurora_tpu_torch.ops import window_attention
    from aurora_tpu_torch.tools import branch_err

    pad = torch.as_tensor(groups == groups.max(), device=qkv.device)  # (nW, N)
    if not pad.any() or pad.all():
        raise AssertionError("pad-token check: the grid has no pad tokens")
    clean = window_attention.sdpa_windows(qkv, groups, heads)
    dirty_in = torch.where(pad[None, :, :, None], torch.full_like(qkv, 7.0), qkv)
    dirty = window_attention.sdpa_windows(dirty_in, groups, heads)
    torch.cuda.synchronize()
    real_equal = torch.equal(clean[:, ~pad], dirty[:, ~pad])
    pad_moved = not torch.equal(clean[:, pad], dirty[:, pad])
    out = dict(pad_tokens=int(pad.sum()), real_tokens_bit_equal=real_equal,
               pad_tokens_changed=pad_moved)
    isolated = real_equal
    if qkv.dtype == torch.float32:
        out["real_tokens_changed"] = int((clean[:, ~pad] != dirty[:, ~pad]).sum())
        out["real_tokens_rel_err"] = branch_err(dirty[:, ~pad], clean[:, ~pad],
                                                torch.zeros((), device=qkv.device))[1]
        isolated = out["real_tokens_rel_err"] <= PAD_F32_TOL
    if not (isolated and pad_moved):
        raise AssertionError(f"K7 pad-token check: {out}")
    return out


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


def window_split_bits_equal(x, wqkv, bqkv, groups, ws, heads, tail) -> dict:
    """Float32 K2 (``ws`` given, ``x`` the padded grid) or K6 (``ws`` None, ``x`` the packed
    windows) with the tail, the weights' split scratch given (filled with NaN first): the hi
    and lo parts of Wqkv^T and Wproj^T that the card's split kernel writes there must be the
    bits of ``mlp.tf32_split`` of the same transposes (compared as int32)."""
    import torch

    from aurora_tpu_torch.ops import window_attention as wa

    D = x.shape[-1]
    if ws is None:
        _, nW, rows = wa.check_window_attention_shape(tuple(x.shape), heads)
        geom, wsx, what = (0, 0, 0), (0, 0, 0), "window_attention_windowed"
    else:
        _, nW, rows = wa.check_window_attention_shape(tuple(x.shape), heads, ws)
        geom, wsx, what = tuple(x.shape[1:4]), ws, "window_attention"
    split = torch.full((8 * D * D,), float("nan"), device=x.device)
    wa._window_attention_call(wa._window_attention_entry(x), x, wqkv, bqkv, groups, heads, tail,
                              1e-5, nW, rows, geom, wsx, what, wsplit=split)
    return split_is_tf32_split(split, (wqkv, tail[0]), what)


# In float32 a masked key keeps a weight of exp(-100 + its logit) (a tiny normal or a
# denormal; bf16 rounds it to 0), so garbage in the pad tokens may flip a rounding of a real
# token's output, in the plain version as in the kernel (both measured on the card): the real
# tokens must stay within this branch error of the clean run, ~90x under the 9e-5 block bound.
PAD_F32_TOL = 1e-6


def k2_pad_tokens_isolated(xp, wqkv, bqkv, groups, ws, heads, tail, windowed=False) -> dict:
    """K2 on a padded grid, masked (with ``windowed``, K6 on its partitioned windows, the
    output reversed): garbage in the pad tokens of ``xp`` must leave every real token's
    output the same bits in bf16, within PAD_F32_TOL in float32 (pad tokens have a group id of
    their own, the largest; in a shifted block they lie where the roll put them; proj and the
    LayerNorm work row by row), and must change the pad tokens' outputs."""
    import torch

    from aurora_tpu_torch.ops import window_attention as wa
    from aurora_tpu_torch.tools import branch_err

    _, Cp, Hp, Wp, _ = xp.shape
    pad_w = torch.as_tensor(groups == groups.max(), device=xp.device)  # (nW, N)
    pad = wa.window_reverse(pad_w[None, :, :, None], ws, Cp, Hp, Wp)[0, ..., 0]

    def run(x):
        if not windowed:
            return wa.window_attention_tail(x, wqkv, bqkv, groups, ws, heads, tail)
        xw = wa.window_partition(x, ws).contiguous()
        out = wa.window_attention_windowed(xw, wqkv, bqkv, groups, heads, tail)
        return wa.window_reverse(out, ws, Cp, Hp, Wp)

    clean = run(xp)
    dirty = run(torch.where(pad[None, ..., None], torch.full_like(xp, 7.0), xp))
    torch.cuda.synchronize()
    real_equal = torch.equal(clean[:, ~pad], dirty[:, ~pad])
    pad_moved = not torch.equal(clean[:, pad], dirty[:, pad])
    out = dict(pad_tokens=int(pad.sum()), real_tokens_bit_equal=real_equal,
               pad_tokens_changed=pad_moved)
    if xp.dtype == torch.float32:
        res = xp[:, ~pad] if tail is not None else torch.zeros((), device=xp.device)
        out["real_tokens_changed"] = int((clean[:, ~pad] != dirty[:, ~pad]).sum())
        out["real_tokens_branch_err"] = branch_err(dirty[:, ~pad], clean[:, ~pad], res)[1]
        isolated = out["real_tokens_branch_err"] <= PAD_F32_TOL
    else:
        isolated = real_equal
    if not (isolated and pad_moved):
        raise AssertionError(f"{'K6' if windowed else 'K2'} pad-token check: {out}")
    return out


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


def mlp_case(rn, label, rows, D, Hd, per_step, shift_scale, B=1, ragged=False, f32=False,
             split_check=False):
    """Both callers pass scale_bias = 0: the blocks' FiLM and the perceiver's LN affine.
    ``f32``: the float32 form (tokens and weights f32, the plain version's products in full
    f32; its bound the three TF32 products of each product, the FFMA bound beside it), else
    bf16. ``ragged``: the rows past the end untouched (:func:`rows_past_end_untouched`);
    ``split_check``: the card's split of the weights gives ``mlp.tf32_split``'s bits
    (:func:`split_bits_equal`)."""
    import torch

    from aurora_tpu_torch.ops import mlp
    from aurora_tpu_torch.tools import bound_ms

    dt = torch.float32 if f32 else torch.bfloat16
    x = rn(B, rows, D, dtype=dt)
    a = (
        rn(D, Hd, std=0.02, dtype=dt), rn(Hd, std=0.02, dtype=torch.float32),
        rn(Hd, D, std=0.02, dtype=dt), rn(D, std=0.02, dtype=torch.float32), *shift_scale,
    )
    fl = 4 * B * rows * D * Hd
    e = x.element_size()
    nb = 2 * B * rows * D * e + 2 * D * Hd * e
    extra = ((lambda: rows_past_end_untouched(x, a)) if ragged else
             (lambda: split_bits_equal(x, a)) if split_check else None)
    return case(
        "mlp_adaln_residual", label, per_step,
        kernel=lambda: mlp.mlp_adaln_residual(x, *a),
        plain=full_f32(lambda: mlp.mlp_adaln_residual_plain(x, *a)),
        check="branch", residual=x, recheck=True, f32=f32,
        bound=bound_ms(**{"flops_tf32x3" if f32 else "flops_bf16": fl}, nbytes=nb),
        bounds=dict(ffma_bound_ms=bound_ms(flops_f32=fl, nbytes=nb)[0]) if f32 else None,
        extra=extra,
    )


def full_f32(fn):
    """``fn`` run with full-f32 products (TF32 off), the caller's settings restored: how the
    plain versions run, so that a float32 comparison is not against TF32's three digits.
    ``.tf32`` runs ``fn`` with TF32 products instead: the control a float32 bound must
    fail."""
    def run():
        from aurora_tpu_torch.model.nn import full_f32_products

        with full_f32_products():
            return fn()

    def tf32():
        import torch

        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            return fn()
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    run.tf32 = tf32
    return run


def rows_past_end_untouched(x, a) -> dict:
    """K3 and K8 on rows that are no multiple of a tile's 64, written into the first rows of
    a larger buffer filled with a sentinel: those rows must be the wrappers' bits, and the
    rows behind them must keep the sentinel; in bf16 or float32 (each its own entry)."""
    import torch

    from aurora_tpu_torch.ops import mlp

    B, L, D = x.shape
    M, spare, sentinel = B * L, 256, -32768.0
    if M % 64 == 0:
        raise AssertionError(f"ragged check: {M} rows are a multiple of 64")
    ops = mlp._mlp_operands(x, *a[:4])
    fn = mlp._mlp_rows_entry(x)
    film = (a[4].float().reshape(B, D).contiguous(), a[5].float().reshape(B, D).contiguous(),
            0.0, L, 1e-5)
    runs = [("mlp_adaln_residual", film, mlp.mlp_adaln_residual(x, *a)),
            ("mlp_fused", None, mlp.mlp_fused(x, *a[:4]))]
    for what, f, ref in runs:
        buf = torch.full((M + spare, D), sentinel, dtype=x.dtype, device=x.device)
        mlp._mlp_rows(fn, x.view(M, D), ops, buf[:M], f)
        torch.cuda.synchronize()
        same = torch.equal(buf[:M], ref.view(M, D))
        kept = bool((buf[M:] == sentinel).all())
        if not (same and kept):
            raise AssertionError(f"ragged check, {what}: first {M} rows bit-equal {same}, the "
                                 f"{spare} rows behind them untouched {kept}")
    return dict(ragged_rows=M, rows_behind_untouched=spare)


def split_bits_equal(x, a) -> dict:
    """Float32 K3 on ``x`` with the weights' split scratch given (filled with NaN first): the
    hi and lo parts of W1^T and W2^T that the card's split kernel writes there must be the
    bits of ``mlp.tf32_split`` of the same transposes (compared as int32)."""
    import torch

    from aurora_tpu_torch.ops import mlp

    B, L, D = x.shape
    ops = mlp._mlp_operands(x, *a[:4])
    Hd = ops[0].shape[1]
    film = (a[4].float().reshape(B, D).contiguous(), a[5].float().reshape(B, D).contiguous(),
            0.0, L, 1e-5)
    ws = torch.full((4 * D * Hd,), float("nan"), device=x.device)
    out = torch.empty(B * L, D, device=x.device)
    mlp._mlp_rows(mlp._mlp_rows_entry(x), x.view(B * L, D), ops, out, film, wsplit=ws)
    return split_is_tf32_split(ws, (ops[0], ops[2]), "mlp_adaln_residual")


def split_is_tf32_split(ws, weights, what) -> dict:
    """The split scratch ``ws`` a launch wrote must hold, in order, the hi and lo parts of each
    of ``weights``' transposes as ``mlp.tf32_split`` gives them (compared as int32)."""
    import torch

    from aurora_tpu_torch.ops import mlp

    torch.cuda.synchronize()
    parts = [p.reshape(-1) for w in weights for p in mlp.tf32_split(w.t().contiguous())]
    want = torch.cat(parts).view(torch.int32)
    differ = int((ws.view(torch.int32) != want).sum())
    if differ:
        raise AssertionError(f"{what} split check: {differ} of {ws.numel()} values differ from "
                             "tf32_split's bits")
    return dict(split_values_equal=ws.numel(),
                split_lo_nonzero=int(sum((p != 0).sum() for p in parts[1::2])))


def _totals() -> dict:
    return dict(max_abs_err=0.0, err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None,
                by={"bytes": 0.0, "operations": 0.0}, per_step=0)


def run_kernel_phases() -> dict:
    """Check and time every case; returns per-step totals keyed by (name, mode), the small
    model's D = 256 cases by ("d256", name, mode), the float32 forms' by ("f32", name, mode)
    and ("f32d256", name, mode)."""
    import torch

    from aurora_tpu_torch.tools import branch_err, rel_err

    summary: dict = {}
    bits_key, bits_ref = None, None  # the output the next cases of one key must equal
    t_case = time.perf_counter()  # a case's seconds include making its inputs
    for case in kernel_cases():
        name = case["name"]
        tol = (TOL_F32 if case["f32"] else TOL)[name]
        reps = REPS_F32 if case["f32"] else REPS
        got = case["kernel"]()
        plain_ms, want = once_ms(case["plain"])
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name} {case['label']}: {got.shape}/{got.dtype} vs "
                                 f"{want.shape}/{want.dtype}")
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name} {case['label']}: non-finite output")
        def measure(out):
            """``(max |out - want|, the case's relative measure)``."""
            if case["check"] == "branch":
                return branch_err(out, want, case["residual"])
            if case["check"] == "rel_ulp":
                return branch_err(out, want, torch.zeros((), device=out.device))
            return (out.float() - want.float()).abs().max().item(), rel_err(out, want)

        more = {}
        if case["check"] == "exact":
            err, rel = (got.float() - want.float()).abs().max().item(), None
            ok = torch.equal(got, want)
        else:
            err, rel = measure(got)
            ok = rel <= tol
            if case["f32"]:
                # The plain version with TF32 products, by the same measure: what a kernel
                # that rounded its products through TF32 would show. The bound must fail it.
                more["tf32_control_err"] = measure(case["plain"].tf32())[1]
                ok = ok and more["tf32_control_err"] > tol
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

            ms = cuda_ms(timed, reps)
            more["last_run_rel_err"] = measure(last[0])[1]
            ok = ok and more["last_run_rel_err"] <= tol
            del last[:]
        else:
            ms = cuda_ms(case["kernel"], reps)
        del want
        lib_ms = cuda_ms(case["library"]) if case["library"] else None
        b, by = case["bound"]
        more["of_bound"] = b / ms
        more.update(case["bounds"])
        if lib_ms is not None:
            more["vs_library"] = ms / lib_ms
        row = dict(phase="kernel", kernel=name, mode=case["mode"], shape=case["label"],
                   dtype="float32" if case["f32"] else "bfloat16", ok=bool(ok),
                   max_abs_err=err, rel_err=rel, check=case["check"], tol=tol, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b, bound_by=by,
                   per_step=case["per_step"], **more, seconds=time.perf_counter() - t_case)
        if case["small"]:
            row["model"] = "AuroraSmallPretrained (D = 256)"
        emit(row)
        t_case = time.perf_counter()
        if not ok:
            raise AssertionError(f"{name} {case['label']}: max abs err {err}, relative error "
                                 f"{rel} (bound {tol}) {more}")
        # The small model's D = 256 shapes and the float32 forms are summed apart (per step
        # of their own model), the small model's kept shape by shape.
        group = ("f32" if case["f32"] else "") + ("d256" if case["small"] else "")
        key = (group, name, case["mode"]) if group else (name, case["mode"])
        s = summary.setdefault(key, _totals())
        if case["small"] or case["f32"]:
            s.setdefault("shapes", []).append(dict(
                shape=case["label"].removeprefix("f32 ").split("D 256: ", 1)[-1], ms=ms,
                plain_ms=plain_ms, bound_ms=b, bound_by=by, err=rel, max_abs_err=err,
                **case["bounds"],
                **{"per_small_step" if case["small"] else "per_step": case["per_step"]}))
        n = case["per_step"]
        s["per_step"] += n
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
        for k, v in case["bounds"].items():
            s[k] = s.get(k, 0.0) + n * v
        if "bound_of_tpu_work_ms" in more:  # K4: the TPU kernel's work, beside the folded
            s["bound_of_tpu_work_ms"] = s.get("bound_of_tpu_work_ms", 0.0) + n * more[
                "bound_of_tpu_work_ms"]
        torch.cuda.empty_cache()
    return summary


# ------------------------------------------------------------------------------ end to end


class _Deferred:
    """The CPU halves of the card-against-CPU references (the train steps', the routes', the
    float32 model's, the small model's and the variants'), run one after the other on one
    host thread while the card goes on with the next phases. A job runs a model's CPU
    forward (or train step), compares it with the card's output already on the host, emits
    its line and raises on a failed check;
    ``drain`` re-raises the first failure. The thread's products take all but two of the
    host's cores, so that the main thread keeps launching. ``main`` switches TF32 off for the
    whole run: ``full_f32_products`` restores the switches it found, and a region entered on
    one thread and left on the other could otherwise switch them on for the card. The phases
    beside the thread count launches through the wrappers' own counts and patch a module
    function only for their own thread's calls (``backbone_ablate.patched``)."""

    def __init__(self):
        self._pool = None
        self._jobs: list = []

    def submit(self, what: str, fn) -> None:
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            def init():
                import torch

                torch.set_num_threads(max(1, (os.cpu_count() or 4) - 2))

            self._pool = ThreadPoolExecutor(1, thread_name_prefix="cpu-reference",
                                            initializer=init)
        self._jobs.append((what, self._pool.submit(fn)))

    def drain(self) -> float:
        """Wait for every job queued so far; raise the first failure. Returns the seconds
        waited."""
        t0 = time.perf_counter()
        jobs, self._jobs = self._jobs, []
        for what, job in jobs:
            try:
                job.result()
            except Exception as e:
                raise AssertionError(f"{what}: {e}") from e
        return time.perf_counter() - t0

    def close(self) -> float:
        """:meth:`drain`, then stop the thread."""
        try:
            return self.drain()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)


def defer_reference(refs: _Deferred, what: str, model, batch, cfg, t0: float, row: dict,
                    tol: float, more: tuple = ()) -> None:
    """Move ``model`` (its card run done) to the host and queue its CPU run on ``batch`` on
    ``refs``: the mean relative error per output variable against ``row["got"]`` (the card's
    output, moved to the host here) must be <= ``tol``; the job emits ``row`` with the
    errors. ``more``: ``(knobs, row)`` pairs, each compared the same way after
    ``model.set_knobs(**knobs)`` (the same weights on another route), in order."""
    import torch

    runs = [({}, row), *more]
    gots = [r.pop("got").to("cpu") for _, r in runs]
    cpu = model.to("cpu")
    torch.cuda.empty_cache()

    def compare():
        bad = []
        for (knobs, r), got in zip(runs, gots):
            want = cpu.set_knobs(**knobs)(batch)
            errs = _reference_errs(got, want, cfg)
            worst = max(errs.values())
            emit(dict(r, against=r.get("against", "port CPU run (plain versions)"),
                      mean_rel=errs, worst=worst, tol=tol, seconds=time.perf_counter() - t0))
            if not worst <= tol:
                bad.append(f"{r.get('route', '')} mean rel {worst} > {tol}")
        if bad:
            raise AssertionError(f"card vs CPU: {bad}")

    refs.submit(what, compare)


# The launches a step that do not follow the backbone's depth: K4 and K3 in the level
# aggregation and de-aggregation (resamplers of depth 1).
_PERCEIVER = {"perceiver_core": 2, "mlp_adaln_residual": 2}


def route_launches(counts: dict, blocks: int, cfg=None) -> dict:
    """A route's launches a step (``ROUTES``, at the 1.3 B model's 48 blocks) at ``blocks``
    Swin blocks (half of them shifted at every depth); with ``cfg``, its resamplers' launches
    as ``tools.train_bench.resampler_launches`` derives them from its depths."""
    per = _PERCEIVER
    if cfg is not None:
        from aurora_tpu_torch.tools.train_bench import resampler_launches

        per = resampler_launches(cfg)
    return {k: (n - _PERCEIVER.get(k, 0)) * blocks // 48 + per.get(k, 0)
            for k, n in counts.items()}


def run_route(name: str, steps: int, ref_grid: tuple[int, int], batch, refs: _Deferred,
              then=None) -> dict:
    """The roll-out of one backbone route over ``batch`` (the 1.3 B model's 721 x 1440 host
    batch, made once for every route and the float32 phase); returns the launches over it.
    ``then(model)`` runs after the roll-out's checks and the reference's card half, while its
    CPU half, queued on ``refs``, runs on the host thread. The main route's model has the 1.3 B model's full depth; routes
    W, P, X and S roll out at two blocks per backbone stage (the second shifted) on the same
    721 x 1440 grid, so that each of their kernels still runs on every stage's token grid,
    and that model is then their reference's."""
    import torch

    from aurora_tpu_torch import rollout
    from aurora_tpu_torch.ops import _lib
    from aurora_tpu_torch.tools.perf_breakdown import build_model, numpy_batch, production_config

    knobs, counts = ROUTES[name]
    # The production model (LoRA, bf16 backbone stored in bf16, bf16 (de-)aggregation values),
    # FiLM and LoRA gates opened.
    cfg = production_config().replace(**knobs)
    if name != "main":
        cfg = cfg.replace(**TWO_BLOCKS)
    blocks = sum(cfg.encoder_depths) + sum(cfg.decoder_depths)
    expected = {k: route_launches(counts, blocks).get(k, 0) for k in _lib.LAUNCHES}
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    init_s = time.perf_counter() - t0
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
    if name == "main":  # the lat_lon phase's reference: the one-process steps, on the host
        KEPT["main"] = [{k: v.cpu() for k, v in {**p.surf_vars, **p.atmos_vars}.items()}
                        for p in preds[:LAT_LON_STEPS]]
    del preds
    emit(dict(phase="end_to_end", route=name, **knobs,
              depths=(cfg.encoder_depths, cfg.decoder_depths),
              grid="721x1440 (720x1440 after crop)", levels=13, params=n_params, init_s=init_s,
              steps=steps, step_s=step_s, peak_mem_gib=peak / 2**30,
              launches_per_step=per_step[-1], launches=launches))

    # Reference on a small input, the card against the port's CPU run of the same route: the
    # route's model at two blocks per backbone stage (the second shifted, so K1 and the
    # masked attention run), seeded on the card. The CPU half runs on the host thread, beside
    # ``then``.
    t0 = time.perf_counter()
    H, W = ref_grid
    small = numpy_batch(cfg, H, W, seed=1)
    ref_cfg = cfg.replace(**TWO_BLOCKS)
    ref_model = model if ref_cfg == cfg else build_model(ref_cfg, "cuda")
    before = dict(_lib.LAUNCHES)
    got = ref_model(small)
    torch.cuda.synchronize()
    ref_launches = {k: n - before[k] for k, n in _lib.LAUNCHES.items() if n != before[k]}
    missing = [k for k in counts if not ref_launches.get(k)]
    if missing:
        raise AssertionError(f"route {name}: the reference run never launched {missing}")
    row = dict(phase="reference", route=name, grid=f"{H}x{W}",
               depths=(ref_cfg.encoder_depths, ref_cfg.decoder_depths), launches=ref_launches,
               against="port CPU route (plain versions)", got=got)
    defer_reference(refs, f"route {name} reference", ref_model, small, ref_cfg, t0, row, 1e-2)
    del ref_model
    if then is not None:
        then(model)
    return launches


def _reference_errs(got, want, cfg) -> dict:
    """Mean relative error per output variable of two predictions."""
    errs = {k: _mean_rel(got.surf_vars[k], want.surf_vars[k]) for k in cfg.surf_vars}
    errs.update({k: _mean_rel(got.atmos_vars[k], want.atmos_vars[k]) for k in cfg.atmos_vars})
    return errs


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


BREAKDOWN_STEPS = 1  # the timed repetitions of each part of the breakdown tools


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
        for r in tool.main(["--steps", str(BREAKDOWN_STEPS)], model=model):
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
    them (``bench.measure``: every step's time, launches and peak memory, steps per second),
    each of SCAN_STEPS steps from one 721 x 1440 batch
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
        row["launches"] = dict(_lib.LAUNCHES)  # over its timed and free-running runs
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
        del coarse, files, pred, preds

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


# ------------------------------------------------------------------------------ serving

SERVED = "aurora-0.25-finetuned"  # the registry's entry served by the serving phase
SERVE_STEPS = 1  # steps of the served float32 forecast (the first, with the upload)
TOKEN = "chip-smoke-token"


def _timed_channel(folder):
    """A ``LocalFileChannel`` that keeps the host-clock span and bytes of every batch it
    sends or receives (the client's side; the server builds its own from the spec)."""
    from aurora_tpu_torch.foundry import LocalFileChannel

    class Timed(LocalFileChannel):
        def __init__(self, folder):
            super().__init__(folder)
            self.log = []

        def _send(self, batch, name):
            t0 = time.perf_counter()
            super()._send(batch, name)
            self.log.append(dict(op="send", name=name, t0=t0, t1=time.perf_counter(),
                                 bytes=os.path.getsize(self._path(name))))

        def _receive(self, name):
            t0 = time.perf_counter()
            out = super()._receive(name)
            self.log.append(dict(op="receive", name=name, t0=t0, t1=time.perf_counter(),
                                 bytes=os.path.getsize(self._path(name))))
            return out

    return Timed(folder)


def run_serving(model, batch, preds, ic, work) -> None:
    """The serving stack on the card, inside the float32 phase: ``model``'s weights (the
    ``Aurora`` facade in its default config) written once with ``checkpoint.save_params`` as
    the artifact of the registry's ``SERVED`` entry; ``foundry.http_server.serve`` on a
    loopback port with a token; the port's ``FoundryClient`` + ``submit`` over a
    ``LocalFileChannel`` under ``work`` ask for SERVE_STEPS steps of the initial condition
    ``ic`` (its file, read back; its arrays must be ``batch``'s bits). The served task loads
    the artifact into the registry's model (full width and depth, the facade's default
    config, as the JAX registry builds it) on the card, on the server's worker thread. The
    client's predictions must be ``preds``' bits (``rollout`` of the same weights on
    ``batch``), with ``rollout_step`` 1..N; the launches over the served roll-out (counts set
    to 0 just before ``submit``) are the main route's a step; a bad token gets 401. Prints
    the served forecast's parts."""
    import urllib.error

    import numpy as np
    import torch

    from aurora_tpu_torch import Batch
    from aurora_tpu_torch.checkpoint import save_params
    from aurora_tpu_torch.foundry import FoundryClient, submit
    from aurora_tpu_torch.foundry import models as registry
    from aurora_tpu_torch.foundry.http_server import serve
    from aurora_tpu_torch.ops import _lib

    t_phase = time.perf_counter()
    art = os.path.join(work, f"{SERVED}.pt")
    t0 = time.perf_counter()
    save_params(model, art)
    art_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ic_batch = Batch.from_netcdf(ic)
    ic_read_s = time.perf_counter() - t0
    same_input = agreement([batch], [ic_batch])["bit_equal"]
    registry.ARTIFACTS[SERVED] = art
    try:
        with serve(token=TOKEN) as handle:
            try:
                FoundryClient(handle.url, "not-the-token").submit_task({})
                bad_token = None
            except urllib.error.HTTPError as e:
                bad_token = e.code
            client = FoundryClient(handle.url, TOKEN)
            channel = _timed_channel(os.path.join(work, "serving"))
            _lib.reset_launches()
            got, got_at = [], []
            t_submit = time.perf_counter()
            for pred in submit(ic_batch, SERVED, SERVE_STEPS, channel, client):
                got.append(pred)
                got_at.append(time.perf_counter())
            launches = dict(_lib.LAUNCHES)
            (task,) = handle.inference.tasks.values()
    finally:
        del registry.ARTIFACTS[SERVED]
    torch.cuda.empty_cache()
    sent = [r for r in channel.log if r["op"] == "send"]
    received = [r for r in channel.log if r["op"] == "receive"]
    tm = task.timings
    steps = [dict(s, bytes=r["bytes"]) for s, r in zip(tm["steps"], received)]
    vs_rollout = agreement(preds[:SERVE_STEPS], got)
    expected = {k: SERVE_STEPS * n for k, n in ROUTES["main"][1].items()}
    served_launches = {k: n for k, n in launches.items() if n}
    row = dict(phase="serving", model=SERVED, grid="721x1440", steps=SERVE_STEPS,
               artifact_bytes=os.path.getsize(art), artifact_write_s=art_s,
               ic_read_s=ic_read_s, ic_is_the_batch=same_input,
               upload_s=sent[0]["t1"] - sent[0]["t0"], upload_bytes=sent[0]["bytes"],
               task_load_s=tm.get("load_s"), task_input_read_s=tm.get("read_s"),
               task_steps=steps, poll_wait_s=received[0]["t0"] - tm["done_at"],
               read_back_s=[r["t1"] - r["t0"] for r in received],
               submit_to_last_prediction_s=got_at[-1] - t_submit,
               status=task.task_info.status, bad_token_status=bad_token,
               files_vs_rollout=vs_rollout, launches=served_launches,
               expected_launches=expected, seconds=time.perf_counter() - t_phase)
    emit(row)
    os.remove(art)
    bad = []
    if not (same_input and vs_rollout["bit_equal"]):
        bad.append(f"the served predictions are not rollout's bits: {vs_rollout}, input "
                   f"the batch's bits {same_input}")
    if [p.metadata.rollout_step for p in got] != list(range(1, SERVE_STEPS + 1)):
        bad.append(f"roll-out steps {[p.metadata.rollout_step for p in got]}")
    if served_launches != expected:
        bad.append(f"launches {served_launches} != {expected}")
    if bad_token != 401:
        bad.append(f"a bad token got {bad_token}, not 401")
    if not all(np.isfinite(v).all() for p in got for v in p.surf_vars.values()):
        bad.append("non-finite predictions")
    if bad:
        raise AssertionError(f"serving: {bad}")


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
# Float32 (the default config): each input's gradient through the kernel's Function (the
# kernel forward, the backward of the plain math with full float32 products) against the
# plain math's gradient in float64 on the same inputs, by relative L2 error. Only an input
# whose float64 gradient is negligible (its norm below F32_GRAD_NEGLIGIBLE x the largest of
# the call's) takes as denominator F32_GRAD_FLOOR x the largest RMS gradient of the call,
# scaled to its size: ln_k's bias gradient, zero in exact arithmetic, holds float32 rounding
# noise of ~1e-7 of the call's gradients.
F32_GRAD_TOL, F32_GRAD_FLOOR, F32_GRAD_NEGLIGIBLE = 1e-4, 1e-2, 1e-6
BWD_REPS_F32 = 1  # timed float32 backward runs per kernel, after one warm-up run
# The float32 LoRA step at two blocks a stage, 121 x 240, card against the port's CPU run:
# the loss (relative) and the concatenated LoRA gradient (relative L2).
F32_TRAIN_LOSS_TOL, F32_TRAIN_GRAD_TOL = 1e-4, 1e-3
PARALLEL_DATA = 2  # ranks of the parallel phase, all on the one card over gloo
# The label of K3's case with the tokens alone asking for a gradient, which its hand-written
# input gradient (csrc/mlp_grad.cu) takes in bf16.
X_ALONE = "x alone (the input gradient)"


def grad_cases(rn, dtype=None):
    """One case per kernel (K2 and K6 also without the tail, K4 also with ln_k) on inputs cut
    to a few thousand rows, windows or columns (FiLM at unit gain), with the main path's
    shape of the kernel for timing the backward: ``(name, label, call, plain, make, timed)``
    where ``make(full)`` gives the arguments (every tensor a leaf that requires a gradient)
    and ``timed`` marks the case whose backward is timed, one a kernel: the one the main
    path's train step runs (K2 and K6 with the tail, K4's de-aggregation). ``dtype``: the
    tokens' and weights' dtype, bf16 (the production knobs; K4 with bf16 values) or float32
    (the default config; K4 in float32)."""
    import torch

    from aurora_tpu_torch.ops import mlp, resampler, roll, window_attention as wa
    from aurora_tpu_torch.ops.masks import window_group_ids

    f32 = torch.float32
    dtype = dtype or torch.bfloat16
    ws, ss = (2, 6, 12), (1, 3, 6)

    def leaf(*shape, std=1.0, dtype=dtype):
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
                      value_bf16=dtype == torch.bfloat16, lnk=None if lw is None else (lw, lb))
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
    if dtype == torch.bfloat16:  # LoRA training: the weights and the FiLM frozen

        def x_alone(full):
            x, *rest = (*mlp_args(full), *film())
            return (x, *(t.detach() for t in rest))

        yield ("mlp_adaln_residual",
               f"{X_ALONE}, (1,4096,512) hidden 2048; timed (1,259200,512)",
               mlp.mlp_adaln_residual, mlp.mlp_adaln_residual_plain, x_alone, True)
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
        x_alone = label.startswith(X_ALONE)
        if launched.get("mlp_adaln_residual_grad", 0) != int(x_alone):
            raise AssertionError(f"grad {name} {label}: K3's input gradient launched "
                                 f"{launched.get('mlp_adaln_residual_grad', 0)} times")
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
            # Plain autograd's time is its check's own call: no yardstick, timed once.
            times["plain_bwd_ms"] = time_ms(lambda: kept.update(want=grads(ref, tleaves, g)),
                                            dev, 1, warmup=0)
            times["bwd_shape"] = label.split("timed ")[-1]
            if x_alone:  # the bound of its four products, 2 rows D Hd flops each
                rows, D = targs[0].shape[1:]
                times["bound_ms"] = 4 * 2 * rows * D * targs[1].shape[1] / 989e12 * 1e3
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
        if x_alone:
            s["input_grad"] = dict(times, grad_err=worst)
        else:
            s.update(times)
            s["grad_err"] = max(s["grad_err"], worst)
    emit(dict(phase="grad", seconds=time.perf_counter() - t0))
    return out_summary


def grad_rel_l2(got, want) -> list[float]:
    """The relative L2 error of each input's gradient; a negligible one's against the floor
    (see F32_GRAD_TOL)."""
    norms = [b.double().norm().item() for b in want]
    rms = max(n / b.numel() ** 0.5 for n, b in zip(norms, want))
    return [(a.double() - b.double()).norm().item()
            / (n if n >= F32_GRAD_NEGLIGIBLE * max(norms)
               else F32_GRAD_FLOOR * rms * b.numel() ** 0.5)
            for a, b, n in zip(got, want, norms)]


def run_f32_grad_phases() -> dict:
    """Float32 K1-K8 (the default config's forms; K2 and K6 also without the tail, K4 also
    with ``ln_k``) at ``grad_cases``' cut shapes: each input's gradient through the kernel's
    ``Function`` (the backward: the plain math with full float32 products, TF32 off) against
    the plain version's gradient in float64 on the same inputs, within F32_GRAD_TOL (relative
    L2). The backward of the case the train step runs, timed once after a warm-up at the
    main path's shape, beside plain autograd's in float32, the two held to each other by the
    same measure. Returns per kernel the worst error and the times."""
    import torch

    from aurora_tpu_torch.model.nn import full_f32_products
    from aurora_tpu_torch.ops import _lib
    from aurora_tpu_torch.tools import time_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)

    def rn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    def grads(out, leaves, g):
        return torch.autograd.grad(out, leaves, g, retain_graph=True)

    def f64(a):
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return a.detach().double().requires_grad_(a.requires_grad)
        return a

    t0 = time.perf_counter()
    out_summary: dict = {}
    for name, label, call, plain, make, timed in grad_cases(rn, torch.float32):
        args = make(False)
        leaves = [a for a in args if isinstance(a, torch.Tensor) and a.requires_grad]
        before = dict(_lib.LAUNCHES)
        by_before = dict(_lib.LAUNCHES_BY)
        with full_f32_products():
            out = call(*args)
            node = type(out.grad_fn).__name__
            g = rn(*out.shape)
            got = grads(out, leaves, g)
            args64 = [f64(a) for a in args]
            want = grads(plain(*args64), [a for a in args64 if isinstance(a, torch.Tensor)
                                          and a.requires_grad], g.double())
        torch.cuda.synchronize()
        if node not in ("_KernelGradBackward", "_RollBackward") or out.dtype != torch.float32:
            raise AssertionError(f"grad f32 {name} {label}: the output's node is {node}, its "
                                 f"dtype {out.dtype}")
        launched = {k: v - before[k] for k, v in _lib.LAUNCHES.items() if v != before[k]}
        dtypes = sorted({k[1] for k, v in _lib.LAUNCHES_BY.items() if v != by_before.get(k, 0)})
        errs = grad_rel_l2(got, want)
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        del out, got, want, args, args64, leaves
        times = {}
        if timed:
            targs = make(True)
            tleaves = [a for a in targs if isinstance(a, torch.Tensor) and a.requires_grad]
            kept = {}
            with full_f32_products():
                out = call(*targs)
                g = rn(*out.shape)
                times["bwd_ms"] = time_ms(lambda: kept.update(got=grads(out, tleaves, g)),
                                          dev, BWD_REPS_F32, warmup=1)
                del out
                torch.cuda.empty_cache()
                ref = plain(*targs)
                times["plain_bwd_ms"] = time_ms(
                    lambda: kept.update(want=grads(ref, tleaves, g)), dev, 1, warmup=0)
            times["bwd_shape"] = label.split("timed ")[-1]
            del ref, targs, tleaves, g
            times["bwd_rel_err"] = grad_rel_l2(kept["got"], kept["want"])
            finite = finite and all(bool(torch.isfinite(a).all()) for a in kept["got"])
            del kept
            torch.cuda.empty_cache()
        worst = max(errs + times.get("bwd_rel_err", []))
        ok = finite and worst <= F32_GRAD_TOL and dtypes in (["float32"], [])
        emit(dict(phase="grad", dtype="float32", kernel=name, shape=label, ok=ok,
                  rel_l2=errs, tol=F32_GRAD_TOL, against="plain math in float64", node=node,
                  launches=launched, launch_dtypes=dtypes, **times))
        if not ok:
            raise AssertionError(f"grad f32 {name} {label}: errors {errs}, at the timed shape "
                                 f"{times.get('bwd_rel_err')} (bound {F32_GRAD_TOL}), finite "
                                 f"{finite}, launches by dtype {dtypes}")
        s_ = out_summary.setdefault(name, dict(grad_err=0.0))
        s_.update(times)
        s_["grad_err"] = max(s_["grad_err"], worst)
    emit(dict(phase="grad", dtype="float32", seconds=time.perf_counter() - t0))
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
    """The production model's LoRA train step at full width and two blocks a backbone stage
    (the second shifted; the step at full depth is ``tools.train_bench``'s), as
    ``tools.train_bench`` runs it (``remat`` at the JAX recipe's scope "full"): a warm-up
    step, then TRAIN_STEPS timed; every LoRA parameter a finite, non-zero gradient at every
    step, and moved; every frozen parameter its bits; the losses finite; each step's launches
    the derived count; peak memory under 80 GB."""
    import torch

    from aurora_tpu_torch.tools import train_bench
    from aurora_tpu_torch.training import make_train_step

    t0 = time.perf_counter()
    cfg = train_bench.train_config().replace(**TWO_BLOCKS)
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
    def update(i):
        loss = step(surf, static, atmos, enc, i % 3, tgt_s, tgt_a)
        if i == 0:  # the lat_lon phase's reference: the first step, before its update
            KEPT["train"] = dict(loss=float(loss), grads={
                n: g.detach().float().cpu() for n, g in opt.grads.items()})
        return loss

    row = train_bench.run_steps(update, TRAIN_STEPS, torch.device("cuda"))
    _check_train(model, opt, lora0, frozen, row, train_bench.expected_launches(cfg, lora=True),
                 dict(phase="train", part="LoRA train step", grid="721x1440 (720x1440)",
                      depths=(cfg.encoder_depths, cfg.decoder_depths),
                      remat_scope=cfg.remat_scope, seconds=time.perf_counter() - t0))
    return model, (surf, static, atmos, enc, levels, tgt_s, tgt_a)


def run_stochastic_step_phase(model, inputs) -> dict:
    """The LoRA train step of the production model at full width and two blocks a stage with
    stochastic depth (``drop_path`` STO_DROP_PATH, ``drop_rate`` 0: the LoRA train step's model
    with the knob set) on its inputs, one step at 721 x 1440 with a generator: its launches as
    ``expected_launches(stochastic=True)`` derives them (K1 in every shifted block, K2 and K3
    only in the two blocks at rate 0), every LoRA parameter a finite, non-zero gradient and
    moved, the frozen ones their bits, peak memory under 80 GB. A block whose attention
    branch the draw dropped (the batch holds one element) gives its LoRA adapters a zero
    gradient: the draws are recorded, and those adapters must have exactly zero."""
    import torch

    from aurora_tpu_torch.model import nn as tnn
    from aurora_tpu_torch.ops import _lib
    from aurora_tpu_torch.tools import train_bench
    from aurora_tpu_torch.tools.backbone_ablate import patched
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
    with patched(tnn, "keep_mask", recorded):
        t1 = time.perf_counter()
        loss = float(step(surf, static, atmos, enc, 0, tgt_s, tgt_a, generator=gen))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
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


def run_train_references(refs: _Deferred) -> None:
    """The card against the port's CPU run: the recipe's model at two blocks per backbone
    stage (the second shifted), seeded on the card, one LoRA train step at 121 x 240 without
    remat (the rematerialisation is the same arithmetic, held in float64 on the CPU by the
    tests), on each device deterministic and then with STO_REF's stochastic knobs; the loss
    within TRAIN_LOSS_TOL relative and the concatenated LoRA gradient within TRAIN_GRAD_TOL
    relative L2 error. The stochastic steps take a generator of the same seed on both
    devices and draw every mask on the CPU (on the card ``nn.keep_mask`` wrapped to draw
    there and move the mask to the step's device), so that the two runs drop the same
    branches and elements; every block then runs the stochastic route (K1, plain attention
    and MLP), the perceivers K4 and K3. The card's steps first (masks drawn on the CPU through
    the wrapped ``nn.keep_mask``), then the CPU's (which draws its own there, unwrapped: the
    wrapper acts on this thread's calls only), queued on ``refs``."""
    import torch

    from aurora_tpu_torch.model import nn as tnn
    from aurora_tpu_torch.ops import _lib
    from aurora_tpu_torch.tools import train_bench
    from aurora_tpu_torch.tools.backbone_ablate import patched
    from aurora_tpu_torch.training import make_train_step

    t0 = time.perf_counter()
    cfg = train_bench.train_config(remat=False).replace(**TWO_BLOCKS)
    model = train_bench.build(cfg, "cuda", "lora")
    H, W = TRAIN_REF_GRID

    def steps(model) -> dict:
        """Both steps on ``model``'s device: ``{stochastic: (loss, LoRA gradient, launches,
        seconds)}``; launches on the card only (the count is the process's)."""
        on_card = model.device.type == "cuda"
        (surf, static, atmos, batch), (tgt_s, tgt_a) = train_bench.inputs(model, H, W)
        enc = model.prepare_encodings(batch, torch.float32)
        levels = tuple(float(x) for x in batch.metadata.atmos_levels)
        out = {}
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
                        if v != before[k]} if on_card else None
            flat = torch.cat([g.float().flatten().cpu() for g in opt.grads.values()])
            out[stochastic] = (float(loss), flat, launched, time.perf_counter() - t1)
        return out

    draw = tnn.keep_mask
    with patched(tnn, "keep_mask", lambda shape, keep, seed, path, device: draw(
            shape, keep, seed, path, "cpu").to(device)):
        card = steps(model)
    model = model.to("cpu")
    torch.cuda.empty_cache()

    def compare():
        cpu = steps(model)
        bad = []
        for stochastic in (False, True):
            (lc, gc, launched, sc), (lp, gp, _, sp) = card[stochastic], cpu[stochastic]
            loss_err = abs(lc - lp) / abs(lp)
            grad_err = ((gc - gp).norm() / gp.norm()).item()
            knobs = STO_REF if stochastic else {}
            emit(dict(phase="train",
                      part="stochastic card vs CPU" if stochastic else "card vs CPU",
                      grid=f"{H}x{W}", depths=(cfg.encoder_depths, cfg.decoder_depths), **knobs,
                      loss_card=lc, loss_cpu=lp, loss_rel_err=loss_err,
                      lora_grad_rel_l2=grad_err, tol=(TRAIN_LOSS_TOL, TRAIN_GRAD_TOL),
                      launches=launched, step_s=dict(card=sc, cpu=sp),
                      seconds=time.perf_counter() - t0))
            need = ("roll3d", "roll3d_bwd", "mlp_adaln_residual", "perceiver_core")
            if not stochastic:
                need += ("window_attention",)
            missing = [k for k in need if not launched.get(k)]
            fused = stochastic and launched.get("window_attention")
            if missing or fused or not (loss_err <= TRAIN_LOSS_TOL
                                        and grad_err <= TRAIN_GRAD_TOL):
                bad.append(f"{knobs}: loss {loss_err}, LoRA gradient {grad_err}, kernels "
                           f"never launched {missing}, K2 in stochastic blocks {fused}")
        if bad:
            raise AssertionError(f"train card vs CPU: {bad}")

    refs.submit("train references", compare)


def run_f32_train_phases(refs: _Deferred) -> dict:
    """Float32 training (``Aurora()``'s default config: no ``autocast``, nothing cast to
    bf16), one model at full width and two blocks per backbone stage (the second shifted),
    seeded on the card:

    * its LoRA train step with ``remat`` at "full" on 721 x 1440, as ``tools.train_bench
      --default-config`` runs it: a warm-up step, then TRAIN_STEPS timed; the checks of the
      bf16 step (``_check_train``), every launch of the timed step on float32 tokens and every
      parameter float32;
    * then, without remat (the same arithmetic, held in float64 on the CPU by the tests), one
      LoRA step at 121 x 240 on the card and, queued on ``refs``, on the CPU from the same
      weights and inputs: the loss within F32_TRAIN_LOSS_TOL relative and the concatenated
      LoRA gradient within F32_TRAIN_GRAD_TOL relative L2; the card's step launched every
      kernel of the main route, each on float32 tokens."""
    import torch

    from aurora_tpu_torch.ops import _lib
    from aurora_tpu_torch.tools import train_bench
    from aurora_tpu_torch.tools.perf_breakdown import config_form
    from aurora_tpu_torch.training import make_train_step

    t0 = time.perf_counter()
    cfg = train_bench.train_config(default=True).replace(**TWO_BLOCKS)
    model = train_bench.build(cfg, "cuda", "lora")

    def inputs(H, W):
        (surf, static, atmos, batch), (tgt_s, tgt_a) = train_bench.inputs(model, H, W)
        return (surf, static, atmos, model.prepare_encodings(batch, torch.float32),
                tuple(float(x) for x in batch.metadata.atmos_levels),
                {k: v[0] for k, v in tgt_s.items()}, {k: v[0] for k, v in tgt_a.items()})

    surf, static, atmos, enc, levels, tgt_s, tgt_a = inputs(721, 1440)
    opt = _Watched()
    step = make_train_step(model, opt, levels)
    lora0 = {n: p.detach().clone() for n, p in opt.params.items()}
    frozen = _frozen_snapshot(model)
    by = {}

    def timed(i):
        by.clear()
        by.update(_lib.LAUNCHES_BY)
        return step(surf, static, atmos, enc, i % 3, tgt_s, tgt_a)

    row = train_bench.run_steps(timed, TRAIN_STEPS, torch.device("cuda"))
    dtypes = sorted({k[1] for k, v in _lib.LAUNCHES_BY.items() if v != by.get(k, 0)})
    param_dtypes = sorted({str(p.dtype) for p in model.parameters()})
    _check_train(model, opt, lora0, frozen, row, train_bench.expected_launches(cfg, lora=True),
                 dict(phase="train", part="float32 LoRA train step", config=config_form(cfg),
                      grid="721x1440 (720x1440)", depths=(cfg.encoder_depths, cfg.decoder_depths),
                      remat_scope=cfg.remat_scope, launch_dtypes=dtypes,
                      param_dtypes=param_dtypes, seconds=time.perf_counter() - t0))
    if dtypes != ["float32"] or param_dtypes != ["torch.float32"]:
        raise AssertionError(f"float32 LoRA train step: launches in {dtypes}, parameters in "
                             f"{param_dtypes}")
    del surf, static, atmos, enc, tgt_s, tgt_a, step, opt, lora0, frozen
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model.set_knobs(remat=False)
    H, W = TRAIN_REF_GRID

    def one_step(model):
        surf, static, atmos, enc, levels, tgt_s, tgt_a = inputs(H, W)
        opt = _Watched(update=False)
        step = make_train_step(model, opt, levels)
        t1 = time.perf_counter()
        loss = step(surf, static, atmos, enc, 0, tgt_s, tgt_a)
        flat = torch.cat([g.flatten().cpu() for g in opt.grads.values()])
        return float(loss), flat, time.perf_counter() - t1

    before, by = dict(_lib.LAUNCHES), dict(_lib.LAUNCHES_BY)
    lc, gc, sc = one_step(model)
    launched = {k: v - before[k] for k, v in _lib.LAUNCHES.items() if v != before[k]}
    dtypes = sorted({k[1] for k, v in _lib.LAUNCHES_BY.items() if v != by.get(k, 0)})
    model = model.to("cpu")
    torch.cuda.empty_cache()

    def compare():
        lp, gp, sp = one_step(model)
        loss_err = abs(lc - lp) / abs(lp)
        grad_err = ((gc.double() - gp.double()).norm() / gp.double().norm()).item()
        emit(dict(phase="train", part="float32 card vs CPU", config=config_form(cfg),
                  grid=f"{H}x{W}", depths=(cfg.encoder_depths, cfg.decoder_depths),
                  remat=model.cfg.remat, loss_card=lc, loss_cpu=lp, loss_rel_err=loss_err,
                  lora_grad_rel_l2=grad_err, tol=(F32_TRAIN_LOSS_TOL, F32_TRAIN_GRAD_TOL),
                  launches=launched, launch_dtypes=dtypes, step_s=dict(card=sc, cpu=sp),
                  seconds=time.perf_counter() - t0))
        missing = [k for k in ("roll3d", "roll3d_bwd", "window_attention",
                               "mlp_adaln_residual", "perceiver_core") if not launched.get(k)]
        if missing or dtypes != ["float32"] or not (loss_err <= F32_TRAIN_LOSS_TOL
                                                    and grad_err <= F32_TRAIN_GRAD_TOL):
            raise AssertionError(f"float32 train card vs CPU: loss {loss_err}, LoRA gradient "
                                 f"{grad_err}, kernels never launched {missing}, launches in "
                                 f"{dtypes}")

    refs.submit("float32 train reference", compare)
    return row


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


def run_train_phases(refs: _Deferred) -> dict:
    """The phase ``train``: the card against the CPU first (its CPU half queued on ``refs``,
    so that it runs beside the rest), the kernels' gradients in both dtypes, then the
    full-width LoRA, stochastic, float32 and roll-out train steps. Returns the gradient
    phases' summaries, which the kernels line reads."""
    import torch

    t0 = time.perf_counter()
    run_train_references(refs)
    torch.cuda.empty_cache()
    grads = run_grad_phases()
    grads_f32 = run_f32_grad_phases()
    model, inputs = run_train_step_phase()
    torch.cuda.empty_cache()
    run_stochastic_step_phase(model, inputs)
    del model, inputs
    torch.cuda.empty_cache()
    run_f32_train_phases(refs)
    torch.cuda.empty_cache()
    run_rollout_train_phase()
    torch.cuda.empty_cache()
    run_card_draws()
    emit(dict(phase="train", seconds=time.perf_counter() - t0))
    return dict(grads=grads, grads_f32=grads_f32)


# ------------------------------------------------------------------------------ parallel


_CHILDREN: list = []  # the worker processes started, stopped on the way out if still running


def nccl_one_rank(folder: str) -> dict:
    """A one-rank NCCL group and one all-reduce on the card: the backend a multi-card user
    gets comes up."""
    import torch
    import torch.distributed as dist

    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{folder}/nccl_store", rank=0,
                            world_size=1)
    try:
        x = torch.arange(4, dtype=torch.float32, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        out = dict(ok=x.tolist() == [0.0, 1.0, 2.0, 3.0], backend=dist.get_backend(),
                   nccl_version=".".join(map(str, torch.cuda.nccl.version())))
    finally:
        dist.destroy_process_group()
    return dict(out, seconds=time.perf_counter() - t0)


def start_parallel():
    """Start the parallel phase's PARALLEL_DATA worker processes of ``tools.multihost_sim``
    held: each imports, makes its host side ready and waits, touching the card only once
    :func:`run_parallel` releases it. Returns what :func:`run_parallel` takes."""
    import tempfile

    from aurora_tpu_torch.tools import multihost_sim

    folder = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    procs = multihost_sim.spawn_workers(PARALLEL_DATA, folder, "cuda", hold=True)
    _CHILDREN.extend(procs)
    return procs, folder


def run_parallel(started) -> dict:
    """The data axis on the card: ``tools.multihost_sim``'s PARALLEL_DATA ranks (a gloo group
    meeting in a ``FileStore``, every rank on the one card: NCCL refuses two ranks on one
    device), each running the kernels on its half of the JAX tool's batch of 2 (on the card's
    layout: 13 levels, 121 x 240), against the same work in this process on the whole batch
    (``AuroraSmallPretrained(use_lora=True)`` in float32): the forward and a one-step
    ``rollout``, the LoRA step's gradients and its parameters where the gradient is resolved
    within 1e-5 max-rel, the K = 2 roll-out step's gradients within the tool's
    ``ROLLOUT_GRAD_TOL``, the losses within 1e-6, the full fine-tune step under
    ``shard_params`` (its probe parameter within 1e-5, each rank's AdamW moments of a split
    parameter half of it); every rank launched K1-K4. Then a one-rank NCCL group
    (:func:`nccl_one_rank`). The ranks, started held by :func:`start_parallel` beside the
    build, are released here, after every timed phase: nothing timed shares the card with
    them."""
    import shutil

    import torch

    from aurora_tpu_torch.tools import multihost_sim

    procs, folder = started
    t0 = time.perf_counter()
    multihost_sim.release(folder)
    try:
        try:
            ref = multihost_sim.run(torch.device("cuda"))
            KEPT["parallel"] = ref  # the lat_lon phase's small-model train reference
        finally:
            ranks = multihost_sim.collect(procs, folder)
        nccl = nccl_one_rank(folder)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    res = multihost_sim.result(ref, ranks, "cuda", time.perf_counter() - t0)
    need = ("roll3d", "window_attention", "mlp_adaln_residual", "perceiver_core")
    idle = [i for i, n in enumerate(res["launches_per_rank"]) if not all(n.get(k) for k in need)]
    emit(dict(phase="parallel", **res, nccl=nccl))
    if not res["ok"] or idle or res["backend"] != "gloo" or not nccl["ok"]:
        raise AssertionError(f"parallel: checks {res['ok']}, ranks that launched no kernel "
                             f"{idle}, backend {res['backend']}, NCCL {nccl}")
    return res


# ------------------------------------------------------------------------------ lat_lon

LAT_LON = dict(data=1, lat=2, lon=2)  # the mesh of the lat_lon phase's ranks
# The one-process references of the lat_lon phase, kept on the host: "main" the main route's
# first predictions, "train" the train phase's first LoRA step (loss, gradients before the
# update), "parallel" the parallel phase's one-process run (the small model's LoRA and
# roll-out steps).
KEPT: dict = {}
# The lat_lon ranks' train steps after their serving checks: the train phase's bf16 LoRA step
# (two blocks a stage, remat "full", its 720 x 1440 batch and persistence targets) and the
# parallel phase's float32 small-model LoRA and K = 2 roll-out steps (its batch of 2 at
# 121 x 240), each on the rank's block.
LAT_LON_TRAIN = "production:lora,small:lora,small:rollout"
LAT_LON_TRAIN_DEPTHS = 2
LAT_LON_STEPS = 1  # the serving roll-out's steps on the lat_lon ranks
# The small model's steps against the parallel phase's one process: the data-parallel checks'
# bounds (multihost_sim): losses relative, LoRA gradients max-rel where |g| >= RESOLVED,
# roll-out gradients max-rel.
LAT_LON_SMALL_TOL = dict(loss=1e-6, lora=1e-5, rollout=1e-4)
# What the ranks' blocks must see on the 720 x 1440 grid (swin3d.py:1146-1175): the second
# stage's 90 x 180 token grid over-padded by (0, 6, 12); its 45 rows a rank odd at the merge
# into the third stage; the third stage's 45 rows split unevenly; a shifted block of the
# first stage sending 3 rows and 6 columns of a 90 x 180 block of 512 bf16 features, in and out
# (4 x 2,211,840 bytes a rank).
LAT_LON_GEOMETRY = dict(overpadded=((4, 90, 180), (0, 6, 12)),
                        odd_merge=((4, 90, 180), (45, 90)), uneven=(4, 45, 90),
                        stage1_shifted_bytes=4 * 4 * 3 * 180 * 512 * 2)


def start_lat_lon():
    """Start the lat_lon phase's ranks held (``tools.multihost_sim --config production``,
    one a rank of LAT_LON): each imports and makes the main path's 721 x 1440 batch on the
    host, then waits, touching the card only once :func:`run_lat_lon` releases it."""
    import tempfile

    from aurora_tpu_torch.tools import multihost_sim

    folder = tempfile.mkdtemp(prefix="chip_smoke_lat_lon_")
    flags = ["--data", str(LAT_LON["data"]), "--lat", str(LAT_LON["lat"]), "--lon",
             str(LAT_LON["lon"]), "--config", "production", "--no-scan", "--steps",
             str(LAT_LON_STEPS), "--train", LAT_LON_TRAIN, "--train-depths",
             str(LAT_LON_TRAIN_DEPTHS), "--remat", "none"]
    n = LAT_LON["data"] * LAT_LON["lat"] * LAT_LON["lon"]
    procs = multihost_sim.spawn_workers(n, folder, "cuda", hold=True, extra=flags)
    _CHILDREN.extend(procs)
    return procs, folder


def release_lat_lon(started) -> float:
    """Let the lat_lon phase's held ranks go on (after every timed phase); returns when."""
    import torch

    from aurora_tpu_torch.tools import multihost_sim

    torch.cuda.empty_cache()
    multihost_sim.release(started[1])
    return time.perf_counter()


def run_lat_lon(started, released: float) -> dict:
    """The (lat, lon) split on the card: the ranks started by :func:`start_lat_lon` (one gloo
    group, every rank on the one card), each with the main route's 1.3 B production model
    (the same seeded weights and batch) on its block of the 720 x 1440 grid under
    ``make_mesh(data=1, lat=2, lon=2)``: ``Aurora.forward`` and a LAT_LON_STEPS-step
    ``rollout``, each prediction gathered (``gather_batch``). Held against the main route's
    one-process steps (KEPT, on the host): the forward and the roll-out's step 1 against step
    1, mean relative error per variable within the tool's
    PRODUCTION_TOL (1e-2, the bf16 bar). Every rank must have launched K1-K4, and the blocks
    must have seen LAT_LON_GEOMETRY. Prints each rank's step times (four ranks sharing one
    card: not a scaling figure) and the halo bytes each rank sent per block. The ranks ran
    beside the parallel phase's (released with them by :func:`release_lat_lon`). Then their
    train steps (:func:`lat_lon_train`)."""
    import shutil

    import torch

    from aurora_tpu_torch.tools import multihost_sim

    procs, folder = started
    want = KEPT.pop("main")
    t0 = time.perf_counter()
    try:
        ranks = multihost_sim.collect(procs, folder, timeout=600)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    released_s = time.perf_counter() - released
    key = "720x1440"
    got = ranks[0]["grids"][key]
    parts = [("forward", want[0], got["forward"])]
    parts += [(f"rollout {i + 1}", w, g) for i, (w, g) in enumerate(zip(want, got["rollout"]))]
    errs, shapes_ok = {}, len(got["rollout"]) == LAT_LON_STEPS
    for what, w, g in parts:
        shapes_ok = shapes_ok and sorted(w) == sorted(g) and all(
            g[k].shape == w[k].shape and torch.isfinite(g[k]).all() for k in w)
        errs[what] = {k: _mean_rel(g[k], w[k]) for k in w}
    worst = {what: max(e.values()) for what, e in errs.items()}
    max_rel = {what: max(float((g[k].double() - w[k].double()).abs().max()
                               / w[k].double().abs().max()) for k in w) for what, w, g in parts}
    geo = multihost_sim.geometry([r["grids"][key]["halo"] for r in ranks], LAT_LON)
    need = ("roll3d", "window_attention", "mlp_adaln_residual", "perceiver_core")
    launches = [r["grids"][key]["launches"] for r in ranks]
    idle = [i for i, n in enumerate(launches) if not all(n.get(k) for k in need)]
    expect = LAT_LON_GEOMETRY
    stage1 = [sorted({b for res, sh, b in blocks if tuple(res) == (4, 180, 360) and any(sh[1:])})
              for blocks in geo["block_bytes"]]
    seen_ok = (expect["overpadded"] in geo["overpadded"]
               and expect["odd_merge"] in geo["odd_merges"] and expect["uneven"] in geo["uneven"]
               and geo["shifted_lat"] and geo["shifted_lon"] and geo["encoder_local"]
               and not geo["encoder_whole"]
               and all(b == [expect["stage1_shifted_bytes"]] for b in stage1))
    emit(dict(phase="lat_lon", mesh=LAT_LON, processes=len(ranks), backend=ranks[0]["backend"],
              model="Aurora(use_lora=True) 1.3 B, production knobs (main route)",
              grid="721x1440 (720x1440 after crop)", steps=LAT_LON_STEPS,
              mean_rel_worst=worst, mean_rel=errs, max_rel=max_rel,
              tol=multihost_sim.PRODUCTION_TOL,
              against="the main route's one-process roll-out on the card (step 1)",
              geometry={k: geo[k] for k in ("overpadded", "odd_merges", "uneven", "shifted_lat",
                                            "shifted_lon", "encoder_local", "encoder_whole")},
              halo_bytes_per_block=geo["block_bytes"], halo_bytes_sent=geo["bytes_sent"],
              halo_collectives=geo["collectives"], stage1_shifted_block_bytes=stage1,
              step_s_per_rank=[r["grids"][key]["step_s"] for r in ranks],
              forward_s_per_rank=[r["grids"][key]["forward_s"] for r in ranks],
              build_s_per_rank=[r["build_s"] for r in ranks],
              step_s_label="four ranks sharing one card, beside the parallel phase's two ranks "
                           "and its one-process run: not a scaling figure",
              launches_per_rank=launches, released_to_collected_s=released_s,
              seconds=time.perf_counter() - t0))
    if (not shapes_ok or max(worst.values()) > multihost_sim.PRODUCTION_TOL or idle
            or not seen_ok or ranks[0]["backend"] != "gloo"):
        raise AssertionError(f"lat_lon: errors {worst}, shapes {shapes_ok}, ranks that "
                             f"launched no kernel {idle}, geometry {geo}")
    train = lat_lon_train(ranks)
    return dict(launches=launches, mean_rel=worst, train=train)


def lat_lon_train(ranks: list) -> dict:
    """The lat_lon ranks' train steps (LAT_LON_TRAIN) against the one-process steps kept on
    the host: (a) the bf16 LoRA step of the train phase's model, the loss within
    TRAIN_LOSS_TOL relative and the concatenated LoRA gradient (summed over the lat / lon
    plane) within TRAIN_GRAD_TOL relative L2; (b) the float32 small model's LoRA and K = 2
    roll-out steps of the parallel phase, within LAT_LON_SMALL_TOL. Every rank must have
    launched K1-K4 in each step, as many as one process launches in it
    (``train_bench.expected_launches``). Prints each rank's step seconds and halo bytes, and
    what the gradient checks read had rank 0 skipped the plane's sum (its own gradient)."""
    from aurora_tpu_torch.tools import multihost_sim as ms

    import argparse

    from aurora_tpu_torch.tools import train_bench

    need = ("roll3d", "window_attention", "mlp_adaln_residual", "perceiver_core")
    rows, bad = [], []
    # Each rank launches what one process launches in the same step (remat "full" for the
    # production model, none for the small one, as the parallel phase runs it).
    prod = train_bench.train_config().replace(**TWO_BLOCKS)
    small = ms.spatial_config(argparse.Namespace(depths=None, width=None, config="small"))
    expected_launches = {
        ("production", "lora"): train_bench.expected_launches(prod, lora=True),
        ("small", "lora"): train_bench.expected_launches(small, lora=True),
        ("small", "rollout"): train_bench.expected_launches(small, lora=True, K=ms.ROLLOUT_K)}
    expected_launches = {k: {n: c for n, c in v.items() if c}
                         for k, v in expected_launches.items()}
    par = KEPT.pop("parallel")
    wants = {("production", "lora"): KEPT.pop("train"),
             ("small", "lora"): dict(loss=par["lora_loss"], grads=par["lora_grads"]),
             ("small", "rollout"): dict(loss=par["rollout_loss"], grads=par["rollout_grads"])}
    for (config, step), want in wants.items():
        grids = ranks[0]["train"][config]["grids"]
        key = next(iter(grids))
        got = grids[key][step]
        per_rank = [r["train"][config]["grids"][key][step] for r in ranks]
        loss = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        w = want["grads"]
        if config == "production":
            grad = ms._rel_l2(got["grads"], w)
            fault = ms._rel_l2(got["local_grads"], w)
            tol = (TRAIN_LOSS_TOL, TRAIN_GRAD_TOL)
            measure = "rel_l2"
        else:
            grad = (ms._masked_max_rel(got["grads"], w) if step == "lora"
                    else max(ms._max_rel(got["grads"][k], w[k]) for k in w))
            fault = max(ms._max_rel(got["local_grads"][k], w[k]) for k in w)
            tol = (LAT_LON_SMALL_TOL["loss"], LAT_LON_SMALL_TOL[step])
            measure = "max_rel where |g| >= 1e-6" if step == "lora" else "max_rel"
        expected = expected_launches[config, step]
        idle = [i for i, r in enumerate(per_rank)
                if not all(r["launches"].get(k) for k in need)
                or {k: v for k, v in r["launches"].items() if v} != expected]
        row = dict(phase="lat_lon", part=f"{config} {step} step", grid=key,
                   loss=got["loss"], loss_one_process=want["loss"], loss_rel_err=loss,
                   grad_err=grad, grad_measure=measure, tol=tol,
                   skipped_plane_sum_grad_err=fault,
                   step_s_per_rank=[r["seconds"] for r in per_rank],
                   halo_bytes_sent_per_rank=[r["halo"]["bytes_sent"] for r in per_rank],
                   collectives_per_rank=[r["halo"]["collectives"] for r in per_rank],
                   by_kind_rank0=got["halo"]["by_kind"],
                   launches_per_rank=[r["launches"] for r in per_rank],
                   expected_launches=expected,
                   step_s_label="four ranks sharing one card, beside the parallel phase's ranks "
                                "and its one-process run: not a scaling figure")
        emit(row)
        rows.append(row)
        if idle or not (loss <= tol[0] and grad <= tol[1]) or not fault > 10 * tol[1]:
            bad.append(f"{config} {step}: loss {loss}, gradient {grad} (skipped sum {fault}), "
                       f"ranks whose launches differ from one process's {idle}")
    if bad:
        raise AssertionError(f"lat_lon train: {bad}")
    return dict(rows=rows)


# ------------------------------------------------------------------------------ tools


def run_tools() -> dict:
    """The probe tools as a user runs them, in process; returns the launches over them.
    ``backbone_ablate`` patches ``swin3d``'s functions while it times for its own thread's
    calls only, so the CPU references on the host thread go on beside it."""
    from aurora_tpu_torch.ops import _lib
    from aurora_tpu_torch.tools import backbone_ablate, gemm_probe, kernel_slate, smem_probe

    _lib.reset_launches()
    t0 = time.perf_counter()
    ablate = backbone_ablate.main(["--variants", ",".join(backbone_ablate.VARIANTS)])
    gemm = gemm_probe.main([])
    smem = smem_probe.main([])
    launches = dict(_lib.LAUNCHES)
    # The patch embeddings and the patch merge / split against their floors (PyTorch's
    # convolution and products: no kernel of the port, no launch).
    slate = kernel_slate.main([])
    bad = [r for r in slate if not (0 < r["ms"] < float("inf")) or r["launches"]]
    if len(slate) != 4 or bad or dict(_lib.LAUNCHES) != launches:
        raise AssertionError(f"kernel_slate: rows {slate}")
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
                           smem_probe=len(smem), kernel_slate=len(slate)), smem_probe=smem[-1],
              kernel_slate=[{k: r[k] for k in ("label", "ms", "bound_ms", "bound_by", "of_floor",
                                               "flops_counted", "bytes_counted")}
                            for r in slate]))
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
# The variant whose weights go through the port's checkpoint code (the most schema
# migrations): the full model's state dict in memory through ``convert_reference_checkpoint``,
# its reference model's from a reference-format ``.ckpt`` file. The other variants are seeded
# on the card (the converter is held bit for bit on the CPU by tests/test_torch_checkpoint.py).
VIA_FILE = "pollution"
VARIANT_STEPS = 2  # roll-out steps of each variant at its full grid
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


def load_variant(name: str, manifest: dict, cfg=None, via_file: bool = False):
    """One released variant in its facade's default config (``cfg``: another config of it,
    by default ``default_config()``: float32 all through) on the card, with its weights
    loaded through the port's checkpoint code: from a ``.ckpt`` file with ``via_file``, else
    the state dict in memory through ``convert_reference_checkpoint``. ``manifest``: the
    checkpoint's keys and shapes for that config. Returns the model and a dict of what the
    load took. :func:`production_copy` makes the production model of the same weights."""
    import tempfile
    from pathlib import Path

    import torch

    from aurora_tpu_torch.checkpoint import convert_reference_checkpoint
    from aurora_tpu_torch.convert import load_numpy_params

    cls = type_of(name)
    cfg = cfg or cls.default_config()
    t0 = time.perf_counter()
    sd = reference_weights(manifest, cfg, seed=0)
    info = dict(weights_s=time.perf_counter() - t0,
                values=sum(v.size for v in sd.values()))
    model = cls(cfg, device="cuda", seed=None)
    t0 = time.perf_counter()
    if via_file:
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
    return model, info


def production_copy(model):
    """The production model of ``model``'s weights (a float32 model of a facade): the same
    facade with the production knobs, the parameters copied on the card, the backbone
    stored in bf16 (``cast_backbone_params``), as ``tools.variant_bench`` builds it."""
    from aurora_tpu_torch import cast_backbone_params
    from aurora_tpu_torch.tools.perf_breakdown import production_config

    prod = type(model)(production_config(model.cfg), device=model.device, seed=None)
    prod.load_state_dict(model.state_dict())
    return cast_backbone_params(prod)


def expected_outputs(cfg) -> tuple[set, set]:
    """The variables a prediction of ``cfg``'s model holds after its hooks: the user's raw
    variables (the wave model's angles and densities folded back), no ``_mod`` head."""
    surf = cfg.surf_vars
    if cfg.variant == "wave":
        surf = ("2t", "10u", "10v", "msl") + cfg.density_channel_surf_vars
    return set(surf), set(cfg.atmos_vars)


# The two forms of each variant: (form, the config's name, the reference's bound, the dtype of
# every launch). The float32 form is the facade's default config (the serving registry's and
# the command-line interface's), the bf16 one the production knobs (the benchmark entry's).
VARIANT_FORMS = (("f32", "default (float32 all through)", F32_REF_TOL, "float32"),
                 ("bf16", "production knobs (bf16 backbone and (de-)aggregation values)", 1e-2,
                  "bfloat16"))


def run_variant(name: str, manifest: dict, steps: int, refs: _Deferred) -> dict:
    """One released variant in both of ``VARIANT_FORMS``, from one load of its weights: the
    float32 model (the facade's default config, ``default_config()`` asserted) through the
    checkpoint path, its production model copied from it on the card. Each form rolls out
    ``steps`` steps at the variant's full grid through the tools (counts set to 0 just
    before): launches per step checked against the code and every launch in the form's
    dtype (``_KernelCalls.by_dtype``); the outputs' variables, shapes, dtype and values. Then
    the same two forms at two blocks per backbone stage on the reference grid against the
    port's own CPU runs. Returns ``{form: launches over its roll-out}``."""
    import torch

    from aurora_tpu_torch.ops import _lib
    from aurora_tpu_torch.tools import highres_bench, variant_bench

    facade, (H, W), (h, w), expected = VARIANT_RUNS[name]
    default = type_of(name).default_config()
    if name == VIA_FILE:
        model, info = load_variant(name, manifest)
    else:  # The converter is held bit for bit on the CPU; one variant's load drives it here.
        t0 = time.perf_counter()
        model = variant_bench.build_variant(type_of(name), "cuda", production=False)
        torch.cuda.synchronize()
        info = dict(via="seeded on the card", build_s=time.perf_counter() - t0)
    cfg = model.cfg
    if cfg != default or cfg.autocast or cfg.agg_bf16 or cfg.deagg_bf16:
        raise AssertionError(f"variant {name}: not the default config (float32): {cfg}")
    surf, atmos = expected_outputs(cfg)
    Hc, Wc = H - H % cfg.patch_size, W
    want_shapes = {**{k: [1, 1, Hc, Wc] for k in surf},
                   **{k: [1, 1, len(LEVELS), Hc, Wc] for k in atmos}}
    may_nan = set(cfg.density_channel_surf_vars)
    launches = {}
    for form, config, _, dtype in VARIANT_FORMS:
        t_form = time.perf_counter()
        if form == "bf16":
            t0 = time.perf_counter()
            model = production_copy(model)
            torch.cuda.synchronize()
            info = dict(via="the float32 model's parameters copied on the card",
                        copy_s=time.perf_counter() - t0)
        _lib.reset_launches()
        with _KernelCalls() as calls:
            if name in variant_bench.VARIANTS:
                r = variant_bench.main(["--variants", name, "--steps", str(steps)],
                                       models={name: model})[0]
            elif name == "highres":
                r = highres_bench.main(["--steps", str(steps)], model=model)[0]
            else:  # The 12 h model: the base variables, through the same roll-out.
                r = variant_bench.run_rollout(
                    model, variant_bench.raw_batch(cfg, H, W, device="cuda"), steps)
        launches[form] = dict(_lib.LAUNCHES)
        by_dtype = calls.by_dtype()
        bad = [f"step {i}: launches {got} != {expected}"
               for i, got in enumerate(r["launches_per_step"]) if got != expected]
        if by_dtype != {dtype: {k: steps * n for k, n in expected.items()}}:
            bad.append(f"launches by dtype {by_dtype} (want all {dtype})")
        if r["outputs"] != want_shapes or r["dtypes"] != ["float32"]:
            bad.append(f"outputs {r['outputs']} {r['dtypes']} != {want_shapes}")
        nonfinite = {k: (r["nan_points"][k], r["inf_points"][k]) for k in want_shapes
                     if r["inf_points"][k] or (r["nan_points"][k] and k not in may_nan)}
        if nonfinite or r["rollout_step"] != steps:
            bad.append(f"non-finite outputs {nonfinite}")
        emit(dict(phase="variant", variant=name, facade=facade, form=form, config=config,
                  grid=f"{H}x{W}", patch_size=cfg.patch_size,
                  params=sum(p.numel() for p in model.parameters()),
                  param_dtypes=sorted({str(p.dtype) for p in model.parameters()}),
                  **info, steps=steps, step_s=r["step_s"], peak_mem_gib=r["peak_mem_gib"],
                  launches_per_step=r["launches_per_step"][-1], expected_per_step=expected,
                  launches_by_dtype=by_dtype, launches=launches[form],
                  nan_points={k: v for k, v in r["nan_points"].items() if v},
                  seconds=time.perf_counter() - t_form))
        if bad:
            raise AssertionError(f"variant {name}, {form}: {bad}")

    # The references: the variant's own config, widths, hooks and grid at two blocks per
    # backbone stage (one unshifted, one shifted: K1 and K2's masked attention run on the
    # variant's own token grid), seeded on the card, on the reference grid, in both forms
    # of the same weights; the card against the port's CPU run of each. VIA_FILE's weights
    # come through a reference .ckpt file of those blocks (the released checkpoint's keys
    # without blocks 2 and up).
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    shallow = cfg.replace(encoder_depths=(2,) * len(cfg.encoder_depths),
                          decoder_depths=(2,) * len(cfg.decoder_depths))
    if name == VIA_FILE:
        import re

        keep = {k: v for k, v in manifest.items()
                if not (blk := re.search(r"\.blocks\.(\d+)\.", k)) or int(blk[1]) < 2}
        model, file_info = load_variant(name, keep, shallow, via_file=True)
        emit(dict(phase="variant", variant=name, part="weights through a .ckpt file",
                  depths=(shallow.encoder_depths, shallow.decoder_depths), **file_info))
    else:
        model = variant_bench.build_variant(type_of(name), "cuda", cfg=shallow,
                                            production=False)
    small = variant_bench.raw_batch(cfg, h, w, seed=1, absolute=name != "highres")
    models = {"f32": model, "bf16": production_copy(model)}
    del model
    runs = []
    t_card = time.perf_counter()
    for form, _, tol, dtype in VARIANT_FORMS:
        model = models.pop(form)
        before = dict(_lib.LAUNCHES)
        with _KernelCalls() as calls:
            got = model(small)
            torch.cuda.synchronize()
        ref_launches = {k: n - before[k] for k, n in _lib.LAUNCHES.items() if n != before[k]}
        missing = [k for k in ("roll3d", "window_attention") if not ref_launches.get(k)]
        if missing or set(calls.by_dtype()) != {dtype}:
            raise AssertionError(f"variant {name}, {form}: the reference run launched "
                                 f"{calls.by_dtype()}, never {missing}")
        runs.append((form, tol, ref_launches, got.to("cpu"), model.to("cpu")))
        torch.cuda.empty_cache()
    del model
    emit(dict(phase="variant", variant=name, part="references' card half",
              seconds=time.perf_counter() - t0, forward_s=time.perf_counter() - t_card))

    def compare():  # on the host thread (refs)
        bad = []
        for form, tol, ref_launches, got, cpu in runs:
            want = cpu(small)
            errs, flips = {}, {}
            for k in sorted(surf | atmos):
                g = (got.surf_vars if k in surf else got.atmos_vars)[k].double()
                c = (want.surf_vars if k in surf else want.atmos_vars)[k].double()
                both = torch.isfinite(g) & torch.isfinite(c)
                errs[k] = _mean_rel(g[both], c[both])
                flips[k] = int((torch.isnan(g) != torch.isnan(c)).sum())
            worst = max(errs.values())
            flip_share = sum(flips.values()) / sum(v.numel() for v in {
                **want.surf_vars, **want.atmos_vars}.values())
            emit(dict(phase="reference", variant=name, form=form, grid=f"{h}x{w}",
                      depths=(shallow.encoder_depths, shallow.decoder_depths),
                      launches=ref_launches, against="port CPU run (plain versions)",
                      mean_rel=errs, worst=worst, tol=tol,
                      nan_mask_differs={k: v for k, v in flips.items() if v},
                      nan_flip_share=flip_share, seconds=time.perf_counter() - t0))
            if not worst <= tol:
                bad.append(f"{form}: card vs CPU: mean rel {worst} > {tol}")
            # A density point flips where the predicted density is within the card's error
            # of 1/2; no other variable may be NaN on one side only.
            if flip_share > NAN_FLIP_TOL or any(v for k, v in flips.items() if k not in may_nan):
                bad.append(f"{form}: NaN masks differ at {flips}")
        if bad:
            raise AssertionError(f"variant {name}: {bad}")

    refs.submit(f"variant {name} reference", compare)
    return launches


def run_variants(steps: int, refs: _Deferred) -> dict:
    """Every variant of ``VARIANT_RUNS`` (``run_variant``); returns ``{name: {form:
    launches}}``."""
    manifests = json.loads(open(MANIFESTS).read())
    t0 = time.perf_counter()
    out, each = {}, {}
    for name, (facade, *_rest) in VARIANT_RUNS.items():
        t = time.perf_counter()
        out[name] = run_variant(name, manifests[facade], steps, refs)
        each[name] = time.perf_counter() - t
    emit(dict(phase="variants", seconds=time.perf_counter() - t0, seconds_by_variant=each))
    return out


# ------------------------------------------------------------------------------ small model

# Launches per forward step of AuroraSmallPretrained, from the code: stage depths (2, 6, 2) +
# (2, 6, 2), 20 blocks, the odd-index half shifted (K1 twice each); K2 and K3 once a block;
# K3 in the two perceiver MLP halves; K4 in the aggregation and the de-aggregation. On route
# X K5 takes K2's place.
SMALL_RUN = {"roll3d": 20, "window_attention": 20, "mlp_adaln_residual": 22, "perceiver_core": 2}
SMALL_X_RUN = {"roll3d": 20, "linear_adaln_residual": 20, "mlp_adaln_residual": 22,
               "perceiver_core": 2}
SMALL_GRID, SMALL_REF_GRID = (721, 1440), (121, 240)
SMALL_STEPS = 2  # roll-out steps on the main route; route X takes one
ROUTE_KERNELS = ("roll3d", "window_attention", "mlp_adaln_residual", "perceiver_core",
                 "linear_adaln_residual", "window_attention_windowed", "sdpa_windows",
                 "mlp_fused")


class _KernelCalls:
    """The launches of K1-K8 (``ops._lib.LAUNCHES_BY``: by kernel, output dtype and output
    width) made while it is entered, a served task's from the server's worker thread too.
    It reads the wrappers' own counts, which a CPU run (a reference on the host thread)
    never moves, and patches nothing."""

    def __enter__(self):
        from aurora_tpu_torch.ops import _lib

        self._by, self._before = _lib.LAUNCHES_BY, dict(_lib.LAUNCHES_BY)
        return self

    def __exit__(self, *exc):
        self._by = dict(self._by)

    @property
    def calls(self) -> dict:
        """``{(kernel, dtype, width): launches}`` since entered (until left)."""
        return {at: n - self._before.get(at, 0) for at, n in self._by.items()
                if at[0] in ROUTE_KERNELS and n != self._before.get(at, 0)}

    def by_dtype(self) -> dict:
        """``{dtype: {kernel: launches}}``."""
        out: dict = {}
        for (k, dt, _), n in self.calls.items():
            out.setdefault(dt, {})
            out[dt][k] = out[dt].get(k, 0) + n
        return out

    def at_width(self, width: int) -> dict:
        """``{kernel: launches}`` of K2-K8 with ``width``-wide output rows."""
        out: dict = {}
        for (k, _, w), n in self.calls.items():
            if w == width and k != "roll3d":
                out[k] = out.get(k, 0) + n
        return out


SMALL_FORMS = {  # form: (config, reference bound, dtype of every launch)
    "f32": ("default (float32 all through)", 1e-4, "float32"),
    "bf16": ("production knobs (bf16 backbone and (de-)aggregation values)", 1e-2, "bfloat16"),
}
# The small model's routes: (knobs, roll-out steps, launches a step, those at D = 256).
SMALL_ROUTES = {
    "main": (ROUTES["main"][0], SMALL_STEPS, SMALL_RUN, SMALL_D256),
    "X": (ROUTES["X"][0], 1, SMALL_X_RUN, SMALL_X_D256),
}


def run_small(refs: _Deferred) -> dict:
    """``AuroraSmallPretrained`` (D = 256) on the card in each of ``SMALL_FORMS``: in its
    default config (``AuroraSmallPretrained()``, float32 all through) and with the production
    knobs (``tools.variant_bench.build_variant``: bf16 backbone stored in bf16, bf16 (de-)
    aggregation values); seeded weights, gates opened. Each form on each of ``SMALL_ROUTES``
    (the main route, then route X on the same weights by ``set_knobs``): a roll-out at
    721 x 1440 through ``tools.variant_bench.run_rollout`` (counts set to 0 just before):
    step times, peak memory, launches per step against the route's counts, every launch in
    the form's dtype and those at D = 256 against the route's; outputs finite at their
    shapes. Then the same model (full depth) on the 121 x 240 grid on each route, against the
    port's CPU run of it: mean relative error per output variable within the form's bound
    (its CPU half on the host thread). Returns ``{form: {route: launches of its roll-out}}``."""
    return {form: _run_small_form(form, refs) for form in SMALL_FORMS}


def _run_small_form(form: str, refs: _Deferred) -> dict:
    import torch

    from aurora_tpu_torch import AuroraSmallPretrained
    from aurora_tpu_torch.ops import _lib
    from aurora_tpu_torch.tools import variant_bench
    from aurora_tpu_torch.tools.perf_breakdown import open_gates

    config, tol, dtype = SMALL_FORMS[form]
    t0 = time.perf_counter()
    if form == "f32":
        model = AuroraSmallPretrained(device="cuda", seed=0)
        open_gates(model)
    else:
        model = variant_bench.build_variant(AuroraSmallPretrained, "cuda")
    cfg = model.cfg
    if form == "f32":
        if cfg.autocast or cfg.agg_bf16 or cfg.deagg_bf16:
            raise AssertionError(f"small model: default config not float32 all through: {cfg}")
        if {p.dtype for p in model.parameters()} != {torch.float32}:
            raise AssertionError("small model: weights not all float32")
    model_name = "AuroraSmallPretrained()" if form == "f32" else "AuroraSmallPretrained"
    H, W = SMALL_GRID
    batch = variant_bench.raw_batch(cfg, H, W, device="cuda")
    launches = {}
    for route, (knobs, steps, run, d256_run) in SMALL_ROUTES.items():
        t1 = time.perf_counter()
        model.set_knobs(**knobs)
        _lib.reset_launches()
        with _KernelCalls() as calls:
            r = variant_bench.run_rollout(model, batch, steps)
        launches[route] = dict(_lib.LAUNCHES)
        d256 = {k: n // steps for k, n in calls.at_width(256).items()}
        by_dtype = calls.by_dtype()
        bad = []
        if any(got != run for got in r["launches_per_step"]):
            bad.append(f"launches {r['launches_per_step']} (want {run} a step)")
        if d256 != d256_run or any(n % steps for n in calls.at_width(256).values()):
            bad.append(f"at D = 256 {calls.at_width(256)} over {steps} steps (want {d256_run} "
                       "a step)")
        if by_dtype != {dtype: {k: steps * n for k, n in run.items()}}:
            bad.append(f"launches by dtype {by_dtype} (want all {dtype})")
        Hc = H - H % cfg.patch_size
        want_shapes = {**{k: [1, 1, Hc, W] for k in cfg.surf_vars},
                       **{k: [1, 1, len(LEVELS), Hc, W] for k in cfg.atmos_vars}}
        if (r["outputs"] != want_shapes or any(r["nan_points"].values())
                or any(r["inf_points"].values()) or r["rollout_step"] != steps):
            bad.append(f"outputs {r['outputs']}, NaN {r['nan_points']}, inf {r['inf_points']}")
        emit(dict(phase="small", form=form, route=route, **knobs, model=model_name,
                  config=config, grid=f"{H}x{W}", embed_dim=cfg.embed_dim,
                  depths=(cfg.encoder_depths, cfg.decoder_depths),
                  heads=(cfg.encoder_num_heads, cfg.decoder_num_heads),
                  params=sum(p.numel() for p in model.parameters()), steps=steps,
                  step_s=r["step_s"], peak_mem_gib=r["peak_mem_gib"],
                  launches_per_step=r["launches_per_step"][-1], expected_per_step=run,
                  d256_per_step=d256, expected_d256_per_step=d256_run, launches_by_dtype=by_dtype,
                  launches=launches[route], seconds=time.perf_counter() - t1))
        if bad:
            raise AssertionError(f"small model, {form}, route {route}: {bad}")
    del batch

    # The reference: the same model, full depth, on the 121 x 240 grid on each route against
    # the port's CPU run of the same weights (its CPU half on the host thread).
    t1 = time.perf_counter()
    h, w = SMALL_REF_GRID
    small = variant_bench.raw_batch(cfg, h, w, seed=1)
    rows = []
    for route, (knobs, _, run, _) in SMALL_ROUTES.items():
        before = dict(_lib.LAUNCHES)
        got = model.set_knobs(**knobs)(small)
        torch.cuda.synchronize()
        ref_launches = {k: n - before[k] for k, n in _lib.LAUNCHES.items() if n != before[k]}
        if ref_launches != run:
            raise AssertionError(f"small model, {form}, route {route}: the reference run "
                                 f"launched {ref_launches}")
        rows.append((knobs, dict(phase="reference", model=model_name, form=form, route=route,
                                 config=config, grid=f"{h}x{w}",
                                 depths=(cfg.encoder_depths, cfg.decoder_depths),
                                 launches=ref_launches, got=got)))
    model.set_knobs(**rows[0][0])
    defer_reference(refs, f"small model reference ({form})", model, small, cfg, t1, rows[0][1],
                    tol, more=rows[1:])
    emit(dict(phase="small", form=form, seconds=time.perf_counter() - t0))
    return launches


# ------------------------------------------------------------------------------ float32 model

F32_STEPS = 2  # roll-out steps of the float32 model at 721 x 1440
F32_ROUTE_STEPS = 1  # roll-out steps of the float32 routes W, P, X and S at two blocks a stage
F32_PRETRAINED_STEPS = 1  # roll-out steps of AuroraPretrained() at 721 x 1440
F32_DIR = "build/f32"  # the float32 phase's files, under the checkout, removed at its end
# The float32 routes beside the main one, each on its own kernels. W, P and X are one model
# whose route knobs are switched; S changes the parameters (ln_k in the level aggregation)
# and is its own model.
F32_ROUTES = ("W", "P", "X", "S")
# The roll-out steps of each float32 home roll-out (``HOME_F32``).
F32_HOME_STEPS = {"f32": F32_STEPS, **{f"f32{r}": F32_ROUTE_STEPS for r in F32_ROUTES},
                  "f32wave": VARIANT_STEPS}


def f32_rollout(model, batch, steps: int, expected: dict, what: str, keep: bool = False):
    """``rollout`` of the float32 model ``model`` over ``batch`` for ``steps`` steps (counts
    set to 0 just before): step times, peak memory, launches per step against ``expected``
    and every launch writing float32 (``_KernelCalls.by_dtype``), the parameters float32, the
    outputs float32, finite and of the 720 x 1440 shapes. Returns the line's fields (with
    ``preds``, the predictions' host copies, when ``keep``); raises after emitting nothing
    if a check fails."""
    import torch

    from aurora_tpu_torch import rollout
    from aurora_tpu_torch.ops import _lib

    param_dtypes = sorted({str(p.dtype) for p in model.parameters()})
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    step_s, per_step, dtype_per_step, preds = [], [], [], []
    with _KernelCalls() as calls:
        t_prev = time.perf_counter()
        before, seen = dict(_lib.LAUNCHES), {}
        for pred in rollout(model, batch, steps=steps):
            torch.cuda.synchronize()
            now = time.perf_counter()
            step_s.append(now - t_prev)
            per_step.append({k: _lib.LAUNCHES[k] - before[k] for k in _lib.LAUNCHES})
            now_by = calls.by_dtype()
            dtype_per_step.append({f"{k}/{dt}": n - seen.get(dt, {}).get(k, 0)
                                   for dt, ks in now_by.items() for k, n in ks.items()})
            before, seen = dict(_lib.LAUNCHES), now_by
            if keep:
                preds.append(pred.to_numpy())
            last = pred
            t_prev = time.perf_counter()
    launches = dict(_lib.LAUNCHES)
    by_dtype = calls.by_dtype()
    want = {k: n for k, n in expected.items() if n}
    bad = [f"step {i}: launches {got}" for i, got in enumerate(per_step)
           if {k: n for k, n in got.items() if n} != want]
    if by_dtype != {"float32": {k: steps * n for k, n in want.items()}}:
        bad.append(f"launches by dtype {by_dtype} (want float32 {want} a step)")
    if param_dtypes != ["torch.float32"]:
        bad.append(f"parameters {param_dtypes}")
    for k, v in {**last.surf_vars, **last.atmos_vars}.items():
        shape = (1, 1, 720, 1440) if k in last.surf_vars else (1, 1, len(LEVELS), 720, 1440)
        if tuple(v.shape) != shape or v.dtype != torch.float32 or not torch.isfinite(v).all():
            bad.append(f"{k}: {tuple(v.shape)} {v.dtype} finite {bool(torch.isfinite(v).all())}")
    if last.metadata.rollout_step != steps:
        bad.append("roll-out step not advanced")
    if bad:
        raise AssertionError(f"{what}: {bad}")
    return dict(grid="721x1440 (720x1440 after crop)", levels=13,
                params=sum(p.numel() for p in model.parameters()), param_dtypes=param_dtypes,
                steps=steps, step_s=step_s, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                launches_per_step=per_step[-1], launches=launches, launches_by_dtype=by_dtype,
                launches_by_dtype_per_step=dtype_per_step, **({"preds": preds} if keep else {}))


def run_f32(batch, refs: _Deferred) -> dict:
    """``Aurora`` in its default config (``LARGE_CONFIG`` with LoRA, float32 all through, as
    the JAX package's CLI and registry build it) on the card: seeded weights, FiLM and LoRA
    gates opened as the routes' models; ``f32_rollout`` of F32_STEPS steps over the
    721 x 1440 batch, launches per step the main route's. Then the serving phase on this
    model (``run_serving``: the registry builds the same default config; the served
    predictions must be this roll-out's bits, float32 launches only). Then the same config at
    two blocks a backbone stage (the second shifted), one model on each of the routes W, P
    and X in turn and a model of its own on route S (``run_f32_route``: a roll-out over the
    same batch, every launch float32), then on 121 x 240 on the main route, on each of W, P
    and X and on S against the port's CPU run: mean relative error <= F32_REF_TOL per output
    variable (its CPU half queued on ``refs``). Then ``AuroraPretrained()`` in its default
    config (``run_f32_pretrained``). ``batch``: the routes' 721 x 1440 host batch. Returns
    the launches of each roll-out: ``{"f32": the full-depth model's, "f32W": route W's, ...,
    "f32S": route S's, "f32pretrained": AuroraPretrained()'s}``."""
    import shutil

    import torch

    from aurora_tpu_torch import Aurora
    from aurora_tpu_torch.ops import _lib
    from aurora_tpu_torch.tools.perf_breakdown import build_model, numpy_batch

    t_phase = time.perf_counter()
    cfg = Aurora.default_config()
    if cfg.autocast or cfg.agg_bf16 or cfg.deagg_bf16:
        raise AssertionError(f"Aurora's default config is not float32 all through: {cfg}")
    expected = {k: ROUTES["main"][1].get(k, 0) for k in _lib.LAUNCHES}
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    line = f32_rollout(model, batch, F32_STEPS, expected, "float32 model", keep=True)
    preds = line.pop("preds")
    launches = line["launches"]
    emit(dict(phase="f32", model="Aurora()", config="default (float32 all through)",
              init_s=init_s, **line, seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()

    work = os.path.abspath(F32_DIR)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        ic = os.path.join(work, "ic.nc")
        batch.to_netcdf(ic)
        with _KernelCalls() as served:
            run_serving(model, batch, preds, ic, work)
        want_served = {"float32": {k: SERVE_STEPS * n for k, n in ROUTES["main"][1].items()}}
        if served.by_dtype() != want_served:
            raise AssertionError(f"serving: launches by dtype {served.by_dtype()} != "
                                 f"{want_served}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del model, preds
    torch.cuda.empty_cache()
    emit(dict(phase="f32", part="serving (the artifact, the server, one served step)",
              seconds=time.perf_counter() - t0))

    # The routes: the default config at two blocks per backbone stage (the second shifted, so
    # K1 and the masked attention run), seeded on the card: one model whose route knobs are
    # switched (``set_knobs``: the weights are one tree) for W, P and X, and route S's own
    # (``stabilise_level_agg`` adds ln_k's parameters). Each rolls out over the 721 x 1440
    # batch; then each route, main first, on 121 x 240 against the port's CPU run.
    cfg2 = cfg.replace(**TWO_BLOCKS)
    blocks = sum(cfg2.encoder_depths) + sum(cfg2.decoder_depths)
    models = {"main": build_model(cfg2, "cuda")}
    models["S"] = build_model(cfg2.replace(**ROUTES["S"][0]), "cuda")
    out = {"f32": launches}
    for route in F32_ROUTES:
        out[f"f32{route}"] = run_f32_route(models.get(route, models["main"]), route, batch,
                                           blocks)
    t0 = time.perf_counter()
    small = numpy_batch(cfg, 121, 240, seed=1)
    rows = {"main": [], "S": []}
    for route in ("main", *F32_ROUTES):
        knobs, counts = ROUTES[route]
        own = "S" if route == "S" else "main"
        runtime = {k: v for k, v in knobs.items() if k in Aurora.RUNTIME_KNOBS}
        before = dict(_lib.LAUNCHES)
        with _KernelCalls() as calls:
            got = models[own].set_knobs(**runtime)(small)
            torch.cuda.synchronize()
        ref_launches = {k: n - before[k] for k, n in _lib.LAUNCHES.items() if n != before[k]}
        missing = [k for k in counts if not ref_launches.get(k)]
        if missing or set(calls.by_dtype()) != {"float32"}:
            raise AssertionError(f"float32 route {route}: the reference run launched "
                                 f"{calls.by_dtype()}, never {missing}")
        rows[own].append((runtime, dict(phase="reference", model="Aurora() float32",
                                        route=route, **knobs, grid="121x240",
                                        depths=(cfg2.encoder_depths, cfg2.decoder_depths),
                                        launches=ref_launches, got=got)))
    for own, what in (("main", "float32 model reference"), ("S", "float32 route S reference")):
        first, *more = rows[own]
        models[own].set_knobs(**first[0])
        defer_reference(refs, what, models.pop(own), small, cfg2, t0, first[1], F32_REF_TOL,
                        more=more)
    emit(dict(phase="f32", part="references' card half (routes main, W, P, X, S)",
              seconds=time.perf_counter() - t0))
    out["f32pretrained"] = run_f32_pretrained(batch, refs)
    emit(dict(phase="f32", seconds=time.perf_counter() - t_phase))
    return out


def run_f32_pretrained(batch, refs: _Deferred) -> dict:
    """``AuroraPretrained()`` (``LARGE_CONFIG``: float32 all through, no LoRA; its
    ``default_config()`` asserted) on the card, seeded, FiLM gates opened: ``f32_rollout`` of
    F32_PRETRAINED_STEPS steps at full depth over the 721 x 1440 batch, launches per step the
    main route's; then its config at two blocks a backbone stage on 121 x 240 against the
    port's CPU run, mean relative error <= F32_REF_TOL per variable (CPU half on ``refs``).
    Returns the roll-out's launches."""
    import torch

    from aurora_tpu_torch import AuroraPretrained
    from aurora_tpu_torch.ops import _lib
    from aurora_tpu_torch.tools.perf_breakdown import numpy_batch, open_gates

    cfg = AuroraPretrained.default_config()
    if cfg.autocast or cfg.agg_bf16 or cfg.deagg_bf16 or cfg.use_lora:
        raise AssertionError(f"AuroraPretrained's default config: {cfg}")
    expected = {k: ROUTES["main"][1].get(k, 0) for k in _lib.LAUNCHES}
    t0 = time.perf_counter()
    model = AuroraPretrained(device="cuda", seed=0)
    open_gates(model)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if model.cfg != cfg:
        raise AssertionError(f"AuroraPretrained(): {model.cfg} != {cfg}")
    line = f32_rollout(model, batch, F32_PRETRAINED_STEPS, expected, "AuroraPretrained()")
    emit(dict(phase="f32", model="AuroraPretrained()", config="default (float32 all through)",
              init_s=init_s, **line, seconds=time.perf_counter() - t0))
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg2 = cfg.replace(**TWO_BLOCKS)
    model = AuroraPretrained(cfg2, device="cuda", seed=0)
    open_gates(model)
    small = numpy_batch(cfg, 121, 240, seed=1)
    before = dict(_lib.LAUNCHES)
    with _KernelCalls() as calls:
        got = model(small)
        torch.cuda.synchronize()
    ref_launches = {k: n - before[k] for k, n in _lib.LAUNCHES.items() if n != before[k]}
    missing = [k for k in ROUTES["main"][1] if not ref_launches.get(k)]
    if missing or set(calls.by_dtype()) != {"float32"}:
        raise AssertionError(f"AuroraPretrained(): the reference run launched "
                             f"{calls.by_dtype()}, never {missing}")
    row = dict(phase="reference", model="AuroraPretrained() float32", route="main",
               grid="121x240", depths=(cfg2.encoder_depths, cfg2.decoder_depths),
               launches=ref_launches, got=got)
    defer_reference(refs, "AuroraPretrained() reference", model, small, cfg2, t0, row,
                    F32_REF_TOL)
    return line["launches"]


def run_f32_route(model, route: str, batch, blocks: int) -> dict:
    """The float32 model ``model`` (the default config at ``blocks`` Swin blocks, with the
    route's parameter knobs: route S's ``stabilise_level_agg``) on route ``route`` (its
    runtime knobs by ``set_knobs``): ``f32_rollout`` of F32_ROUTE_STEPS steps over the
    721 x 1440 batch, launches per step against ``route_launches`` of the route's counts.
    Returns the roll-out's launches."""
    from aurora_tpu_torch import Aurora
    from aurora_tpu_torch.ops import _lib

    t0 = time.perf_counter()
    knobs, counts = ROUTES[route]
    model.set_knobs(**{k: v for k, v in knobs.items() if k in Aurora.RUNTIME_KNOBS})
    fixed = {k: v for k, v in knobs.items() if k not in Aurora.RUNTIME_KNOBS}
    if model.cfg.replace(**fixed) != model.cfg:
        raise AssertionError(f"float32 route {route}: the model is not built with {fixed}")
    expected = {k: route_launches(counts, blocks).get(k, 0) for k in _lib.LAUNCHES}
    line = f32_rollout(model, batch, F32_ROUTE_STEPS, expected, f"float32 route {route}")
    emit(dict(phase="f32_route", route=route, **knobs, model="Aurora() float32",
              depths=(model.cfg.encoder_depths, model.cfg.decoder_depths), **line,
              seconds=time.perf_counter() - t0))
    return line["launches"]


# ------------------------------------------------------------------------------ deep resamplers

DEEP = dict(enc_depth=2, dec_depth=2)  # the deep_resampler phase's resampler depths
DEEP_STEPS = 1  # its roll-out steps at 721 x 1440, in each form
# form: (config's name, reference bound (mean relative error per output variable)).
DEEP_FORMS = {"bf16": ("production knobs (bf16 backbone and (de-)aggregation values)", 1e-2),
              "f32": ("default (float32 all through)", F32_REF_TOL)}


def deeper_layer_ms(model) -> dict:
    """Layer 1 of the aggregation and of the de-aggregation alone (``perceiver_layer_apply``:
    the per-column attention in plain float32 products, then K3 in float32, as in either form)
    at the 720 x 1440 grid's 64800 columns, on random float32 latents and an M-major context:
    CUDA-event medians of 2 runs after a warm-up run, TF32 off."""
    import torch

    from aurora_tpu_torch.model.nn import full_f32_products
    from aurora_tpu_torch.model.perceiver import perceiver_layer_apply

    cfg, M = model.cfg, 180 * 360
    g = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for name, p, Q, K in (("encoder", model.encoder.level_agg, cfg.latent_levels - 1,
                           len(LEVELS)),
                          ("decoder", model.decoder.level_decoder, len(LEVELS),
                           cfg.latent_levels - 1)):
        D = p.layers[1].ln1.weight.shape[0]
        lat = torch.randn(M, Q, D, generator=g, device="cuda")
        ctx = torch.randn(K, M, D, generator=g, device="cuda").transpose(0, 1)
        with torch.no_grad(), full_f32_products():
            out[name] = cuda_ms(lambda: perceiver_layer_apply(
                p.layers[1], lat, ctx, p.num_heads, cfg.perceiver_ln_eps), reps=2, warmup=1)
        del lat, ctx
    torch.cuda.empty_cache()
    return out


def run_deep_resampler(batch, refs: _Deferred) -> dict:
    """The 1.3 B model (D = 512) with resamplers of depth 2 (``DEEP``), at two blocks a
    backbone stage, in each of ``DEEP_FORMS``: with the production knobs and in ``Aurora``'s
    default config (float32 all through); seeded weights, gates opened. Each form rolls out
    ``DEEP_STEPS`` step over the 721 x 1440 ``batch`` (counts set to 0 just before): the
    launches a step must be the main route's at 12 blocks with the resamplers' from
    ``tools.train_bench.resampler_launches`` (K3 two more a step than at depth 1, K4 as
    many), and under the production knobs the deeper layers' two K3 launches float32 (their
    latents are float32), every other K3 bf16; the outputs finite, float32, of the grid's
    shapes; peak memory; with the production knobs also the deeper layers alone
    (``deeper_layer_ms``). Then the same model on 121 x 240 against the port's CPU run (its
    CPU half queued on ``refs``). Returns each form's launches."""
    import torch

    from aurora_tpu_torch import Aurora, rollout
    from aurora_tpu_torch.ops import _lib
    from aurora_tpu_torch.tools.perf_breakdown import build_model, numpy_batch, production_config

    t_phase = time.perf_counter()
    small = numpy_batch(production_config(), 121, 240, seed=1)
    out = {}
    for form, (config, tol) in DEEP_FORMS.items():
        t_form = time.perf_counter()
        base = production_config() if form == "bf16" else Aurora.default_config()
        cfg = base.replace(**TWO_BLOCKS, **DEEP)
        blocks = sum(cfg.encoder_depths) + sum(cfg.decoder_depths)
        counts = ROUTES["main"][1]
        expected = {k: route_launches(counts, blocks, cfg).get(k, 0) for k in _lib.LAUNCHES}
        at_depth1 = route_launches(counts, blocks)
        if (expected["mlp_adaln_residual"] - at_depth1["mlp_adaln_residual"] != 2
                or expected["perceiver_core"] != at_depth1["perceiver_core"]):
            raise AssertionError(f"deep_resampler: derived launches {expected} vs depth 1 "
                                 f"{at_depth1}")
        t0 = time.perf_counter()
        model = build_model(cfg, "cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        if form == "f32":
            line = f32_rollout(model, batch, DEEP_STEPS, expected, "deep_resampler float32")
        else:
            torch.cuda.reset_peak_memory_stats()
            _lib.reset_launches()
            step_s, per_step = [], []
            with _KernelCalls() as calls:
                t_prev = time.perf_counter()
                before = dict(_lib.LAUNCHES)
                for pred in rollout(model, batch, steps=DEEP_STEPS):
                    torch.cuda.synchronize()
                    step_s.append(time.perf_counter() - t_prev)
                    per_step.append({k: _lib.LAUNCHES[k] - before[k] for k in _lib.LAUNCHES})
                    before, last = dict(_lib.LAUNCHES), pred
                    t_prev = time.perf_counter()
            by_dtype = calls.by_dtype()
            bad = [f"step {i}: launches {n}" for i, n in enumerate(per_step) if n != expected]
            f32_k3 = by_dtype.get("float32", {})
            if f32_k3 != {"mlp_adaln_residual": 2 * DEEP_STEPS}:
                bad.append(f"float32 launches {f32_k3}: the deeper layers' K3 only")
            for k, v in {**last.surf_vars, **last.atmos_vars}.items():
                shape = (1, 1, 720, 1440) if k in last.surf_vars else (1, 1, len(LEVELS), 720,
                                                                       1440)
                if (tuple(v.shape) != shape or v.dtype != torch.float32
                        or not torch.isfinite(v).all()):
                    bad.append(f"{k}: {tuple(v.shape)} {v.dtype}")
            if bad:
                raise AssertionError(f"deep_resampler bf16: {bad}")
            line = dict(grid="721x1440 (720x1440 after crop)", levels=13,
                        params=sum(p.numel() for p in model.parameters()), steps=DEEP_STEPS,
                        step_s=step_s,
                        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                        launches_per_step=per_step[-1], launches=dict(_lib.LAUNCHES),
                        launches_by_dtype=by_dtype)
            del last
        out[form] = line["launches"]
        if form == "bf16":  # the deeper layers are float32 in both forms: timed once
            line["deeper_layer_ms"] = deeper_layer_ms(model)
        emit(dict(phase="deep_resampler", form=form, config=config, width=cfg.embed_dim,
                  enc_depth=cfg.enc_depth, dec_depth=cfg.dec_depth,
                  depths=(cfg.encoder_depths, cfg.decoder_depths), init_s=init_s,
                  expected_launches_per_step={k: n for k, n in expected.items() if n},
                  launches_per_step_at_depth_1={k: n for k, n in at_depth1.items() if n},
                  **line, seconds=time.perf_counter() - t_form))
        # The same model on 121 x 240 against the port's CPU run.
        t0 = time.perf_counter()
        got = model(small)
        torch.cuda.synchronize()
        row = dict(phase="reference", model="deep_resampler", form=form, config=config,
                   grid="121x240", enc_depth=cfg.enc_depth, dec_depth=cfg.dec_depth,
                   depths=(cfg.encoder_depths, cfg.decoder_depths), got=got)
        defer_reference(refs, f"deep_resampler {form} reference", model, small, cfg, t0, row,
                        tol)
        del model
        torch.cuda.empty_cache()
    emit(dict(phase="deep_resampler", seconds=time.perf_counter() - t_phase))
    return out


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
    t_build = time.perf_counter()

    # The decoder breakdown's ablated builds of K4 compile beside the kernels (the
    # breakdown then finds them built).
    from aurora_tpu_torch.tools.decoder_breakdown import K4_PARTS
    from aurora_tpu_torch.tools.kernel_ablate import build_variants

    failed = []

    def ahead():
        try:
            build_variants("resampler", K4_PARTS)
            # The drivers phase's native regrid library (g++), built here off its path.
            from aurora_tpu_torch import native

            if not native.available():
                raise RuntimeError("the native regrid library did not build")
        except Exception as e:  # raised again below, on the main thread
            failed.append(e)

    # Beside the build: the parallel phase's ranks start, held until that phase (nothing of
    # theirs touches the card before), and this process's optimiser makes its host side ready
    # (its first step imports torch's compiler stack, ~10 s of host time).
    from aurora_tpu_torch.tools import multihost_sim

    parallel = start_parallel()
    ablated = threading.Thread(target=ahead)
    ablated.start()
    ready = threading.Thread(target=multihost_sim.ready_host)
    ready.start()
    _lib.build(force=True)
    ablated.join()
    ready.join()
    if failed:
        raise failed[0]
    secs = time.perf_counter() - t_build
    ptxas = {}
    for n in _lib.SOURCES:
        lines = (_lib.BUILD_DIR / f"lib{n}.ptxas.txt").read_text().splitlines()
        ptxas[n] = [ln.strip() for ln in lines if "registers" in ln or "spill" in ln]
    emit(dict(phase="build", seconds=secs, ptxas=ptxas))
    # The lat_lon phase's ranks start once the build is done (their imports and host batches
    # beside nvcc lengthened it by ~5 s), held until that phase.
    lat_lon = start_lat_lon()

    seconds = {"build": secs}
    mark = time.perf_counter()

    def lap(phase: str) -> None:
        nonlocal mark
        now = time.perf_counter()
        seconds[phase] = now - mark
        mark = now

    # TF32 off for the whole run (the plain versions' and the model's settings; see _Deferred).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    summary = run_kernel_phases()
    lap("kernels")
    # The CPU halves of the references run on one host thread, each beside the card's next
    # phases; the train phase first, so that its references' CPU half (the longest) runs
    # while the card trains. No reference may run beside the kernel phase, whose TF32
    # controls switch TF32 on (see _Deferred).
    refs = _Deferred()
    train = run_train_phases(refs)
    lap("train")
    # The phases that queue most of the references' CPU halves come first (the variants in
    # both forms, the float32 models, the small model, routes W, P, X and S); the main
    # route's long phases and the tools, which queue one reference, come last, so that the
    # host thread's queue drains beside them.
    launches = {"variants": run_variants(VARIANT_STEPS, refs)}
    launches["f32wave"] = launches["variants"]["wave"]["f32"]
    lap("variants")
    # The routes' and the float32 phase's 721 x 1440 host batch is made once (143 M seeded
    # values, ~1.5 s of host time).
    from aurora_tpu_torch.tools.perf_breakdown import numpy_batch, production_config

    batch = numpy_batch(production_config(), 721, 1440)
    launches.update(run_f32(batch, refs))
    lap("f32")
    launches["deep"] = run_deep_resampler(batch, refs)
    lap("deep_resampler")
    launches["small"] = run_small(refs)
    lap("small")
    for route in (*(r for r in ROUTES if r != "main"), "main"):
        launches[route] = run_route(route, STEPS, (121, 240), batch, refs,
                                    then=run_main_phases if route == "main" else None)
        missing = [k for k, n in ROUTES[route][1].items() if launches[route][k] == 0]
        if missing:
            raise AssertionError(f"route {route}: kernels never launched: {missing}")
        lap(f"route {route}")
    del batch
    launches["tools"] = run_tools()
    lap("tools")
    # The lat_lon ranks go with the parallel phase's: both hold only their checks, and the
    # two phases overlap on the card.
    released = release_lat_lon(lat_lon)
    run_parallel(parallel)
    lap("parallel")
    run_lat_lon(lat_lon, released)
    lap("lat_lon")
    # The CPU halves of the references, queued on the host thread since the train phase.
    waited = refs.close()
    lap("references (waiting for the host thread)")
    emit(dict(phase="references", waited_s=waited))
    emit(dict(phase="seconds", **seconds, total=sum(seconds.values()),
              since_start=time.perf_counter() - T_START))

    def entry(s: dict, n_launches: int) -> dict:
        more = {k: s[k] for k in ("bound_of_tpu_work_ms", "empty_kernel_ms", "byte_bound_ms",
                                  "ffma_bound_ms", "tf32x3_bound_ms") if k in s}
        return dict(launches=n_launches, max_abs_err=s["max_abs_err"], err=s["err"],
                    ms=s["ms"], plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
                    bound_by=max(s["by"], key=s["by"].get), library_ms=s["library_ms"], **more)

    cut = sum(TWO_BLOCKS["encoder_depths"]) + sum(TWO_BLOCKS["decoder_depths"])
    route_blocks = {r: 48 if r == "main" else cut for r in ROUTES}
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
        if home in ROUTES:
            # ``ms`` weights each shape by its launches a step at the 1.3 B model's 48 blocks
            # (``ms_launches_per_step``); ``launches_per_step`` is what the home route's
            # roll-out launched a step, at its own depth (routes W, P, X and S: 2 blocks a
            # stage, 12 blocks).
            e.update(route_blocks=route_blocks[home],
                     launches_per_step=launches[home][name] // STEPS,
                     ms_launches_per_step=summary[name, main_mode]["per_step"])
        if (name, "no tail") in summary:
            # K2 without the tail runs on route P; K6 without it on no route driven here.
            n = launches["P"][name] if name == "window_attention" else 0
            e["no_tail"] = entry(summary[name, "no tail"], n)
        if (name, "ln_k") in summary:
            # K4 with ln_k is route S's aggregation: one of its two K4 launches a step.
            e["ln_k"] = entry(summary[name, "ln_k"], launches["S"][name] // 2)
        for mode in ("bias", "ln_k, bias"):  # K4's bias inputs: no config creates them
            if (name, mode) in summary:
                e[mode] = entry(summary[name, mode], 0)
        # The small model's D = 256 shapes: times per step of the small model (its launches at
        # D = 256, SMALL_D256 / SMALL_X_D256), launches the count over that model's roll-out on
        # the route that runs the kernel (all widths; modes it does not run: 0); in bf16 (the
        # production knobs) under "d256", in float32 under "f32" "d256".
        small_route = "X" if name == "linear_adaln_residual" else "main"
        d256_per_step = SMALL_ROUTES[small_route][3].get(name, 0)
        for mode in (None, "tail", "no tail", "ln_k"):
            runs = mode in (None, "tail") and d256_per_step > 0
            for group, form in (("d256", "bf16"), ("f32d256", "f32")):
                if (group, name, mode) not in summary:
                    continue
                s = summary[group, name, mode]
                n = launches["small"][form][small_route].get(name, 0) if runs else 0
                at = e.setdefault("f32", {}) if form == "f32" else e
                at.setdefault("d256", {})[mode or "-"] = dict(
                    entry(s, n), shapes=s["shapes"],
                    d256_launches_per_small_step=d256_per_step if runs else 0)
        # The float32 forms (K1-K8): times per step of the float32 model at 48 blocks on the
        # route that runs the form (HOME_F32), launches the count over that route's float32
        # roll-out (the main route's at full depth, W's, P's and X's at two blocks a stage;
        # forms no float32 route runs: 0).
        for mode in (None, "tail", "no tail", "ln_k", "bias", "ln_k, bias"):
            if ("f32", name, mode) in summary:
                home_f32 = HOME_F32.get((name, mode))
                n = launches[home_f32][name] if home_f32 else 0
                if mode == "ln_k":  # the wave model's aggregation: one of its two K4 a step
                    n //= 2
                s = summary["f32", name, mode]
                e.setdefault("f32", {})[mode or "-"] = dict(
                    entry(s, n), shapes=s["shapes"], home_route=home_f32,
                    source=SOURCES_F32[name],
                    launches_per_step=n // F32_HOME_STEPS[home_f32] if home_f32 else 0)
        # The float32 backward (K1-K8): the worst gradient error against the plain math in
        # float64, and the backward's and plain autograd's ms at the main path's shape, on
        # the mode the train step runs.
        if name in train["grads_f32"]:
            f32 = e["f32"]
            f32["tail" if "tail" in f32 else "-"].update(train["grads_f32"][name])
        kernels.append(e)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:  # a failed phase leaves no worker running
        for proc in _CHILDREN:
            if proc.poll() is None:
                proc.kill()
    # Every thread is joined and every line flushed: leave without the interpreter's teardown,
    # which took ~8 s on the card's machine (the command's time less ``since_start``) freeing
    # what the run cached on the card and the host; the process's exit frees it all at once.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
