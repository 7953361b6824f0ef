"""Backbone ablation bench: where does the 1.3 B backbone's time and memory go on the card?

Counterpart of ``tools/backbone_ablate.py``, with its variant names. Runs the full bf16
backbone (:mod:`aurora_tpu_torch.model.swin3d`, seeded random weights with the FiLM
modulations opened) and the kernels at the backbone's stage shapes in one process:

  base          attention_impl and mlp_impl "auto" (K2 with its tail, K3)
  mlp_pallas    mlp_impl="pallas" (K2 without tail, plain proj and FiLM LayerNorm, K8)
  mlp_fused     mlp_impl="fused" (what "auto" resolves to in the port)
  no_adaln      mlp_pallas with the FiLM LayerNorm replaced by identity
  no_roll       base with the cyclic shifts removed
  no_attn       mlp_pallas with the attention core replaced by qkv[..., :D] (GEMMs + layout)
  gemms         torch.matmul at the qkv / proj / fc1 / fc2 shapes of each stage (cuBLAS)
  layout        partition + reverse and roll round trips
  kernels       K3, K5 and the qkv GEMM per stage against their bounds
  attn          K6 without its tail, masked and unmasked, per stage
  rollfuse      the shifted block's layout chain with K1 against torch.roll
  attn5d_check  backbone under attention_impl "pallas" against "pallas_windowed"
  mlp_t         K9, the feature-major MLP branch, per stage and row block R
  attn_probe    K10, the attention kernel's timing modes at the stage-1 shape
  attn5d        K11, the strip kernel against the chain partition -> K6 -> reverse

Times are medians of ``--steps`` runs after warm-up: CUDA events around a kernel or a
chain, the host clock around a synchronised backbone pass, which also reports
``torch.cuda.max_memory_allocated()`` over its run. Rates are shares of the
H100's 989 TF/s (bf16), 67 TF/s (f32) and 3.35 TB/s. Where a kernel ran, the result
carries its error against the plain version on the same inputs.

Usage: ``python -m aurora_tpu_torch.tools.backbone_ablate [--device cpu] [--steps N]
[--H 721 --W 1440] [--stages 0,1,2] [--variants base,...]``. ``main(argv, cfg=...)`` takes
another :class:`~aurora_tpu_torch.model.config.AuroraConfig` than the 1.3 B one.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from aurora_tpu_torch.model import swin3d
from aurora_tpu_torch.model.config import LARGE_CONFIG, AuroraConfig
from aurora_tpu_torch.model.nn import AdaptiveLayerNorm, linear
from aurora_tpu_torch.ops import mlp, probes, roll, window_attention
from aurora_tpu_torch.ops.masks import window_group_ids
from aurora_tpu_torch.tools import (
    branch_err,
    card_line,
    rel_err,
    report,
    resolve_device,
    result,
    time_ms,
)

VARIANTS = (
    "base", "mlp_pallas", "mlp_fused", "no_adaln", "no_roll", "no_attn", "gemms", "layout",
    "kernels", "attn", "rollfuse", "attn5d_check", "mlp_t", "attn_probe", "attn5d",
)


@contextlib.contextmanager
def patched(obj, name: str, value):
    """Set ``obj.name`` for the length of the block and put the old value back."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _attention_core_skipped(xp, wqkv, bqkv, groups, ws, num_heads, tail=None, ln_eps=1e-5):
    """``window_attention_tail`` without its core: the qkv GEMM, then its first D features."""
    assert tail is None, "no_attn runs where proj follows the attention as a plain GEMM"
    return linear(xp, wqkv, bqkv)[..., : xp.shape[-1]].contiguous()


def main(argv=None, *, cfg: Optional[AuroraConfig] = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="the card unless 'cpu' is given")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--H", type=int, default=721)
    ap.add_argument("--W", type=int, default=1440)
    ap.add_argument("--stages", default="0,1,2", help="stage filter for the per-stage sweeps")
    ap.add_argument("--variants", default="base,mlp_pallas,no_adaln,no_roll,no_attn",
                    help="comma-separated subset of: " + ",".join(VARIANTS))
    args = ap.parse_args(argv)
    variants = args.variants.split(",")
    unknown = sorted(set(variants) - set(VARIANTS))
    if unknown:
        raise ValueError(f"unknown variants {unknown}; this tool has {VARIANTS}")
    dev = resolve_device(args.device)
    stages_on = {int(s) for s in args.stages.split(",")}

    cfg = cfg or LARGE_CONFIG
    bb = cfg.backbone
    P = cfg.patch_size
    Hc, Wc = args.H - args.H % P, args.W - args.W % P
    patch_res = (cfg.latent_levels, Hc // P, Wc // P)
    L, D = math.prod(patch_res), cfg.embed_dim
    ws = bb.window_size
    N = math.prod(ws)
    ss = tuple(w // 2 for w in ws)
    bf = torch.bfloat16
    print(f"device {card_line(dev)}; tokens {patch_res} = {L}, D={D}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    # (resolution, width, heads, tokens) per stage, as the backbone's encoder walks them.
    all_res, _ = swin3d.get_encoder_specs(bb, patch_res)
    stages = [(i, res, D * 2**i, bb.encoder_num_heads[i], math.prod(res))
              for i, res in enumerate(all_res) if i in stages_on]
    out: list[dict] = []

    def emit(label, ms, **kw):
        out.append(report(result(label, ms, dev, **kw)))
        return ms

    def loop_ms(fn):
        return time_ms(fn, dev, args.steps)

    def padded(res):
        return tuple(r + (-r) % w for r, w in zip(res, ws))

    # ------------------------------------------------------------------ backbone variants
    x0 = lead = None

    def make_backbone(**route):
        """The backbone under ``route`` with the same seeded weights every time: FiLM
        modulations opened (at fresh init they are zero and every block is an identity),
        stored in bf16."""
        g = torch.Generator(device=dev).manual_seed(0)
        model = swin3d.Backbone(dataclasses.replace(bb, **route), device=dev, dtype=torch.float32)
        model.reset_parameters(g)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if "modulation" in name and name.endswith("weight"):
                    p.copy_(torch.randn(p.shape, generator=g, device=dev) * 0.05)
        return model.to(bf)

    def timed_run(label, keep_output=False, **route):
        """Steady-state time of one backbone pass and its peak memory."""
        nonlocal x0, lead
        if x0 is None:
            x0, lead = rn(1, L, D), torch.ones(D, device=dev)
        model = make_backbone(**route)
        with torch.no_grad():
            y = model(x0, lead, 0, patch_res)  # warm-up: builds and loads the kernels
            if not torch.isfinite(y.float()).all():
                raise AssertionError(f"{label}: non-finite backbone output")
            if dev.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            times = []
            for i in range(args.steps):
                t0 = time.perf_counter()
                model(x0, lead, i % 3, patch_res)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
        extra = {}
        if dev.type == "cuda":
            extra["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        emit(label, float(np.median(times)), all_ms=[round(t, 1) for t in times], **extra)
        return y if keep_output else None

    if "base" in variants:
        timed_run("base (attn=auto, mlp=auto: K2 with tail, K3)")
    if "mlp_pallas" in variants:
        timed_run("mlp_pallas (K2 no tail, plain proj + FiLM LN, K8)", mlp_impl="pallas")
    if "mlp_fused" in variants:
        timed_run("mlp_fused (mlp+adaln+residual kernel)", mlp_impl="fused")
    if "no_adaln" in variants:
        # The FiLM LayerNorm is a plain pass only where mlp_impl is not "fused".
        with patched(AdaptiveLayerNorm, "forward", lambda self, x, c, scale_bias=0.0: x):
            timed_run("no_adaln (mlp_pallas, identity film)", mlp_impl="pallas")
    if "no_roll" in variants:
        with patched(swin3d, "roll3d", lambda x, shifts: x):
            timed_run("no_roll (base, shifts removed)")
    if "no_attn" in variants:
        with patched(swin3d, "window_attention_tail", _attention_core_skipped):
            timed_run("no_attn (mlp_pallas, gemms+layout only)", mlp_impl="pallas")

    # ------------------------------------------------------------------ library GEMMs
    if "gemms" in variants:
        # cuBLAS at the block's GEMM shapes: what a fused kernel's products cost alone.
        for stage, _, Ds, _, Ls in stages:
            for name, K, Nn in (("qkv", Ds, 3 * Ds), ("proj", Ds, Ds), ("fc1", Ds, 4 * Ds),
                                ("fc2", 4 * Ds, Ds)):
                a, w = rn(Ls, K), rn(K, Nn, std=0.02)
                emit(f"gemm s{stage} {name} ({Ls}x{K}x{Nn})", loop_ms(lambda: torch.matmul(a, w)),
                     flops=2 * Ls * K * Nn, nbytes=2 * (Ls * K + K * Nn + Ls * Nn), stage=stage,
                     gemm=name)
                del a, w

    if "layout" in variants:
        x5 = rn(1, *patch_res, D)
        nb = 4 * x5.numel() * 2  # two passes, each reads and writes the tokens
        xp = swin3d.pad_3d(x5, tuple((-r) % w for r, w in zip(patch_res, ws)))

        def part_rev():
            w = window_attention.window_partition(xp, ws).contiguous()
            return window_attention.window_reverse(w, ws, *padded(patch_res)).contiguous()

        emit("partition+reverse roundtrip", loop_ms(part_rev), nbytes=nb)
        emit("roll roundtrip (K1 roll3d)",
             loop_ms(lambda: roll.roll3d(roll.roll3d(x5, (-1, -3, -6)), (1, 3, 6))), nbytes=nb)
        emit("roll roundtrip (torch.roll)",
             loop_ms(lambda: torch.roll(torch.roll(x5, (-1, -3, -6), (1, 2, 3)), (1, 3, 6),
                                        (1, 2, 3))), nbytes=nb)
        del x5, xp

    # ------------------------------------------------------------------ the block's kernels
    if "kernels" in variants:
        for stage, _, Ds, _, Ls in stages:
            Hs = 4 * Ds
            xs = rn(1, Ls, Ds)
            w1, b1 = rn(Ds, Hs, std=0.02, dtype=torch.float32), torch.zeros(Hs, device=dev)
            w2, b2 = rn(Hs, Ds, std=0.02, dtype=torch.float32), torch.zeros(Ds, device=dev)
            wp, bp = rn(Ds, Ds, std=0.02, dtype=torch.float32), torch.zeros(Ds, device=dev)
            sh, sc = torch.zeros(1, Ds, device=dev), torch.full((1, Ds), 0.1, device=dev)
            a3 = (xs, w1, b1, w2, b2, sh, sc)
            _, err = branch_err(mlp.mlp_adaln_residual(*a3), mlp.mlp_adaln_residual_plain(*a3), xs)
            emit(f"s{stage} mlp_fused K3 (L={Ls},D={Ds})", loop_ms(lambda: mlp.mlp_adaln_residual(*a3)),
                 flops=4 * Ls * Ds * Hs, nbytes=(2 * Ls * Ds + 2 * Ds * Hs) * 2, err=err, stage=stage)
            a5 = (xs, wp, bp, xs, sh, sc)
            _, err = branch_err(mlp.linear_adaln_residual(*a5),
                                mlp.linear_adaln_residual_plain(*a5), xs)
            emit(f"s{stage} proj_fused K5 (L={Ls},D={Ds})",
                 loop_ms(lambda: mlp.linear_adaln_residual(*a5)),
                 flops=2 * Ls * Ds * Ds, nbytes=(3 * Ls * Ds + Ds * Ds) * 2, err=err, stage=stage)
            wq = rn(Ds, 3 * Ds, std=0.02)
            emit(f"s{stage} qkv cuBLAS (L={Ls},D={Ds})", loop_ms(lambda: torch.matmul(xs, wq)),
                 flops=2 * Ls * Ds * 3 * Ds, nbytes=(4 * Ls * Ds + 3 * Ds * Ds) * 2, stage=stage)
            del xs, a3, a5

    if "attn" in variants:
        for stage, res, Ds, heads, _ in stages:
            pres = padded(res)
            nW = math.prod(pres) // N
            xw = rn(1, nW, N, Ds)
            wq, bq = rn(Ds, 3 * Ds, std=0.02), torch.zeros(3 * Ds, device=dev, dtype=bf)
            fl = 2 * nW * N * Ds * 3 * Ds + 4 * nW * N * N * Ds
            nb = 2 * nW * N * Ds * 2 + 3 * Ds * Ds * 2
            for label, g in (("unmasked", None), ("masked", window_group_ids(*res, ws, ss))):
                a = (xw, wq, bq, g, heads)
                err = rel_err(window_attention.window_attention_windowed(*a),
                              window_attention.window_attention_windowed_plain(*a))
                emit(f"s{stage} attn_qkv_fused K6 no tail {label} (nW={nW},D={Ds})",
                     loop_ms(lambda: window_attention.window_attention_windowed(*a)),
                     flops=fl, nbytes=nb, err=err, stage=stage)
            del xw

    if "rollfuse" in variants:
        # The shifted block's layout chain: roll -> partition ... reverse -> roll back.
        x5 = rn(1, *patch_res, D)
        pad = tuple((-r) % w for r, w in zip(patch_res, ws))
        pres = padded(patch_res)

        def chain(roll_fn):
            y = swin3d.pad_3d(roll_fn(x5, (-ss[0], -ss[1], -ss[2])), pad)
            w = window_attention.window_partition(y, ws) * 0.999
            y = swin3d.crop_3d(window_attention.window_reverse(w, ws, *pres), pad).contiguous()
            return roll_fn(y, ss)

        got = chain(roll.roll3d)
        want = chain(lambda t, s: torch.roll(t, s, dims=(1, 2, 3)))
        emit("shifted chain (K1 roll3d)", loop_ms(lambda: chain(roll.roll3d)),
             err=rel_err(got, want))
        emit("shifted chain (torch.roll)",
             loop_ms(lambda: chain(lambda t, s: torch.roll(t, s, dims=(1, 2, 3)))))
        del x5, got, want

    if "attn5d_check" in variants:
        # The two attention routes compute the same math; max |delta| shows how far their
        # bf16 roundings drift over the whole backbone.
        o5 = timed_run("backbone attention_impl=pallas (K2, 5D in place)", keep_output=True,
                       attention_impl="pallas")
        ow = timed_run("backbone attention_impl=pallas_windowed (K6)", keep_output=True,
                       attention_impl="pallas_windowed")
        d = (o5.float() - ow.float()).abs().max().item()
        r = d / (ow.float().abs().max().item() + 1e-30)
        print(f"attn5d_check: max|delta| = {d:.3e} (rel {r:.3e})", flush=True)
        out.append(dict(label="attn5d_check", device=dev.type, max_abs_delta=d, rel_delta=r))
        del o5, ow

    # ------------------------------------------------------------------ the probe kernels
    if "mlp_t" in variants:
        for stage, _, Ds, _, Ls in stages:
            Hs = 4 * Ds
            xs = rn(Ls, Ds)
            w1, b1 = rn(Ds, Hs, std=0.02), torch.zeros(Hs, 1, device=dev)
            w2, b2 = rn(Hs, Ds, std=0.02), torch.zeros(Ds, 1, device=dev)
            sh, sc = torch.zeros(Ds, 1, device=dev), torch.full((Ds, 1), 0.1, device=dev)
            a = (xs, w1, b1, w2, b2, sh, sc)
            want = probes.mlp_t_plain(*a)
            for R in (1800, 3600, 5400):
                if Ls % R:
                    continue
                _, err = branch_err(probes.mlp_t(*a, R), want, xs)
                emit(f"s{stage} mlp_t R={R} (L={Ls},D={Ds})", loop_ms(lambda: probes.mlp_t(*a, R)),
                     flops=4 * Ls * Ds * Hs, nbytes=(2 * Ls * Ds + 2 * Ds * Hs) * 2, err=err,
                     stage=stage, R=R, blocks=Ls // R)
            del xs, a, want

    if "attn_probe" in variants:
        # Stage-1 shape: what inside the qkv-fused attention kernel costs the time?
        res, heads = all_res[0], bb.encoder_num_heads[0]
        nW = math.prod(padded(res)) // N
        xw = rn(1, nW, N, D)
        wq, bq = rn(D, 3 * D, std=0.02), torch.zeros(1, 3 * D, device=dev, dtype=bf)
        fl = 2 * nW * N * D * 3 * D + 4 * nW * N * N * D
        for mode in probes.ATTN_PROBE_MODES:
            a = (xw, wq, bq, heads, mode)
            err = rel_err(probes.attn_probe(*a), probes.attn_probe_plain(*a))
            emit(f"s0 attn_probe {mode} (nW={nW},D={D})", loop_ms(lambda: probes.attn_probe(*a)),
                 flops=fl, nbytes=2 * nW * N * D * 2 + 3 * D * D * 2, err=err, mode=mode)
        del xw

    if "attn5d" in variants:
        for stage, res, Ds, heads, _ in stages:
            Cp, Hp, Wp = padded(res)
            nW = Cp * Hp * Wp // N
            x5 = rn(1, Cp, Hp, Wp, Ds)  # random data on the padded grid
            wq, bq = rn(Ds, 3 * Ds, std=0.02), torch.zeros(3 * Ds, device=dev, dtype=bf)
            fl = 2 * nW * N * Ds * 3 * Ds + 4 * nW * N * N * Ds
            nb = 2 * nW * N * Ds * 2 + 3 * Ds * Ds * 2

            def chain():
                w = window_attention.window_partition(x5, ws).contiguous()
                o = window_attention.window_attention_windowed(w, wq, bq, None, heads)
                return window_attention.window_reverse(o, ws, Cp, Hp, Wp).contiguous()

            want = chain()
            emit(f"s{stage} chain part+qkvattn+rev (nW={nW})", loop_ms(chain), flops=fl, nbytes=nb,
                 stage=stage)
            for mode in probes.ATTN5D_MODES:
                a = (x5, wq, bq, ws, heads, mode)
                got = probes.attn5d_direct(*a)
                emit(f"s{stage} direct5d {mode}", loop_ms(lambda: probes.attn5d_direct(*a)),
                     flops=fl, nbytes=nb, err=rel_err(got, probes.attn5d_direct_plain(*a)),
                     vs_chain=rel_err(got, want), stage=stage, mode=mode)
            del x5, want, got

    return out


if __name__ == "__main__":
    main()
