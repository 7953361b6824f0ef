"""What holds K3 ``mlp_adaln_residual`` / K8 ``mlp_fused``, K12 ``gemm_blocked``, K7
``sdpa_windows``, K2 / K6 ``window_attention(_windowed)``, K4 ``perceiver_core``, K9 ``mlp_t``,
K10 ``attn_probe`` and K11 ``attn5d_direct`` back: each kernel against copies of itself with
one part switched off, at the shapes the probe tools, the backbone and the perceiver give
them.

The copies are built from the same sources with a preprocessor switch (``nvcc -D...``) into
``build/kernels/ablate/`` and called through their C entries; none of them is reachable from
a wrapper, and all but the ring-depth variants compute wrong results on purpose:

* K3 / K8 (``csrc/mlp.cu``, at the three backbone shapes and the de-aggregation shape):
  ``no_gelu`` (the hidden is rounded only), ``no_ln`` (K3 with K8's epilogue and no row
  kernel), ``no_loads``, ``no_epilogue`` (both products, nothing parked or stored, no row
  kernel), ``lockstep`` (a tile's GELU runs right after its last product instead of under
  the next tile's), and ``only_fc1`` / ``only_fc2`` (one of the two products alone);
  ``torch.matmul`` for fc1 and for fc2 is timed beside them;
* K12 (``csrc/gemm.cu``): ``no_loads`` (the producer releases stages without a TMA load, so
  the consumers multiply what the stage holds), ``no_epilogue`` (the product is kept in
  registers, nothing is stored), both, and a ring of 3 and of 2 stages in place of 4;
* K7 (``csrc/sdpa.cu``): ``no_core`` (loads, ring and stores only), ``no_loads`` (only the
  first units are loaded), ``ring_1`` (one stage: no load overlaps a product) and
  ``mask_every_unit`` (the mask bits rebuilt per unit instead of per window);
* K2 / K6 (``csrc/window_attention.cu``, at the three backbone stages, masked, with the
  tail): ``only_qkv`` (the qkv product alone), ``only_core`` (the attention core alone, on
  what the qkv scratch holds), ``only_tail`` (proj and the row kernel alone, on what the
  attention scratch holds), ``no_loads`` (no TMA load in any of the launches), and the two
  halves of the qkv round trip through device memory: ``only_qkv_no_store`` (the product
  without its epilogue's store) and ``only_core_no_loads`` (the core without reading the
  scratch); ``torch.matmul`` at the qkv and proj shapes is timed beside them. ``only_core``
  of K2 against K6 is the cost of reading windows in place through the 5D map;
* K4 (``csrc/resampler.cu``, at the aggregation's shape with and without ``ln_k`` and the
  de-aggregation's): ``only_logits`` (the fold and the f32 logits pass, which also writes
  the bf16 context; with ``ln_k`` also the sums of squares of the context times the centred
  weights), ``only_v`` (the v product), ``only_mix`` (the softmax and level-order
  sum) and ``only_tail`` (the out-projection and the row kernel), each on what the scratch
  holds; ``torch.matmul`` at the v and out-projection shapes is timed beside them, and for
  ``ln_k`` at the shape of the context times the centred key weights (the kernels take that
  product in three bf16 parts);
* K9 (``csrc/mlp_t.cu``, at the tool's stages and row blocks 1800 and 5400): ``only_fc1``,
  ``no_gelu`` (the hidden rounded only), ``no_stats`` (no LayerNorm statistics, no row
  kernel) and ``no_transpose`` (y^T stored as it lies instead of back to token-major rows);
  ``torch.matmul`` for fc1 and for fc2 beside them;
* K10 (``csrc/attn_probe.cu``, at the tool's stage-1 shape): ``only_qkv`` and ``only_core``
  (on what the qkv scratch holds) in every mode;
* K11 (``csrc/attn5d_direct.cu``, at the tool's padded grids, stages 1-3): ``only_qkv`` and
  ``only_core`` (on what the qkv scratch holds) in both work orders, ``torch.matmul`` at the
  qkv shape beside them.

Every time is a median of ``--steps`` launches after warm-up (``tools.time_ms``: CUDA
events, each launch behind a memset that keeps the queue ahead of the host and leaves the
L2 cold); ``torch.matmul`` is timed the same way beside K12.

Usage: ``python -m aurora_tpu_torch.tools.kernel_ablate [--steps N]`` (needs the card).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from aurora_tpu_torch.ops import _lib, mlp, probes, resampler
from aurora_tpu_torch.ops import window_attention as wa
from aurora_tpu_torch.ops.masks import group_ids_tensor, window_group_ids
from aurora_tpu_torch.tools import card_line, report, resolve_device, result, time_ms
from aurora_tpu_torch.tools.gemm_probe import FC2, PROJ

GEMM_VARIANTS = {
    "full": (), "no_loads": ("ABLATE_NO_LOADS",), "no_epilogue": ("ABLATE_NO_EPILOGUE",),
    "no_loads_no_epilogue": ("ABLATE_NO_LOADS", "ABLATE_NO_EPILOGUE"),
    "ring_3": ("GEMM_STAGES=3",), "ring_2": ("GEMM_STAGES=2",),
}
MLP_VARIANTS = {
    "full": (), "no_gelu": ("ABLATE_NO_GELU",), "no_ln": ("ABLATE_NO_LN",),
    "no_loads": ("ABLATE_NO_LOADS",), "no_epilogue": ("ABLATE_NO_EPILOGUE",),
    "lockstep": ("ABLATE_LOCKSTEP",), "only_fc1": ("ABLATE_ONLY_FC1",),
    "only_fc2": ("ABLATE_ONLY_FC2",),
}
# rows, D, hidden: the backbone's three stages and the perceiver's de-aggregation call
MLP_SHAPES = ((259200, 512, 2048), (64800, 1024, 4096), (16200, 2048, 8192), (842400, 1024, 2048))
SDPA_VARIANTS = {
    "full": (), "no_core": ("ABLATE_NO_CORE",), "no_loads": ("ABLATE_NO_LOADS",),
    "ring_1": ("SDPA_RING=1",), "mask_every_unit": ("ABLATE_MASK_EVERY_UNIT",),
}
WINDOW_VARIANTS = {
    "full": (), "only_qkv": ("ABLATE_ONLY_QKV",), "only_core": ("ABLATE_ONLY_CORE",),
    "only_tail": ("ABLATE_ONLY_TAIL",), "no_loads": ("ABLATE_NO_LOADS",),
    "only_qkv_no_store": ("ABLATE_ONLY_QKV", "ABLATE_NO_EPILOGUE"),
    "only_core_no_loads": ("ABLATE_ONLY_CORE", "ABLATE_NO_LOADS"),
}
STAGES = ((4, 180, 360, 512, 8), (4, 90, 180, 1024, 16), (4, 45, 90, 2048, 32))
RESAMPLER_VARIANTS = {
    "full": (), "only_logits": ("ABLATE_ONLY_LOGITS",), "only_v": ("ABLATE_ONLY_V",),
    "only_mix": ("ABLATE_ONLY_MIX",), "only_tail": ("ABLATE_ONLY_TAIL",),
}
MLP_T_VARIANTS = {
    "full": (), "only_fc1": ("ABLATE_ONLY_FC1",), "no_gelu": ("ABLATE_NO_GELU",),
    "no_stats": ("ABLATE_NO_STATS",), "no_transpose": ("ABLATE_NO_TRANSPOSE",),
}
ATTN_PROBE_VARIANTS = {"full": (), "only_qkv": ("ABLATE_ONLY_QKV",),
                       "only_core": ("ABLATE_ONLY_CORE",)}
ATTN5D_VARIANTS = ATTN_PROBE_VARIANTS
# label, K, D, heads, Q: the level aggregation and de-aggregation over 64800 token columns
PERCEIVER_SHAPES = (("agg", 13, 512, 16, 3), ("de-agg", 3, 1024, 16, 13))
_P, _I = ctypes.c_void_p, ctypes.c_int


def build_variants(source: str, variants: dict[str, tuple[str, ...]]) -> dict[str, ctypes.CDLL]:
    """One ``nvcc`` per variant of ``csrc/<source>.cu``, all started together."""
    out_dir = _lib.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _lib._nvcc()
    procs = {}
    for tag, defines in variants.items():
        so = out_dir / f"lib{source}_{tag}.so"
        cmd = [nvcc, *_lib.NVCC_FLAGS, *(f"-D{d}" for d in defines), "-I", str(_lib.CSRC),
               "-o", str(so), str(_lib.CSRC / f"{source}.cu")]
        procs[tag] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for tag, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source} [{tag}]\n{log.decode(errors='replace')[-4000:]}")
        libs[tag] = ctypes.CDLL(str(so))
    return libs


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="the card; there is nothing to ablate on the CPU")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("kernel_ablate builds and times CUDA kernels: it needs the card")
    print(f"device {card_line(dev)}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    stream = torch.cuda.current_stream(dev).cuda_stream

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(bf)

    def ms(fn) -> float:
        return time_ms(fn, dev, args.steps)

    out: list[dict] = []

    def emit(label, t, **kw):
        out.append(report(result(label, t, dev, **kw)))

    def ablate_mlp():
        mlps = build_variants("mlp", MLP_VARIANTS)
        for shape in MLP_SHAPES:
            ablate_mlp_shape(mlps, *shape)

    def ablate_mlp_shape(mlps, M, D, Hd):
        f32 = torch.float32
        x, o = rn(1, M, D), torch.empty(M, D, device=dev, dtype=bf)
        ops = (rn(D, Hd, std=0.02), rn(Hd, std=0.02).to(f32), rn(Hd, D, std=0.02),
               rn(D, std=0.02).to(f32))
        film = (rn(1, D, std=0.1).to(f32), rn(1, D).to(f32), 0.0, M, 1e-5)
        hid = rn(M, Hd)
        work = dict(flops=4 * M * D * Hd, nbytes=2 * M * D * 2 + 2 * D * Hd * 2)
        emit(f"torch.matmul fc1 ({M},{D})x({D},{Hd})", ms(lambda: torch.matmul(x[0], ops[0])),
             flops=2 * M * D * Hd)
        emit(f"torch.matmul fc2 ({M},{Hd})x({Hd},{D})", ms(lambda: torch.matmul(hid, ops[2])),
             flops=2 * M * D * Hd)
        del hid
        for kernel, f in (("mlp_adaln_residual", film), ("mlp_fused", None)):
            for tag, lib in mlps.items():
                if f is None and tag == "no_ln":
                    continue
                fn = lib.mlp_rows
                fn.argtypes, fn.restype = mlp._MLP_ROWS_ARGS, _I

                def call(fn=fn, f=f):
                    mlp._mlp_rows(fn, x[0], ops, o, f)

                emit(f"{kernel} ({M},{D}) hidden {Hd} [{tag}]", ms(call), **work)

    def ablate_gemm():
        gemm = build_variants("gemm", GEMM_VARIANTS)
        for name, shape in (("proj", PROJ), ("fc2", FC2)):
            ablate_gemm_shape(gemm, name, *shape)

    def ablate_gemm_shape(gemm, name, M, K, N, blocks):
        a, w = rn(M, K), rn(K, N, std=0.02)
        o = torch.empty(M, N, device=dev, dtype=bf)
        work = dict(flops=2 * M * K * N, nbytes=2 * (M * K + K * N + M * N))
        emit(f"torch.matmul {name}", ms(lambda: torch.matmul(a, w)), **work)
        for MB in blocks:
            if M % MB:
                continue
            ppb, _, units = probes.gemm_blocked_schedule(M, K, N, MB)
            for tag, lib in gemm.items():
                fn = lib.gemm_blocked
                fn.argtypes, fn.restype = [_P] * 3 + [_I] * 6 + [_P], _I

                def call(fn=fn):
                    _lib.check(fn(a.data_ptr(), w.data_ptr(), o.data_ptr(), M, K, N, MB, ppb, units,
                                  stream), "gemm_blocked variant")

                emit(f"gemm_blocked {name} MB={MB} [{tag}]", ms(call), units=units,
                     waves=units / torch.cuda.get_device_properties(dev).multi_processor_count,
                     **work)

    def ablate_sdpa():
        sdpa = build_variants("sdpa", SDPA_VARIANTS)
        for stage in STAGES:
            ablate_sdpa_stage(sdpa, *stage)

    def ablate_sdpa_stage(sdpa, C, H, W, D, heads):
        ws, ss = (2, 6, 12), (1, 3, 6)
        Hp, Wp = H + (-H) % ws[1], W + (-W) % ws[2]
        nW = C * Hp * Wp // 144
        qkv = rn(1, nW, 144, 3 * D)
        o = torch.empty(1, nW, 144, D, device=dev, dtype=bf)
        work = dict(flops=4 * nW * heads * 144 * 144 * 64, nbytes=4 * nW * 144 * D * 2)
        for groups in (window_group_ids(C, H, W, ws, ss), None):
            kind = "masked" if groups is not None else "unmasked"
            gid = None if groups is None else group_ids_tensor(groups, dev)
            for tag, lib in sdpa.items():
                if tag == "mask_every_unit" and gid is None:
                    continue
                fn = lib.sdpa_windows
                fn.argtypes, fn.restype = [_P] * 3 + [_I] * 4 + [_P], _I

                def call(fn=fn):
                    _lib.check(fn(qkv.data_ptr(), None if gid is None else gid.data_ptr(),
                                  o.data_ptr(), 1, nW, D, heads, stream), "sdpa_windows variant")

                emit(f"sdpa_windows D={D} {kind} [{tag}]", ms(call), **work)

    def ablate_window():
        libs = build_variants("window_attention", WINDOW_VARIANTS)
        for stage in STAGES:
            ablate_window_stage(libs, *stage)

    def ablate_window_stage(libs, C, H, W, D, heads):
        ws, ss = (2, 6, 12), (1, 3, 6)
        Hp, Wp = H + (-H) % ws[1], W + (-W) % ws[2]
        rows = C * Hp * Wp
        nW = rows // 144
        xp, xw = rn(1, C, Hp, Wp, D), rn(1, nW, 144, D)
        wqkv, bqkv = rn(D, 3 * D, std=0.02), rn(3 * D, std=0.02)
        tail = (rn(D, D, std=0.02), rn(D, std=0.02).float(), rn(1, D, std=0.1).float(),
                rn(1, D).float())
        groups = window_group_ids(C, H, W, ws, ss)
        a = xp.view(rows, D)
        emit(f"torch.matmul qkv ({rows},{D})x({D},{3 * D})", ms(lambda: torch.matmul(a, wqkv)),
             flops=6 * rows * D * D)
        emit(f"torch.matmul proj ({rows},{D})x({D},{D})", ms(lambda: torch.matmul(a, tail[0])),
             flops=2 * rows * D * D)
        work = dict(flops=8 * rows * D * D + 4 * nW * heads * 144 * 144 * 64,
                    nbytes=2 * rows * D * 2 + 4 * D * D * 2)
        for name, x, geom, wsx in (("window_attention", xp, (C, Hp, Wp), ws),
                                   ("window_attention_windowed", xw, (0, 0, 0), (0, 0, 0))):
            for tag, lib in libs.items():
                fn = lib.window_attention
                fn.argtypes, fn.restype = wa._WINDOW_ATTENTION_ARGS, _I

                def call(fn=fn, x=x, geom=geom, wsx=wsx, name=name):
                    wa._window_attention_call(fn, x, wqkv, bqkv, groups, heads, tail, 1e-5, nW,
                                              rows, geom, wsx, name)

                emit(f"{name} D={D} masked, tail [{tag}]", ms(call), **work)

    def ablate_resampler():
        libs = build_variants("resampler", RESAMPLER_VARIANTS)
        for shape in PERCEIVER_SHAPES:
            ablate_resampler_shape(libs, *shape)

    def ablate_resampler_shape(libs, label, K, D, h, Q, M=64800):
        f32 = torch.float32
        inner, dh = D, D // h
        a = dict(ctx=rn(K, M, D).to(f32), wk=rn(D, inner, std=0.05).to(f32),
                 wv=rn(D, inner, std=0.05), qh=rn(Q, h, dh).to(f32), wout=rn(inner, D, std=0.05),
                 ln1_w=1 + rn(D, std=0.1).to(f32), ln1_b=rn(D, std=0.1).to(f32),
                 queries=rn(Q, D).to(f32))
        xv, o = rn(K * M, D), rn(M * Q, inner)
        emit(f"torch.matmul v ({K * M},{D})x({D},{inner})", ms(lambda: torch.matmul(xv, a["wv"])),
             flops=2 * K * M * D * inner)
        emit(f"torch.matmul out-projection ({M * Q},{inner})x({inner},{D})",
             ms(lambda: torch.matmul(o, a["wout"])), flops=2 * M * Q * inner * D)
        del xv, o
        lnks = [None]
        if label == "agg":
            lnks.append((1 + rn(inner, std=0.1).to(f32), rn(inner, std=0.1).to(f32)))
            xc, wc = rn(K * M, D), rn(D, inner, std=0.05)
            emit(f"torch.matmul ctx Wc ({K * M},{D})x({D},{inner}) (ln_k: three bf16 of them)",
                 ms(lambda: torch.matmul(xc, wc)), flops=2 * K * M * D * inner)
            del xc, wc
        for lnk in lnks:
            for tag, lib in libs.items():
                fn = lib.perceiver_core
                fn.argtypes, fn.restype = resampler._PERCEIVER_CORE_ARGS, _I

                def call(fn=fn, lnk=lnk):
                    resampler._perceiver_core_call(fn, *a.values(), dh**-0.5, 1e-5, True, lnk)

                emit(f"perceiver_core {label} ({K},{M},{D}) Q {Q}{', ln_k' if lnk else ''} [{tag}]",
                     ms(call))

    def ablate_mlp_t():
        libs = build_variants("mlp_t", MLP_T_VARIANTS)
        f32 = torch.float32
        for C, H, W, D, _ in STAGES:
            L, Hd = C * H * W, 4 * D
            x = rn(L, D)
            a = (x, rn(D, Hd, std=0.02), rn(Hd, 1, std=0.02).to(f32), rn(Hd, D, std=0.02),
                 rn(D, 1, std=0.02).to(f32), rn(D, 1, std=0.1).to(f32), rn(D, 1).to(f32))
            hid = rn(L, Hd)
            emit(f"torch.matmul fc1 ({L},{D})x({D},{Hd})", ms(lambda: torch.matmul(x, a[1])),
                 flops=2 * L * D * Hd)
            emit(f"torch.matmul fc2 ({L},{Hd})x({Hd},{D})", ms(lambda: torch.matmul(hid, a[3])),
                 flops=2 * L * D * Hd)
            del hid
            for R in (1800, 5400):
                if L % R:
                    continue
                for tag, lib in libs.items():
                    fn = lib.mlp_t
                    fn.argtypes, fn.restype = probes._MLP_T_ARGS, _I
                    emit(f"mlp_t ({L},{D}) R {R} [{tag}]",
                         ms(lambda fn=fn, R=R: probes._mlp_t_call(fn, *a, R, 1e-5)),
                         flops=4 * L * D * Hd, nbytes=2 * L * D * 2 + 2 * D * Hd * 2)
            del x, a

    def ablate_attn_probe():
        libs = build_variants("attn_probe", ATTN_PROBE_VARIANTS)
        nW, D, heads = 1800, 512, 8
        xw, wqkv, bqkv = rn(1, nW, 144, D), rn(D, 3 * D, std=0.02), rn(1, 3 * D, std=0.02)
        for mode in probes.ATTN_PROBE_MODES:
            for tag, lib in libs.items():
                if mode == "no_core" and tag == "only_core":
                    continue
                fn = lib.attn_probe
                fn.argtypes, fn.restype = probes._ATTN_PROBE_ARGS, _I
                emit(f"attn_probe (1,{nW},144,{D}) {mode} [{tag}]",
                     ms(lambda fn=fn, m=mode: probes._attn_probe_call(fn, xw, wqkv, bqkv, heads, m)))

    def ablate_attn5d_direct():
        libs = build_variants("attn5d_direct", ATTN5D_VARIANTS)
        ws = (2, 6, 12)
        for C, H, W, D, heads in STAGES:
            Hp, Wp = H + (-H) % ws[1], W + (-W) % ws[2]
            rows, nW = C * Hp * Wp, C * Hp * Wp // 144
            x5, wqkv, bqkv = rn(1, C, Hp, Wp, D), rn(D, 3 * D, std=0.02), rn(3 * D, std=0.02)
            a = x5.view(rows, D)
            emit(f"torch.matmul qkv ({rows},{D})x({D},{3 * D})", ms(lambda: torch.matmul(a, wqkv)),
                 flops=6 * rows * D * D)
            work = dict(flops=6 * rows * D * D + 4 * nW * heads * 144 * 144 * 64,
                        nbytes=2 * rows * D * 2 + 3 * D * D * 2)
            for mode in probes.ATTN5D_MODES:
                for tag, lib in libs.items():
                    fn = lib.attn5d_direct
                    fn.argtypes, fn.restype = probes._ATTN5D_ARGS, _I
                    emit(f"attn5d_direct (1,{C},{Hp},{Wp},{D}) {mode} [{tag}]",
                         ms(lambda fn=fn, m=mode: probes._attn5d_direct_call(
                             fn, x5, wqkv, bqkv, ws, heads, m)), **work)
            del x5, a

    ablate_mlp_t()
    ablate_attn_probe()
    ablate_attn5d_direct()
    ablate_mlp()
    ablate_gemm()
    ablate_sdpa()
    ablate_window()
    ablate_resampler()
    return out


if __name__ == "__main__":
    main()
