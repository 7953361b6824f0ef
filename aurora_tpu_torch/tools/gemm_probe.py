"""GEMM throughput at the backbone's shapes: cuBLAS against the hand-blocked kernel K12.

Counterpart of ``tools/gemm_probe.py``. Its XLA sections are ``torch.matmul`` here (the
library's time, the yardstick a fused kernel's products have to beat); its Pallas GEMM is
:func:`aurora_tpu_torch.ops.probes.gemm_blocked`, a TMA + ``wgmma`` pipeline swept over the
row block MB, the unit of its schedule (``blocks`` in a result is the number of row blocks):

1. cuBLAS, output width N in (512, 1024, 2048) at M = 259200, K = 512;
2. cuBLAS with an f32 output at the proj shape (the cost of the narrower write);
3. K12 at the proj shape (K = N = 512), MB in (512, 1024, 2160, 3240);
3b. cuBLAS on feature-major activations: ``(K, N)^T (K, M) -> (N, M)``;
3c. cuBLAS in f32 at N = 512;
4. the fc2 shape (M = 64800, K = 2048, N = 512): cuBLAS, then K12 with MB in (540, 1080, 2160).

Each K12 result carries its error against ``torch.matmul`` in f32 rounded to bf16, and the
library's time on the same inputs. Times are medians of ``--steps`` runs after warm-up by
CUDA events; rates are shares of the H100's 989 TF/s (bf16) or 67 TF/s (f32).

Usage: ``python -m aurora_tpu_torch.tools.gemm_probe [--device cpu] [--steps N]``.
"""

from __future__ import annotations

import argparse

import torch

from aurora_tpu_torch.ops import probes
from aurora_tpu_torch.tools import card_line, rel_err, report, resolve_device, result, time_ms

PROJ = (259200, 512, 512, (512, 1024, 2160, 3240))  # M, K, N, row blocks
FC2 = (64800, 2048, 512, (540, 1080, 2160))


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="the card unless 'cpu' is given")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device {card_line(dev)}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rn(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    out: list[dict] = []

    def emit(label, fn, M, K, N, itemsize=2, out_itemsize=2, **kw):
        ms = time_ms(fn, dev, args.steps)
        out.append(report(result(
            label, ms, dev, flops=2 * M * K * N,
            nbytes=(M * K + K * N) * itemsize + M * N * out_itemsize, **kw)))
        return ms

    def blocked(name, x, w, lib_ms, blocks):
        M, K = x.shape
        N = w.shape[1]
        want = probes.gemm_blocked_plain(x, w)
        for MB in blocks:
            if M % MB:
                continue
            err = rel_err(probes.gemm_blocked(x, w, MB), want)
            emit(f"gemm_blocked {name} MB={MB}", lambda: probes.gemm_blocked(x, w, MB), M, K, N,
                 err=err, library_ms=lib_ms, shape=name, MB=MB, blocks=M // MB)

    M, K, _, proj_blocks = PROJ
    x = rn(M, K)
    for N in (512, 1024, 2048):
        w = rn(K, N, std=0.02)
        ms = emit(f"cublas M={M} K={K} N={N}", lambda: torch.matmul(x, w), M, K, N)
        if N == K:
            w512, proj_ms = w, ms
    if dev.type == "cuda" and "out_dtype" in (torch.mm.__doc__ or ""):
        emit("cublas proj f32 out", lambda: torch.mm(x, w512, out_dtype=torch.float32), M, K, K,
             out_itemsize=4)
    blocked("proj", x, w512, proj_ms, proj_blocks)

    xT = x.t().contiguous()  # (K, M)
    for N in (512, 2048):
        w = rn(K, N, std=0.02)
        emit(f"cublas feat-major K={K} N={N} (out (N,M))", lambda: torch.matmul(w.t(), xT), M, K, N)
    del xT
    xf, wf32 = x.float(), rn(K, K, std=0.02, dtype=torch.float32)
    emit(f"cublas f32 M={M} K={K} N={K}", lambda: torch.matmul(xf, wf32), M, K, K, itemsize=4,
         out_itemsize=4, f32=True)
    del x, xf

    M2, K2, N2, fc2_blocks = FC2
    x2, w2 = rn(M2, K2), rn(K2, N2, std=0.02)
    fc2_ms = emit(f"cublas fc2 M={M2} K={K2} N={N2}", lambda: torch.matmul(x2, w2), M2, K2, N2)
    blocked("fc2", x2, w2, fc2_ms, fc2_blocks)
    return out


if __name__ == "__main__":
    main()
