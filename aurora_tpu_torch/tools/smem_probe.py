"""The most dynamic shared memory one block can use on the attached card.

Counterpart of ``tools/vmem_probe.py``, which raised a Pallas kernel's VMEM scratch until
Mosaic refused. The card's counterpart of that ceiling is the dynamic shared memory a block
may opt in to: K13 (:func:`aurora_tpu_torch.ops.probes.smem_probe`) is launched with a
growing ``extern __shared__`` scratch until the attribute or the launch is refused. The
first size refused is the result and is printed, not raised. The tool does raise when the
largest size that ran gives a wrong output, is below what the card reports as its opt-in
maximum (rounded down to the sweep), or is below what a kernel of the port asks for.

Usage: ``python -m aurora_tpu_torch.tools.smem_probe [--device cpu]``. On the CPU there is
no shared memory to sweep: the plain version is checked once and no size is reported.
"""

from __future__ import annotations

import argparse

import torch

from aurora_tpu_torch.ops import probes
from aurora_tpu_torch.tools import card_line, resolve_device

SWEEP_KIB = (48, 64, 96, 128, 160, 192, 224, 227, 228, 232, 256)

# The largest dynamic shared memory each source of csrc/ asks for, in bytes, from its
# launch code: window_attention.cu's qkv and proj products (gemm_rows_sm90.cuh: 4 stages of
# 48 KB, 16 KB of output staging, barriers; its core asks for 111,648, sdpa.cu the same);
# mlp.cu's fc1 (3 stages of 48 KB, 64 KB of parked pre-activations, 8 KB of bias copies,
# barriers; fc2 and K5's proj ask for 214,080); resampler.cu's products on the ring of
# gemm_rows_sm90.cuh (v, the out-projection, ln_k's sums of squares; its logits pass asks for
# 3 stages of 128 x 36 + 32 x 64 f32, 79,872); attn_probe.cu and attn5d_direct.cu, whose qkv
# products are window_attention.cu's (attn_probe.cu's fulld core asks for 4 stages of 43,008,
# 173,120).
PORT_SMEM_REQUESTS = {
    "window_attention": 214080, "mlp": 222256, "resampler": 214080, "attn_probe": 214080,
    "attn5d_direct": 214080,
}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="the card unless 'cpu' is given")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device {card_line(dev)}", flush=True)
    x = torch.ones(8, 128, device=dev) + torch.arange(128, device=dev) / 128
    want = probes.smem_probe_plain(x)
    if dev.type == "cpu":
        ok = torch.equal(probes.smem_probe(x, 48 * 1024), want)
        print(f"  plain version: {'ok' if ok else 'WRONG'} (no shared memory on the CPU)")
        return [dict(label="smem_probe plain", device="cpu", ok=ok)]

    out: list[dict] = []
    largest, refused = 0, None
    for kib in SWEEP_KIB:
        nbytes = kib * 1024
        try:
            got = probes.smem_probe(x, nbytes)
        except probes.SharedMemoryRefused as e:  # the sweep's end is its result
            refused = nbytes
            print(f"  {kib} KiB: refused (CUDA error {e.code})", flush=True)
            out.append(dict(label=f"smem_probe {kib} KiB", device="cuda", bytes=nbytes, ok=False,
                            cuda_error=e.code))
            break
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"smem_probe: wrong output with {kib} KiB of shared memory")
        largest = nbytes
        print(f"  {kib} KiB: ok", flush=True)
        out.append(dict(label=f"smem_probe {kib} KiB", device="cuda", bytes=nbytes, ok=True))

    optin = probes.smem_optin_bytes()
    expect = max(k * 1024 for k in SWEEP_KIB if k * 1024 <= optin)
    need = max(PORT_SMEM_REQUESTS.values())
    print(f"max usable dynamic shared memory: {largest} bytes ({largest // 1024} KiB); the card "
          f"reports an opt-in maximum of {optin}; the port's kernels ask for up to {need}",
          flush=True)
    out.append(dict(label="smem_probe max", device="cuda", largest_bytes=largest,
                    first_refused_bytes=refused, optin_bytes=optin, port_needs_bytes=need))
    if largest < expect:
        raise AssertionError(f"smem_probe: {largest} bytes ran, the card reports {optin}")
    if largest < need:
        raise AssertionError(f"smem_probe: {largest} bytes ran, the port's kernels need {need}")
    return out


if __name__ == "__main__":
    main()
