"""Build, load and count the hand-written Hopper kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own shared library
with a plain C interface (``build/kernels/lib<name>.so`` under the repository root) and
loaded with ``ctypes``. All sources compile in parallel, once, at the first launch of any
kernel (or at :func:`build`). Nothing here runs when a module is imported: the CPU tests
import every kernel module on machines without ``nvcc`` or a card.

Every wrapper adds one to its entry in :data:`LAUNCHES` where it launches its kernel and
nowhere else, so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "reset_launches", "build", "kernel", "check", "stream", "require"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("roll", "window_attention", "mlp", "resampler", "probes")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

LAUNCHES: dict[str, int] = {
    "roll3d": 0,
    "window_attention": 0,
    "mlp_adaln_residual": 0,
    "perceiver_core": 0,
    "linear_adaln_residual": 0,
    "window_attention_windowed": 0,
    "sdpa_windows": 0,
    "mlp_fused": 0,
    "perceiver_k_stats": 0,
    "mlp_t": 0,
    "attn_probe": 0,
    "attn5d_direct": 0,
    "gemm_blocked": 0,
    "smem_probe": 0,
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the toolkit")


def _stale(name: str) -> bool:
    so = BUILD_DIR / f"lib{name}.so"
    if not so.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))
    return so.stat().st_mtime < newest


def build(force: bool = False) -> float:
    """Compile every stale source in parallel (one ``nvcc`` each). Returns the seconds taken.

    The ``-Xptxas -v`` report (registers, shared memory, spills) of each source is kept
    beside its library as ``lib<name>.ptxas.txt``.
    """
    todo = [n for n in SOURCES if force or _stale(n)]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(BUILD_DIR / f"lib{n}.so"),
               str(CSRC / f"{n}.cu")]
        procs[n] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    failed = []
    for n, p in procs.items():
        out, _ = p.communicate()
        (BUILD_DIR / f"lib{n}.ptxas.txt").write_bytes(out)
        if p.returncode != 0:
            failed.append(f"{n}.cu:\n{out.decode(errors='replace')[-4000:]}")
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return time.perf_counter() - t0


def kernel(lib: str, fn: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``fn`` of ``lib<lib>.so``, built on first use."""
    with _lock:
        if lib not in _libs:
            if _stale(lib):
                build()
            _libs[lib] = ctypes.CDLL(str(BUILD_DIR / f"lib{lib}.so"))
    f = getattr(_libs[lib], fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError`` after the launch)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple | None = None) -> None:
    """Device, dtype, shape and contiguity checks every wrapper makes before a launch."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
