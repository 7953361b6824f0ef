"""Real multi-process execution of the model over the mesh's data axis (counterpart of
``tools/multihost_sim.py``).

The launcher starts ``--data`` worker processes, each one rank of a process group brought up
by :func:`aurora_tpu_torch.parallel.initialize` over a ``FileStore`` in a temporary folder
(no fixed port: runs side by side do not collide), and meanwhile runs the same work in its
own process on the whole batch. Each worker builds ``AuroraSmallPretrained(use_lora=True)``
in float32 with the same weights (seeded from ``--seed`` on its device, or ``--params``, a
``save_params`` file), takes its slice of the batch (the JAX tool's draws, batch 2, on the
device's layout, :data:`LAYOUTS`; ``shard_batch_arrays``) and, under ``make_mesh(data=N)``:

1. runs ``forward_core`` and a one-step ``rollout`` and gathers each prediction
   (``gather_batch``);
2. takes one LoRA train step (``adamw(1e-4, trainable=lora_mask)``, zero targets), then one
   K = 2 roll-out train step;
3. from the same weights, takes one full fine-tune step under ``shard_params`` (ZeRO over
   ``data``) and gathers the updated parameters.

The launcher holds each against its one-process run: the forward, the LoRA step's averaged
gradients and the full step's ``encoder.surf_token_embeds.weights.2t`` (the JAX test's
probe) within 1e-5 max-rel, the roll-out step's averaged gradients within
:data:`ROLLOUT_GRAD_TOL`, the losses within 1e-6 relative; each rank's AdamW
moments of a split parameter are 1/N of it; ``replicate`` gives every rank the first rank's
values. The LoRA step's parameters are held within 1e-5 where the gradient is resolved:
AdamW's first update is about ``lr * sign(gradient)``, so an element whose gradient is
rounding noise moves either way when the sums are taken in another order (the worst element
over all of them is printed beside, and so is the full step's worst parameter). Beside each
gradient check it prints what the check would read had rank 0 skipped the average (its own
gradient, recorded as the backward accumulates it, against the one-process gradient): the
reading of a fault, which the bound must lie far below. It prints one JSON line and exits
non-zero on a failed check.

The ranks run on the card (every rank on the one card, over gloo: NCCL refuses two ranks on
one device) unless ``--device cpu`` asks for the CPU. The batch's layout follows the device:
the JAX tool's 4 levels at 33 x 64 on the CPU, 13 levels at 121 x 240 on the card, whose
level aggregation kernel takes 13 levels and whose window kernels take whole 144-token
windows, which the smallest stage of a 33 x 64 grid cannot hold. The JAX tool's default
layout, ``lat=2, lon=4``, splits the token grid: that waits for ROADMAP A4b, and ``--lat`` /
``--lon`` above 1 say so.

Usage: ``python -m aurora_tpu_torch.tools.multihost_sim [--data 2] [--device cpu|cuda]
[--seed S] [--params FILE] [--depths D] [--save FILE]``; ``--depths`` cuts every stage to
``D`` blocks, ``--save`` writes every result (``torch.save``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from aurora_tpu_torch.model.aurora import resolve_device
from aurora_tpu_torch.training import AdamW

__all__ = ["FORWARD_TOL", "LAYOUTS", "LOSS_TOL", "PARAM_TOL", "ROLLOUT_GRAD_TOL",
           "RecordingAdamW", "collect", "compare", "make_inputs", "ready_host", "release",
           "result", "run", "spawn_workers", "main"]

B = 2
# The batch's pressure levels and grid by device type: the JAX tool's 4 levels at 33 x 64 on
# the CPU; on the card the main path's 13 (its level aggregation kernel takes 13) at 121 x 240
# (its window kernels take whole 144-token windows).
LAYOUTS = {"cpu": ((100, 250, 500, 850), (33, 64)),
           "cuda": ((50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000),
                    (121, 240))}
LR = 1e-4
FORWARD_TOL = PARAM_TOL = 1e-5  # max-rel, the JAX tool's and tests/test_parallel.py's
LOSS_TOL = 1e-6  # relative
# The roll-out step's gradients (max-rel). Readings (PERF.md; ``--seed`` 0-2): at most 1.12e-5
# on the card and 1.10e-5 on the CPU, against 5.5e-2 or more where rank 0 skips the average.
ROLLOUT_GRAD_TOL = 1e-4
RESOLVED = 1e-6  # the least |gradient| whose AdamW update the parameter check compares
PROBE = "encoder.surf_token_embeds.weights.2t"
ROLLOUT_K = 2  # steps of the roll-out train step
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_inputs(device_type: str = "cpu", seed: int = 0):
    """The JAX tool's batch (``tests/conftest.py::make_batch(H=33, W=64, B=2,
    dtype=np.float32)``: the same draws in the same order), as a port :class:`Batch`, on the
    layout of ``device_type`` (:data:`LAYOUTS`)."""
    LEVELS, (H, W) = LAYOUTS[device_type]
    from aurora_tpu_torch.batch import Batch, Metadata
    from aurora_tpu_torch.normalisation import NORMALISATION_STATS, level_to_str

    rng = np.random.default_rng(seed)

    def sample(name, shape):
        loc, scale = NORMALISATION_STATS.get(name, (0.0, 1.0))
        return (loc + scale * rng.standard_normal(shape)).astype(np.float32)

    def sample_atmos(name, shape):
        out = np.empty(shape, dtype=np.float32)
        for i, lvl in enumerate(LEVELS):
            loc, scale = NORMALISATION_STATS[f"{name}_{level_to_str(lvl)}"]
            out[..., i, :, :] = loc + scale * rng.standard_normal((*shape[:-3], *shape[-2:]))
        return out

    return Batch(
        surf_vars={k: torch.from_numpy(sample(k, (B, 2, H, W)))
                   for k in ("2t", "10u", "10v", "msl")},
        static_vars={k: torch.from_numpy(np.abs(sample(k, (H, W)))) for k in ("lsm", "z", "slt")},
        atmos_vars={k: torch.from_numpy(sample_atmos(k, (B, 2, len(LEVELS), H, W)))
                    for k in ("z", "u", "v", "t", "q")},
        metadata=Metadata(lat=np.linspace(90, -90, H), lon=np.linspace(0, 360, W, endpoint=False),
                          time=tuple(datetime(2020, 6, 1, 12) for _ in range(B)),
                          atmos_levels=LEVELS, rollout_step=0),
    )


def build(device, params: Optional[str], depths: Optional[int], seed: int = 0):
    """The model every rank builds: ``AuroraSmallPretrained(use_lora=True)`` in float32,
    its weights from ``params`` or seeded from ``seed`` on ``device`` (N(0, 0.02), LayerNorms
    at 1 and 0, FiLM and LoRA ``B`` at N(0, 0.05))."""
    from aurora_tpu_torch.checkpoint import restore_params
    from aurora_tpu_torch.model.aurora import AuroraSmallPretrained
    from aurora_tpu_torch.model.nn import LayerNorm

    cut = {} if depths is None else dict(encoder_depths=(depths,) * 3,
                                          decoder_depths=(depths,) * 3)
    model = AuroraSmallPretrained(device=device, seed=None, use_lora=True, **cut)
    if params is not None:
        return restore_params(params, like=model)
    norms = {f"{m}.{k}" for m, mod in model.named_modules() if isinstance(mod, LayerNorm)
             for k in ("weight", "bias")}
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in norms:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
                continue
            gate = ("modulation" in name and name.endswith("weight")) or name.endswith(".B")
            p.copy_(torch.randn(p.shape, generator=g, device=device) * (0.05 if gate else 0.02))
    return model


class RecordingAdamW(AdamW):
    """AdamW that keeps a copy of the (averaged) gradients it applies (``grads``) and of each
    gradient as the backward left it on this rank, before any average (``local``)."""

    def init(self, model: torch.nn.Module) -> "RecordingAdamW":
        super().init(model)
        self.local: dict = {}
        self._hooks = [p.register_post_accumulate_grad_hook(self._keep) for p in self.params]
        return self

    def _keep(self, p) -> None:
        self.local[p] = p.grad.detach().clone()

    def step(self) -> None:
        self.grads = {p: p.grad.detach().cpu().clone() for p in self.params}
        self.local = {p: g.cpu() for p, g in self.local.items()}
        for h in self._hooks:
            h.remove()
        super().step()


def run(device, mesh=None, params: Optional[str] = None, depths: Optional[int] = None,
        seed: int = 0) -> dict:
    """The forward, the LoRA step and the full fine-tune step on this rank's slice under
    ``mesh`` (a data mesh), or on the whole batch without one. Returns what the launcher
    compares: the whole forward, the losses, the updated parameters (whole) and, under the
    mesh, the size of each split parameter and of its AdamW moments on this rank."""
    import contextlib

    from aurora_tpu_torch.parallel import gather_batch, gathered_params, shard_batch_arrays
    from aurora_tpu_torch.parallel import shard_params
    from aurora_tpu_torch.rollout import rollout
    from aurora_tpu_torch.training import (
        adamw,
        lora_mask,
        make_rollout_train_step,
        make_train_step,
    )

    t0 = time.perf_counter()
    times = {}
    model = build(device, params, depths, seed)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = make_inputs(device.type, seed).crop(model.cfg.patch_size)
    enc = model.prepare_encodings(batch, torch.float32)
    atmos_levels = tuple(float(x) for x in batch.metadata.atmos_levels)
    whole = batch.to(device, torch.float32)
    if mesh is not None:
        surf, static, atmos = shard_batch_arrays(whole.surf_vars, whole.static_vars,
                                                 whole.atmos_vars, mesh)
    else:
        surf, static, atmos = whole.surf_vars, whole.static_vars, whole.atmos_vars
    Hc, Wc = batch.spatial_shape
    tgt_s = {k: torch.zeros((B, Hc, Wc), device=device) for k in model.cfg.surf_vars}
    tgt_a = {k: torch.zeros((B, len(atmos_levels), Hc, Wc), device=device)
             for k in model.cfg.atmos_vars}
    scope = mesh if mesh is not None else contextlib.nullcontext()
    out: dict = {}
    with scope:
        with torch.no_grad():
            ps, pa = model.forward_core(surf, static, atmos, enc, 0, atmos_levels)
        out["forward"] = {k: v.cpu() for k, v in {**gather_batch(ps), **gather_batch(pa)}.items()}
        # ``rollout`` (``Aurora.forward``) on this rank's part of the batch: its first step.
        part = dataclasses.replace(batch, surf_vars=surf, static_vars=static, atmos_vars=atmos)
        pred = next(rollout(model, part, 1))
        out["rollout_forward"] = {k: v.cpu() for k, v in gather_batch(
            {**pred.surf_vars, **pred.atmos_vars}).items()}
        times["forward"] = time.perf_counter() - t0

        opt = RecordingAdamW(LR, 0.0, 1, lora_mask)
        step = make_train_step(model, opt, atmos_levels)
        out["lora_loss"] = float(step(surf, static, atmos, enc, 0, tgt_s, tgt_a))
        names = {p: n for n, p in model.named_parameters()}
        out["lora_grads"] = {names[p]: g for p, g in opt.grads.items()}
        out["lora_local_grads"] = {names[p]: g for p, g in opt.local.items()}
        out["lora_params"] = {names[p]: p.detach().cpu().clone() for p in opt.grads}
        times["lora_step"] = time.perf_counter() - t0

        # A K = 2 roll-out step of the LoRA model from where the LoRA step left it.
        opt = RecordingAdamW(LR, 0.0, 1, lora_mask)
        step = make_rollout_train_step(model, opt, atmos_levels, ROLLOUT_K)
        abs_t = torch.stack([model.step_encodings(
            [t + i * model.cfg.timestep for t in batch.metadata.time], torch.float32)[0]
            for i in range(ROLLOUT_K)])
        out["rollout_loss"] = float(step(
            surf, static, atmos, enc, abs_t, 0,
            {k: torch.stack([v] * ROLLOUT_K) for k, v in tgt_s.items()},
            {k: torch.stack([v] * ROLLOUT_K) for k, v in tgt_a.items()}))
        out["rollout_grads"] = {names[p]: g for p, g in opt.grads.items()}
        out["rollout_local_grads"] = {names[p]: g for p, g in opt.local.items()}
        times["rollout_step"] = time.perf_counter() - t0

        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(init[n])
                p.requires_grad_(True)
        out["probe_init"] = init[PROBE].cpu()
        del init
        if mesh is not None:
            shard_params(model, mesh)
        opt = adamw(LR)
        step = make_train_step(model, opt, atmos_levels)
        out["full_loss"] = float(step(surf, static, atmos, enc, 0, tgt_s, tgt_a))
        zp = getattr(model, "_zero_placement", None)
        if zp is not None:
            params = dict(model.named_parameters())
            out["split"] = {n: dict(param=int(np.prod(shape)), slice=params[n].numel(),
                                    moments=[opt.opt.state[params[n]][m].numel()
                                             for m in ("exp_avg", "exp_avg_sq")])
                            for n, (ax, shape) in zp.split.items()}
        with gathered_params(model):
            out["full_params"] = {n: p.detach().cpu().clone()
                                  for n, p in model.named_parameters()}
        times["full_step"] = time.perf_counter() - t0
    out["seconds"] = times
    return out


def spawn_workers(n: int, folder: str, device: str, params: Optional[str] = None,
                  depths: Optional[int] = None, seed: int = 0,
                  hold: bool = False) -> list[subprocess.Popen]:
    """Start ``n`` worker processes on ``device`` ("cpu" or "cuda") whose process group
    meets in a ``FileStore`` under ``folder``; each writes ``rank<i>.pt`` there
    (:func:`collect`). With ``hold`` each makes its host side ready (:func:`ready_host`) and
    then waits for :func:`release` before it touches the device."""
    env = dict(os.environ, OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "2"))
    store = os.path.join(folder, "store")
    cmd = [sys.executable, "-m", "aurora_tpu_torch.tools.multihost_sim", "--role", "worker",
           "--data", str(n), "--store", store, "--device", device, "--seed", str(seed)]
    cmd += ["--params", params] if params else []
    cmd += ["--depths", str(depths)] if depths else []
    cmd += ["--hold"] if hold else []
    return [subprocess.Popen(cmd + ["--rank", str(i)], cwd=ROOT, env=env) for i in range(n)]


def release(folder: str) -> None:
    """Let the held workers of ``folder`` go on."""
    with open(os.path.join(folder, "go"), "w"):
        pass


def ready_host() -> None:
    """Do ahead the host-side work that a process's first train step does once: AdamW's
    first step imports torch's compiler stack (seconds of host time), here on a CPU
    tensor."""
    p = torch.zeros(1, requires_grad=True)
    p.grad = torch.zeros(1)
    torch.optim.AdamW([p]).step()


def collect(procs: list[subprocess.Popen], folder: str, timeout: float = 900) -> list[dict]:
    """Wait for the workers and read each rank's results; raise where one failed."""
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(rcs):
        raise RuntimeError(f"worker exit codes {rcs}")
    return [torch.load(os.path.join(folder, f"rank{i}.pt"), weights_only=False)
            for i in range(len(procs))]


def worker(rank: int, n: int, store: str, args) -> None:
    from aurora_tpu_torch.ops import _lib
    from aurora_tpu_torch.parallel import initialize, make_mesh, process_summary, replicate

    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "2")))
    if args.hold:  # until released; a worker whose launcher is gone stops
        ready_host()
        go, parent = os.path.join(os.path.dirname(store), "go"), os.getppid()
        while not os.path.exists(go):
            if os.getppid() != parent:
                raise SystemExit("multihost_sim worker: the launcher is gone")
            time.sleep(0.05)
    initialize(coordinator_address=f"file://{store}", num_processes=n, process_id=rank)
    mesh = make_mesh(data=n, device=args.device)
    out = run(mesh.device, mesh, args.params, args.depths, args.seed)
    out["summary"] = process_summary()
    # ``replicate`` broadcasts the first rank's values: every rank ends with rank 0's.
    mine = torch.full((4,), float(rank), device=mesh.device)
    out["replicated"] = replicate({"x": mine}, mesh)["x"].tolist()
    out["launches"] = {k: v for k, v in _lib.LAUNCHES.items() if v}
    out["backend"] = torch.distributed.get_backend()
    if rank:  # the whole results are the same on every rank; the first one keeps them
        out = {k: out[k] for k in ("split", "summary", "backend", "seconds", "full_loss",
                                   "launches", "replicated")}
    torch.save(out, os.path.join(os.path.dirname(store), f"rank{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def _max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / (a.abs().max() + 1e-30))


def compare(ref: dict, ranks: list[dict]) -> dict:
    """The checks of the data-parallel results ``ranks`` (rank 0's whole, the others' split
    sizes) against the one-process run ``ref``."""
    got = ranks[0]
    n = len(ranks)
    fwd = max(_max_rel(ref[f][k], got[f][k]) for f in ("forward", "rollout_forward")
              for k in ref[f])

    def worst(step: str, kind: str = "grads") -> float:
        want = ref[f"{step}_grads"]
        return max(_max_rel(want[k], got[f"{step}_{kind}"][k]) for k in want)

    grad, rollout_grad = worst("lora"), worst("rollout")
    # AdamW's first update of an element is about lr * g / (|g| + 1e-8): where |g| is
    # rounding noise its sign is too, so the parameter check takes the elements whose
    # gradient is resolved (|g| >= RESOLVED in the one-process run).
    resolved = {k: ref["lora_grads"][k].abs() >= RESOLVED for k in ref["lora_grads"]}
    lora = max(_max_rel(ref["lora_params"][k] * m, got["lora_params"][k] * m)
               for k, m in resolved.items())
    lora_all = max(_max_rel(ref["lora_params"][k], got["lora_params"][k])
                   for k in ref["lora_params"])
    full = {k: _max_rel(ref["full_params"][k], got["full_params"][k])
            for k in ref["full_params"]}
    loss = {m: abs(got[m] - ref[m]) / abs(ref[m])
            for m in ("lora_loss", "rollout_loss", "full_loss")}
    split_ok = all(s["slice"] * n == s["param"] and all(m == s["slice"] for m in s["moments"])
                   for r in ranks for s in r["split"].values())
    losses_agree = all(r["full_loss"] == got["full_loss"] for r in ranks)
    replicated = all(r["replicated"] == [0.0] * 4 for r in ranks)
    ok = (fwd <= FORWARD_TOL and grad <= PARAM_TOL and lora <= PARAM_TOL
          and rollout_grad <= ROLLOUT_GRAD_TOL
          and full[PROBE] <= PARAM_TOL
          and max(loss.values()) <= LOSS_TOL and split_ok and losses_agree and replicated
          and len(got["split"]) > 0)
    return dict(forward_max_rel=fwd, lora_grad_max_rel=grad,
                rollout_grad_max_rel=rollout_grad,
                # What the gradient checks read had rank 0 skipped the average: a fault.
                lora_grad_unaveraged_max_rel=worst("lora", "local_grads"),
                rollout_grad_unaveraged_max_rel=worst("rollout", "local_grads"),
                lora_param_max_rel=lora,
                lora_param_max_rel_all=lora_all,
                lora_unresolved=sum(int((~m).sum()) for m in resolved.values()),
                full_param_max_rel=max(full.values()), probe=PROBE,
                probe_max_rel=full[PROBE], loss_rel=loss,
                losses=dict(lora=got["lora_loss"], rollout=got["rollout_loss"],
                            full=got["full_loss"]),
                split_params=len(got["split"]),
                split_fraction=sum(s["param"] for s in got["split"].values())
                / sum(v.numel() for v in ref["full_params"].values()),
                moments_are_slices=split_ok, ranks_agree_on_loss=losses_agree,
                replicate_from_rank0=replicated,
                tol=dict(forward=FORWARD_TOL, params=PARAM_TOL, loss=LOSS_TOL,
                         rollout_grads=ROLLOUT_GRAD_TOL), ok=ok)


def result(ref: dict, ranks: list[dict], device: str, seconds: float) -> dict:
    """The tool's JSON line: :func:`compare`'s checks and what each rank ran."""
    n = len(ranks)
    return dict(metric="multihost_sim", processes=n, mesh=dict(data=n, lat=1, lon=1),
                device=device, backend=ranks[0]["backend"],
                process_summary=ranks[0]["summary"], **compare(ref, ranks),
                launches_per_rank=[r["launches"] for r in ranks],
                seconds=dict(total=seconds, reference=ref["seconds"],
                             rank0=ranks[0]["seconds"]))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--role", default="launcher", choices=["launcher", "worker"])
    ap.add_argument("--data", type=int, default=2, help="processes, one a rank of data")
    ap.add_argument("--lat", type=int, default=1)
    ap.add_argument("--lon", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--store", default="")
    ap.add_argument("--hold", action="store_true")
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"],
                    help="the card by default; cpu runs the kernels' plain versions")
    ap.add_argument("--seed", type=int, default=0, help="of the weights and the batch")
    ap.add_argument("--params", default=None, help="a save_params file of the model")
    ap.add_argument("--depths", type=int, default=None, help="blocks in every stage")
    ap.add_argument("--save", default=None, help="write every result to this file")
    args = ap.parse_args(argv)
    if args.lat > 1 or args.lon > 1:
        ap.error(f"lat = {args.lat}, lon = {args.lon} split the token grid, which is not "
                 "ported yet (ROADMAP A4b; the JAX tool's default layout is lat=2, lon=4): "
                 "run the data axis, --data N")
    if args.role == "worker":
        worker(args.rank, args.data, args.store, args)
        return {}
    return launch(args)


def launch(args) -> dict:
    t0 = time.perf_counter()
    device = resolve_device(args.device)
    if device.type == "cuda":
        from aurora_tpu_torch.ops import _lib

        _lib.build()  # once, before the workers load the libraries
    with tempfile.TemporaryDirectory(prefix="multihost_sim_") as folder:
        procs = spawn_workers(args.data, folder, device.type, args.params, args.depths,
                              args.seed)
        try:
            ref = run(device, None, args.params, args.depths, args.seed)
        finally:
            ranks = collect(procs, folder)
    res = result(ref, ranks, device.type, time.perf_counter() - t0)
    if args.save:
        torch.save(dict(result=res, reference=ref, rank0=ranks[0]), args.save)
    print(json.dumps(res), flush=True)
    if not res["ok"]:
        raise SystemExit(f"multihost_sim: a check failed: {json.dumps(res)}")
    return res


if __name__ == "__main__":
    main()
