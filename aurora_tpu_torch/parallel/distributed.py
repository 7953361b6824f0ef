"""The multi-process runtime (port of ``aurora_tpu/parallel/distributed.py``).

Call :func:`initialize` once per process before building a mesh of more than one rank. It
brings up ``torch.distributed``: NCCL when every rank has a card of its own, gloo otherwise
(ranks that share one card, or the CPU). Nothing tells a process of a cluster, so a
multi-process run passes its topology: a coordinator address (``host:port``,
``tcp://host:port`` or ``file:///path`` of a ``FileStore``), the number of processes and
this process's index; or the environment ``torchrun`` sets (``WORLD_SIZE``, ``RANK``,
``MASTER_ADDR``, ``MASTER_PORT``).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

__all__ = ["initialize", "is_multi_host", "local_device_count", "process_summary",
           "rank_device"]


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def _local_size(num_processes: int) -> int:
    """The processes of this host: ``LOCAL_WORLD_SIZE`` where a launcher sets it, else all
    of them (one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))


def _default_backend(num_processes: int) -> str:
    """NCCL when every rank of this host has a card of its own, else gloo."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= _local_size(num_processes):
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, timeout_s: float = 600.0) -> None:
    """Initialise the process group (a no-op for a single process).

    With no arguments the topology comes from the environment ``torchrun`` sets, and a
    single process (no ``WORLD_SIZE`` above 1) initialises nothing. Ranks that share one
    card get gloo (NCCL refuses two ranks on one device). A second call is benign. A
    failure with explicit topology arguments raises: degrading to a single process would
    give every process a program of its own."""
    explicit = any(a is not None for a in (coordinator_address, num_processes, process_id))
    if dist.is_available() and dist.is_initialized():
        logger.info("distributed init skipped: already initialized")
        return
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(os.environ.get("RANK", 0))
    if num_processes <= 1:
        logger.info("distributed init skipped: a single process")
        return
    if coordinator_address is None:
        coordinator_address = "env://"
    backend = _default_backend(num_processes)
    try:
        if backend == "nccl":
            torch.cuda.set_device(process_id % _local_size(num_processes))
        dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                                world_size=num_processes, rank=process_id,
                                timeout=datetime.timedelta(seconds=timeout_s))
        logger.info("distributed runtime up: process %d/%d, backend %s", process_id,
                    num_processes, backend)
    except (ValueError, RuntimeError) as e:
        if explicit:
            raise
        logger.info("distributed init skipped: %s", e)


def is_multi_host() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def local_device_count() -> int:
    """The devices this process drives: one (its rank's) under a process group, else the
    cards it sees (one for the CPU)."""
    if is_multi_host():
        return 1
    return max(1, torch.cuda.device_count())


def rank_device(device: Optional[str] = None) -> torch.device:
    """The device of this rank: ``device`` as :func:`~aurora_tpu_torch.model.aurora.
    resolve_device` takes it (the card unless the caller asks for the CPU; no card raises),
    and under NCCL the rank's own card (gloo on one card: every rank on it)."""
    from aurora_tpu_torch.model.aurora import resolve_device

    dev = resolve_device(device)
    if (dev.type == "cuda" and dev.index is None and dist.is_available()
            and dist.is_initialized() and dist.get_backend() == "nccl"):
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def process_summary() -> dict:
    multi = is_multi_host()
    return {
        "process_index": dist.get_rank() if multi else 0,
        "process_count": dist.get_world_size() if multi else 1,
        "local_devices": local_device_count(),
        "global_devices": dist.get_world_size() if multi else local_device_count(),
    }
