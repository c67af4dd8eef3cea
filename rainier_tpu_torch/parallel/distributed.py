"""Multi-process start-up (port of rainier_tpu/parallel/distributed.py).

One process drives one device.  Call :func:`initialize` once per process
before building a mesh: it joins the process group, over NCCL when the
process's device is CUDA and gloo when it is the CPU, and pins the
rank's card, so that entry points (``config.resolve_device``) run on
``cuda:LOCAL_RANK``.  It reads either explicit arguments or torchrun's
environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``); with neither it does nothing, so the same entry point
runs alone or under ``torchrun --nproc_per_node=N``.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

from .. import config

log = logging.getLogger("rainier_tpu_torch")

_TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the process group when running multi-process; a no-op for
    single-process runs (and when the group already exists)."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        if not all(v in os.environ for v in _TORCHRUN):
            log.info("single-process run; skipping "
                     "torch.distributed.init_process_group")
            return
        init_method = "env://"
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and "
                             "process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        rank, world = int(process_id), int(num_processes)
    if torch.device(config.device()).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    log.info("torch.distributed initialized over %s: process %d/%d",
             backend, rank, world)


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
