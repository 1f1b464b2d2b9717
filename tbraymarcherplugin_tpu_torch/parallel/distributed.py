"""Process-group initialization (multi-host and multi-GPU).

Counterpart of `tbraymarcherplugin_tpu/parallel/distributed.py`. One
process per GPU, joined by ``torch.distributed``: NCCL on the card, gloo
only where the caller names the CPU. The arguments come from the caller
or, with none given, from torchrun's environment (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``). Failure policy
is fail-fast: an init that was asked for and fails raises (the JAX package
logs and goes on), and a lost rank aborts the job, which resumes from the
latest checkpoint (`utils.checkpoint`).
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger("tbraymarcher.distributed")


def backend_for(device=None) -> str:
    """The collective backend of ``device``: "gloo" for the CPU, "nccl"
    for the card (the default); never gloo on the card."""
    return "gloo" if torch.device(device or "cuda").type == "cpu" else "nccl"


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         device=None) -> None:
    """Join the default process group (idempotent).

    ``coordinator_address`` is ``host:port`` (a TCP store on rank 0) or an
    init URL (``tcp://...``, ``file://...``); ``num_processes`` and
    ``process_id`` are the world size and this process's rank. Missing
    ones are read from torchrun's variables. Without a world larger than 1
    and without an explicit address there is nothing to join: a
    single-process run returns without a group, as in the JAX package. An
    explicit address asks for a group at any world size (a world-1 NCCL
    group on one card). ``device`` picks the backend (`backend_for`); on
    the card each process takes GPU ``LOCAL_RANK`` (else its rank modulo
    the GPUs on its host).
    """
    if dist.is_initialized():
        return
    env = os.environ
    world = num_processes if num_processes is not None else int(
        env.get("WORLD_SIZE", "1"))
    rank = process_id if process_id is not None else int(env.get("RANK", "0"))
    address = coordinator_address
    if address is None:
        if world <= 1:
            return  # single process: not an error
        address = f"{env.get('MASTER_ADDR', 'localhost')}:" \
                  f"{env.get('MASTER_PORT', '29500')}"
    url = address if "://" in address else f"tcp://{address}"
    backend = backend_for(device)
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", rank % max(torch.cuda.device_count(),
                                                     1)))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=url, world_size=world,
                            rank=rank)
    log.info("distributed initialized: rank %d/%d, backend %s", rank, world,
             backend)


def is_primary() -> bool:
    """Rank 0 of the default group, or True without a group."""
    return not dist.is_initialized() or dist.get_rank() == 0
