"""Joining a ``torch.distributed`` process group, and the collectives of the
sharded run (counterpart of ``mdgan_tpu/core/distributed.py:39-65``).

The JAX package calls ``jax.distributed.initialize`` and lets one SPMD
program span every chip.  Here each GPU is one process, started by
``torch.distributed.run``:

    python -m torch.distributed.run --standalone --nproc_per_node <cards> \\
        -m mdgan_tpu_torch.cli.train --mode mdgan ...

which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/
``MASTER_PORT``.  :func:`maybe_initialize` joins that group: NCCL on CUDA,
with each process on ``cuda:LOCAL_RANK`` (the kernels' wrappers check the
current device), and gloo for ``--device cpu``.  Without that environment it
does nothing, and the single-process run is unchanged.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")


def maybe_initialize(device: Optional[str] = None) -> bool:
    """Join the process group that ``torch.distributed.run``'s environment
    describes; returns whether this process is in one."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in ENV):
        return False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://")
    return True


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    """The process group's size; 1 outside one."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_main() -> bool:
    """Whether this process is rank 0, or not in a process group."""
    import torch.distributed as dist

    return world_size() == 1 or dist.get_rank() == 0


def all_gather_cat(t: torch.Tensor, world: int, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t``, concatenated in rank order along ``dim``."""
    import torch.distributed as dist

    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t)
    return torch.cat(parts, dim)


def gather_cat(t: torch.Tensor, world: int, rank: int) -> Optional[torch.Tensor]:
    """Every rank's ``t`` concatenated in rank order on rank 0; None on the
    others."""
    import torch.distributed as dist

    t = t.contiguous()
    parts: Optional[List[torch.Tensor]] = (
        [torch.empty_like(t) for _ in range(world)] if rank == 0 else None)
    dist.gather(t, parts, dst=0)
    return torch.cat(parts) if parts else None
