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
current device), and gloo for ``--device cpu``.  Where the local ranks
outnumber the cards (NCCL refuses two ranks on one device) it joins over
gloo, rank i on card ``i % cards``: every kernel still runs on the card, and
only the collectives pass through the host.  Without that environment it
does nothing, and the single-process run is unchanged.

The collectives of the mesh's axes (``core/mesh.py``) take an
:class:`~mdgan_tpu_torch.core.mesh.Axis` and do nothing where it is
inactive.  Under gloo a CUDA tensor is staged through the host, so every
collective runs on gloo's CPU path; values travel as float32 (bfloat16
activations and gradients widen exactly).  The differentiable ones
(``parallel/tensor.py``, the cross-replica BatchNorm of ``models/layers.py``):

  * :func:`all_reduce_sum`: forward and backward sum over the axis;
  * :func:`copy_to_group`: Megatron's identity whose backward sums the
    gradient over the axis (the input of a column-parallel layer);
  * :func:`gather` (and :func:`gather_rows`, along the batch): forward
    all-gathers along a dim, backward keeps this rank's slice.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

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
    from mdgan_tpu_torch.core.config import resolve_device

    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        local = int(os.environ["LOCAL_RANK"])
        torch.cuda.set_device(local % cards)
        if int(os.environ.get("LOCAL_WORLD_SIZE", "1")) <= cards:
            backend = "nccl"
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


def _host(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` contiguous and in float32, staged through the host where gloo
    would take it on the card."""
    import torch.distributed as dist

    t = t.float().contiguous()
    return t.cpu() if t.is_cuda and dist.get_backend(group) == "gloo" else t


def all_reduce_(t: torch.Tensor, axis) -> torch.Tensor:
    """Sum ``t`` over ``axis`` in place (nothing where it is inactive)."""
    import torch.distributed as dist

    if not axis.active:
        return t
    buf = _host(t, axis.group)
    dist.all_reduce(buf, group=axis.group)
    return t.copy_(buf)


def all_gather(t: torch.Tensor, axis) -> List[torch.Tensor]:
    """Every rank of ``axis``'s ``t``, in the axis's order, in ``t``'s dtype
    and device."""
    import torch.distributed as dist

    if not axis.active:
        return [t]
    buf = _host(t, axis.group)
    parts = [torch.empty_like(buf) for _ in range(axis.size)]
    dist.all_gather(parts, buf, group=axis.group)
    return [p.to(t.device, t.dtype) for p in parts]


def all_gather_cat(t: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
    """Every rank of ``axis``'s ``t``, concatenated in its order along ``dim``."""
    return torch.cat(all_gather(t, axis), dim)


def gather_cat(t: torch.Tensor, axis) -> Optional[torch.Tensor]:
    """Every rank of ``axis``'s ``t`` concatenated in its order on the axis's
    first rank; None on the others."""
    import torch.distributed as dist

    if not axis.active:
        return t
    buf = _host(t, axis.group)
    first = 0 if axis.group is None else dist.get_global_rank(axis.group, 0)
    parts: Optional[List[torch.Tensor]] = (
        [torch.empty_like(buf) for _ in range(axis.size)] if axis.index == 0 else None)
    dist.gather(buf, parts, dst=first, group=axis.group)
    return torch.cat(parts).to(t.device, t.dtype) if parts else None


# --- differentiable collectives ----------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce_(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.axis), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.axis), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, sizes):
        ctx.dim, ctx.start, ctx.size = dim, sum(sizes[:axis.index]), x.shape[dim]
        most = max(sizes)
        pad = list(x.shape)
        pad[dim] = most - x.shape[dim]
        parts = all_gather(torch.cat([x, x.new_zeros(pad)], dim) if pad[dim] else x, axis)
        return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, sizes)], dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.size), None, None, None


def all_reduce_sum(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` summed over ``axis``; its gradient is summed over it too."""
    return _AllReduceSum.apply(x, axis) if axis.active else x


def copy_to_group(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` itself; its gradient is summed over ``axis`` (the partial
    gradients of a column-parallel layer's input)."""
    return _CopyToGroup.apply(x, axis) if axis.active else x


def gather(x: torch.Tensor, axis, dim: int, sizes: Optional[Sequence[int]] = None
           ) -> torch.Tensor:
    """Every rank of ``axis``'s ``x`` concatenated along ``dim`` (``sizes``:
    each rank's extent there, when they differ); the gradient keeps this
    rank's slice."""
    if not axis.active:
        return x
    sizes = [x.shape[dim]] * axis.size if sizes is None else list(sizes)
    return _Gather.apply(x, axis, dim % x.dim(), sizes)


def gather_rows(x: torch.Tensor, axis, sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Every replica's rows of a batch, in replica order (dim 0)."""
    return gather(x, axis, 0, sizes)


def whole(p: torch.Tensor) -> torch.Tensor:
    """``p`` itself, or, for a parameter the tensor-parallel generator holds
    a slice of and uses elementwise (``parallel/tensor.py`` tags it with its
    axis), all of it, gathered along dim 0."""
    axis = getattr(p, "tensor_axis", None)
    return p if axis is None else gather(p, axis, 0)
