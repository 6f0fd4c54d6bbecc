"""The rank layout of the mesh (port of ``mdgan_tpu/core/mesh.py:23-106``).

The JAX package lays its devices out as a (replica, workers[, tensor]) grid,
the tensor axis innermost (``make_mesh``).  Here each device is one
``torch.distributed`` rank, and rank ``(r * W + w) * T + t`` sits at
replica r, worker slot w and tensor slot t, JAX's device-grid order:

  * **workers** (W): the N stacked discriminators, N/W a slot, with their
    data shards and Adam state;
  * **replica** (R): data parallelism inside each worker: every
    discriminator's batch of b rows and the generator's k*b rows are split
    over the R replicas, BatchNorm statistics are taken over the whole batch
    (``models/layers.py``), and gradients are summed over the replicas;
  * **tensor** (T): the generator's column parallelism
    (``parallel/tensor.py``): every leaf whose JAX trailing dim T divides is
    split over the T slots, with its Adam moments.

As in ``make_mesh``, the world must be a multiple of R*T, and the workers
axis takes the largest divisor of N that fits in world/(R*T); the ranks past
R*W*T are idle, with a warning.  Every rank, idle ones included, creates the
process groups of the three axes, in the same order.  Without a process
group the layout is one rank holding all N, the single-process run, and the
replica and tensor flags are ignored, as JAX ignores them on one device.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Tuple

log = logging.getLogger("mdgan_tpu_torch")


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as a rank sees it: its size, the rank's index on it, and
    whether its collectives run, over ``group`` (None: the default group)."""

    size: int = 1
    index: int = 0
    group: Any = None
    active: bool = False


def mesh_shape(world: int, num_workers: int, num_replicas: int = 1,
               num_tensor: int = 1) -> Tuple[int, int, int]:
    """(R, W, T) of ``world`` ranks, as ``make_mesh`` (``mesh.py:40-61``)
    sizes its axes: raises when R*T does not divide the world, and gives the
    workers axis the largest divisor of N that fits."""
    r, t = num_replicas, num_tensor
    if r < 1 or t < 1:
        raise ValueError(f"num_replicas={r} and num_tensor={t} must be at least 1")
    if world % (r * t) != 0:
        raise ValueError(f"{world} devices not divisible by num_replicas={r} "
                         f"* num_tensor={t}")
    w = world // (r * t)
    while num_workers % w != 0:
        w -= 1
    return r, w, t


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """Where this process sits in the mesh, and which of the N workers it
    holds."""

    num_workers: int
    world: int = 1
    rank: int = 0
    # True under an initialized process group (even at world size 1): the
    # round then sums its cotangents over the workers axis
    distributed: bool = False
    num_replicas: int = 1
    num_tensor: int = 1
    # the process groups of the axes, by name (rank_layout makes them)
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict, compare=False,
                                               repr=False)

    @property
    def shape(self) -> Tuple[int, int, int]:
        """(R, W, T)."""
        return mesh_shape(self.world, self.num_workers, self.num_replicas, self.num_tensor)

    @property
    def used(self) -> int:
        r, w, t = self.shape
        return r * w * t

    @property
    def idle(self) -> bool:
        """A rank past the mesh: it holds nothing and runs no round."""
        return self.rank >= self.used

    @property
    def coords(self) -> Tuple[int, int, int]:
        """(replica, worker slot, tensor slot) of this rank."""
        _, w, t = self.shape
        return self.rank // (w * t), (self.rank // t) % w, self.rank % t

    def rank_of(self, replica: int, worker: int, tensor: int) -> int:
        _, w, t = self.shape
        return (replica * w + worker) * t + tensor

    def _axis(self, name: str, i: int) -> Axis:
        size, index = self.shape[i], self.coords[i]
        if name in self.groups:
            group = self.groups[name]
            return Axis(size, index, group, group is not None)
        # no group made: the workers axis of a distributed run over the
        # whole world is the default group
        whole = name == "workers" and self.distributed and size == self.world
        return Axis(size, index, None, whole)

    @property
    def replica_axis(self) -> Axis:
        return self._axis("replica", 0)

    @property
    def worker_axis(self) -> Axis:
        return self._axis("workers", 1)

    @property
    def tensor_axis(self) -> Axis:
        return self._axis("tensor", 2)

    @property
    def per_rank(self) -> int:
        return self.num_workers // self.shape[1]

    @property
    def lo(self) -> int:
        return self.coords[1] * self.per_rank

    @property
    def hi(self) -> int:
        return self.lo + self.per_rank

    @property
    def workers(self) -> range:
        """The global ids of this rank's workers."""
        return range(self.lo, self.hi)

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def _axis_groups(lay: RankLayout) -> Dict[str, Any]:
    """Every group of every axis, made by every rank in the same order
    (``new_group`` is collective); this rank's group of each axis, or None
    where the axis has one slot (it needs no collective)."""
    import torch.distributed as dist

    nr, nw, nt = lay.shape
    r0, w0, t0 = lay.coords if not lay.idle else (-1, -1, -1)
    out: Dict[str, Any] = {}
    if nr == 1 and nt == 1 and lay.used == lay.world:
        return out  # the workers axis is the whole world, the default group
    # (axis, its size, the rank at slot i of the group (a, b), this rank's
    # group, the number of groups a and b)
    axes = (("workers", nw, lambda i, a, b: lay.rank_of(a, i, b), (r0, t0), nr, nt),
            ("replica", nr, lambda i, a, b: lay.rank_of(i, a, b), (w0, t0), nw, nt),
            ("tensor", nt, lambda i, a, b: lay.rank_of(a, b, i), (r0, w0), nr, nw))
    for name, size, rank_at, mine, n_a, n_b in axes:
        out[name] = None
        if size == 1:
            continue
        for a in range(n_a):
            for b in range(n_b):
                ranks = [rank_at(i, a, b) for i in range(size)]
                group = dist.new_group(ranks)
                if (a, b) == mine:
                    out[name] = group
    return out


def rank_layout(num_workers: int, num_replicas: int = 1, num_tensor: int = 1) -> RankLayout:
    """The layout of the current ``torch.distributed`` group (one rank
    without one), with its axes' process groups; every rank must call it."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        if num_replicas > 1 or num_tensor > 1:
            log.info("--num_replicas %d --num_tensor %d ignored: one process holds the "
                     "whole run, as JAX ignores them on one device", num_replicas, num_tensor)
        return RankLayout(num_workers)
    world, rank = dist.get_world_size(), dist.get_rank()
    lay = RankLayout(num_workers, world, rank, distributed=True,
                     num_replicas=num_replicas, num_tensor=num_tensor)
    if lay.used < world:
        log.warning("mesh uses %d of %d devices (%d workers not divisible by the "
                    "worker-axis size); %d devices idle", lay.used, world, num_workers,
                    world - lay.used)
    return dataclasses.replace(lay, groups=_axis_groups(lay))
