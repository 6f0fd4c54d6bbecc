"""The rank layout of the discriminators (port of ``mdgan_tpu/core/mesh.py:23-63``).

The JAX package lays the stacked discriminators over the ``workers`` axis
of a device mesh.  Here that axis is the ``torch.distributed`` world: with
W ranks and N discriminators, rank r holds the N/W workers of global ids
``[r*N/W, (r+1)*N/W)``, their data shards and their Adam state, and every
rank holds the generator.  Without a process group the layout is one rank
holding all N, the single-process run.

Not ported yet (ROADMAP.md A.8b): the replica and tensor axes, and JAX's
fallback to the largest divisor of N when the device count does not divide
it, leaving devices idle (``mesh.py:47-61``); here a world size that does
not divide N raises.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """Which of the N workers this process holds."""

    num_workers: int
    world: int = 1
    rank: int = 0
    # True under an initialized process group (even at world size 1): the
    # round then sums its cotangents over the group
    distributed: bool = False

    @property
    def per_rank(self) -> int:
        return self.num_workers // self.world

    @property
    def lo(self) -> int:
        return self.rank * self.per_rank

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


def rank_layout(num_workers: int, num_replicas: int = 1, num_tensor: int = 1) -> RankLayout:
    """The layout of ``num_workers`` discriminators over the current
    ``torch.distributed`` group (one rank without one)."""
    import torch.distributed as dist

    if num_replicas > 1 or num_tensor > 1:
        raise NotImplementedError(
            "--num_replicas/--num_tensor > 1 (the replica axis with cross-rank "
            "BatchNorm statistics, the tensor axis for G) is not ported to "
            "mdgan_tpu_torch yet (ROADMAP.md A.8b)")
    if not (dist.is_available() and dist.is_initialized()):
        return RankLayout(num_workers)
    world, rank = dist.get_world_size(), dist.get_rank()
    if num_workers % world != 0:
        raise ValueError(f"num_workers={num_workers} must be divisible by the world "
                         f"size {world} (each rank holds N/W discriminators)")
    return RankLayout(num_workers, world, rank, distributed=True)
