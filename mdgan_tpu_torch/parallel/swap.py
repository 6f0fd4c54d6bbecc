"""Discriminator swaps across ranks (counterpart of ``mdgan_tpu/parallel/swap.py``
and of the ``swap`` dispatch at ``mdgan_tpu/engine/mdgan.py:543-570``).

Worker w takes worker perm[w]'s params and BN statistics, and its Adam
moments under ``swap_opt_state``.  Two forms, as in the JAX package:

  * **gather** (:func:`swap_gather`): every rank all-gathers the N
    discriminators' arenas and keeps its rows of ``perm``.  Any worker/rank
    ratio; in one process it is one gather along the worker axis of each
    arena (``NetState.permute_``).
  * **pair** (:func:`swap_pairs`, ``--swap_impl ppermute``): with one worker
    per rank, each rank sends its arenas to its partner and receives the
    partner's, point to point (``batch_isend_irecv``), with no all-gather
    fan-in.  ``perm`` must be an involution (random pairs, the only pattern
    the reference makes).

Both run over the mesh's workers axis (``core/mesh.py``): each group of
ranks with the same replica and tensor slot swaps on its own, so the
replicas stay equal.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from mdgan_tpu_torch.core import distributed
from mdgan_tpu_torch.core.mesh import RankLayout


def _arenas(net, with_opt_state: bool) -> List[Tuple[torch.Tensor, int]]:
    """The arenas a swap moves, each with its per-copy size (an empty stats
    arena, as MLP-GAN and StyleGAN2 have, moves nothing)."""
    out = [(net.params, net.numel), (net.stats, net.stat_numel)]
    if with_opt_state:
        out += [(net.mu, net.numel), (net.nu, net.numel)]
    return [(a, size) for a, size in out if size]


@torch.no_grad()
def swap_gather(net, perm: np.ndarray, layout: RankLayout, with_opt_state: bool = False) -> None:
    """The gather swap on this rank's copies of ``net``."""
    perm = np.asarray(perm, np.int64)
    if not layout.distributed:
        net.permute_(torch.as_tensor(perm, device=net.params.device), with_opt_state)
        return
    rows = torch.as_tensor(perm[layout.lo:layout.hi], device=net.params.device)
    for arena, size in _arenas(net, with_opt_state):
        full = distributed.all_gather_cat(arena, layout.worker_axis).view(layout.num_workers,
                                                                          size)
        arena.view(layout.per_rank, size).copy_(full[rows])


@torch.no_grad()
def swap_pairs(net, perm: np.ndarray, layout: RankLayout, with_opt_state: bool = False) -> None:
    """The pair swap: this rank's one worker trades its arenas with rank
    ``perm[rank]``."""
    import torch.distributed as dist

    perm = np.asarray(perm, np.int64)
    n = len(perm)
    axis = layout.worker_axis
    if not layout.distributed or axis.size != n:
        raise ValueError(
            f"pair swap needs one worker per rank: workers axis {axis.size} != {n} "
            "workers (use the gather swap instead)")
    if not np.array_equal(perm[perm], np.arange(n)):
        raise ValueError("swap permutation must be an involution (pairing)")
    r, w, t = layout.coords
    if perm[w] == w:
        return
    partner = layout.rank_of(r, int(perm[w]), t)
    ops, landed = [], []
    for arena, _ in _arenas(net, with_opt_state):
        # gloo sends from the host
        src = arena.cpu() if arena.is_cuda and dist.get_backend(axis.group) == "gloo" else arena
        buf = torch.empty_like(src)
        ops += [dist.P2POp(dist.isend, src, partner, axis.group),
                dist.P2POp(dist.irecv, buf, partner, axis.group)]
        landed.append((arena, buf))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for arena, buf in landed:
        arena.copy_(buf)
