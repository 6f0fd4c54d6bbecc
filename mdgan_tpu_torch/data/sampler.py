"""Per-worker batch-index sampling.

Copy of ``mdgan_tpu/data/sampler.py:1-73`` (its checkpoint helpers
come with checkpoints, ROADMAP.md A.3): each worker draws batches without
replacement from its shard and reshuffles when the shard is exhausted (the
reference worker's seeded DataLoader).  The sampler runs on the host and
emits (T, N, b) int32 index arrays, the same streams as the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SamplerState:
    perms: np.ndarray  # (N, S) int32 — current epoch permutation per worker
    pos: np.ndarray    # (N,)   int64 — cursor into each permutation
    epoch: np.ndarray  # (N,)   int64 — reshuffle generation per worker
    seed: int


class ShardSampler:
    """Without-replacement batch sampler over N equal shards of size S."""

    def __init__(self, num_workers: int, shard_size: int, batch_size: int, seed: int = 0):
        if batch_size > shard_size:
            raise ValueError(f"batch_size {batch_size} > shard size {shard_size}")
        self.n = num_workers
        self.s = shard_size
        self.b = batch_size
        self.state = SamplerState(
            perms=np.stack([self._perm(seed, w, 0) for w in range(num_workers)]),
            pos=np.zeros(num_workers, np.int64),
            epoch=np.zeros(num_workers, np.int64),
            seed=seed,
        )

    def _perm(self, seed: int, worker: int, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((seed, worker, epoch))
        return rng.permutation(self.s).astype(np.int32)

    def next_chunk(self, num_steps: int) -> np.ndarray:
        """Indices for the next ``num_steps`` rounds: (T, N, b) int32.

        A batch never straddles an epoch boundary: a tail shorter than b is
        dropped and a fresh permutation starts (``sampler.py:50-73``).
        """
        st = self.state
        out = np.empty((num_steps, self.n, self.b), np.int32)
        for w in range(self.n):
            pos, epoch, perm = int(st.pos[w]), int(st.epoch[w]), st.perms[w]
            for t in range(num_steps):
                if pos + self.b > self.s:
                    epoch += 1
                    perm = self._perm(st.seed, w, epoch)
                    pos = 0
                out[t, w] = perm[pos : pos + self.b]
                pos += self.b
            st.pos[w], st.epoch[w], st.perms[w] = pos, epoch, perm
        return out
