"""Dataset partitioning across discriminator workers.

Copy of ``mdgan_tpu/data/partitioner.py:40-85``, the equal-shard split
the engine uses (numpy path only; the threaded native gather of
``mdgan_tpu/data/native`` is not ported).  IID splits a seeded permutation
into N chunks, non-IID splits ``arange(size)``; every shard is floored to
``size // n`` examples so the shards stack.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def permutation(size: int, iid: bool, seed: int = 0) -> np.ndarray:
    """The index order that gets chunked: seeded randperm (IID) or arange."""
    if iid:
        rng = np.random.default_rng(seed)
        return rng.permutation(size).astype(np.int64)
    return np.arange(size, dtype=np.int64)


def split_indices_equal(size: int, n: int, iid: bool, seed: int = 0) -> np.ndarray:
    """Equal-size split for the stacked layout: (n, size // n) int64."""
    if size < n:
        raise ValueError(f"dataset of {size} examples cannot feed {n} workers")
    shard = size // n
    idx = permutation(size, iid, seed)[: shard * n]
    return idx.reshape(n, shard)


def shard_data(data: np.ndarray, n: int, iid: bool, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(shards, indices): shards is (n, S, *data.shape[1:]) with
    S = len(data) // n; indices the (n, S) map back into ``data``."""
    idx = split_indices_equal(len(data), n, iid, seed)
    return data[idx.reshape(-1)].reshape(idx.shape + data.shape[1:]), idx
