"""Everything a run feeds the program and the reference, made from ``--seed``.

Each stream has its own generator, keyed by (seed, stream, index) through
numpy's ``SeedSequence``, so any part can be made again on its own (the
reference remakes the first rounds' inputs after the window) and every rank
of a sharded run makes the same values for the same keys.  Device tensors
come from a ``torch.Generator`` on the run's device, in a few large calls.

* weights: a network's leaves in one ``randn`` call, each leaf then scaled
  and shifted by its init rule (``("normal", mean, std)`` or
  ``("const", value)``, from the family module);
* images: a worker's shard of uint8 pixels, ``(S, H, W, C)``, one
  ``random_`` call;
* indices: per worker an epoch permutation of its shard, batches taken in
  order without replacement, a new permutation when a batch no longer fits
  (so the rows of the first rounds all differ);
* latents: a chunk's ``(T, k*b, z_dim)`` normals;
* noise: where the family declares ``noise_shapes(cfg)``, a chunk's
  generator noise, one ``(T, k*b, *shape)`` tensor of normals a declared
  input, each input its own generator.  Its tag comes after the others, so
  a family with noise changes no other stream's values.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# stream tags: a new stream is appended, so every existing one keeps its number
WEIGHTS_G, WEIGHTS_D, IMAGES, INDICES, LATENTS, NOISE = range(6)


def key(seed: int, *path: int) -> int:
    """A 64-bit generator seed for (seed, *path)."""
    return int(np.random.SeedSequence([seed % 2 ** 64, *path]).generate_state(1, np.uint64)[0])


def generator(device, seed: int, *path: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(key(seed, *path))


def weights(leaves: Sequence[Tuple[str, tuple, tuple]], device, seed: int,
            *path: int) -> Dict[str, torch.Tensor]:
    """One network's float32 leaves by name, drawn as one ``randn`` call."""
    sizes = [int(np.prod(shape)) for _, shape, _ in leaves]
    flat = torch.randn(sum(sizes), generator=generator(device, seed, *path), device=device)
    out = {}
    for (name, shape, init), part in zip(leaves, flat.split(sizes)):
        if init[0] == "normal":
            out[name] = part.mul_(init[2]).add_(init[1]).view(shape)
        elif init[0] == "const":
            out[name] = part.fill_(init[1]).view(shape)
        else:
            raise ValueError(f"{name}: unknown init {init!r}")
    return out


def shard(device, seed: int, worker: int, size: int, image_shape: Sequence[int],
          out: torch.Tensor = None) -> torch.Tensor:
    """Worker ``worker``'s (size, H, W, C) uint8 pixels (into ``out``)."""
    if out is None:
        out = torch.empty((size, *image_shape), dtype=torch.uint8, device=device)
    return out.random_(0, 256, generator=generator(device, seed, IMAGES, worker))


class Sampler:
    """(T, N, b) int32 batch indices: each worker's batches without
    replacement from an epoch permutation of its shard."""

    def __init__(self, seed: int, num_workers: int, shard_size: int, batch_size: int):
        if batch_size > shard_size:
            raise ValueError(f"batch_size {batch_size} > shard size {shard_size}")
        self.seed, self.n, self.s, self.b = seed, num_workers, shard_size, batch_size
        self.pos = [0] * num_workers
        self.epoch = [0] * num_workers
        self.perm = [self._perm(w, 0) for w in range(num_workers)]

    def _perm(self, worker: int, epoch: int) -> np.ndarray:
        return np.random.default_rng(key(self.seed, INDICES, worker, epoch)).permutation(
            self.s).astype(np.int32)

    def next_chunk(self, rounds: int) -> np.ndarray:
        out = np.empty((rounds, self.n, self.b), np.int32)
        for w in range(self.n):
            for t in range(rounds):
                if self.pos[w] + self.b > self.s:
                    self.epoch[w] += 1
                    self.perm[w] = self._perm(w, self.epoch[w])
                    self.pos[w] = 0
                out[t, w] = self.perm[w][self.pos[w]:self.pos[w] + self.b]
                self.pos[w] += self.b
        return out


def latents(device, seed: int, chunk: int, rounds: int, per_round: int,
            z_dim: int) -> torch.Tensor:
    """Chunk ``chunk``'s (rounds, per_round, z_dim) latents."""
    return torch.randn(rounds, per_round, z_dim, device=device,
                       generator=generator(device, seed, LATENTS, chunk))


def noise(device, seed: int, chunk: int, rounds: int, per_round: int,
          shapes: Sequence[Sequence[int]]) -> List[torch.Tensor]:
    """Chunk ``chunk``'s generator noise: for input ``i`` of ``shapes`` (the
    per-sample shapes, in order) a (rounds, per_round, *shapes[i]) tensor of
    N(0, 1), drawn by the generator of (seed, NOISE, chunk, i)."""
    return [torch.randn(rounds, per_round, *shape, device=device,
                        generator=generator(device, seed, NOISE, chunk, i))
            for i, shape in enumerate(shapes)]


def real_batches(device, seed: int, workers: Sequence[int], shard_size: int,
                 image_shape: Sequence[int], idx: np.ndarray) -> List[torch.Tensor]:
    """The real batches of the rounds of ``idx`` (T, N, b), made again from
    the seed: a list of T (N, b, C, H, W) float32 tensors in [-1, 1], one
    shard on the device at a time."""
    rows = []
    for j, w in enumerate(workers):
        pixels = shard(device, seed, w, shard_size, image_shape)
        rows.append(pixels[torch.from_numpy(idx[:, j].astype(np.int64)).to(device)])
        del pixels
    x = torch.stack(rows, 1).double() * (2.0 / 255.0) - 1.0        # (T, N, b, H, W, C)
    return list(x.float().permute(0, 1, 2, 5, 3, 4).contiguous().unbind(0))
