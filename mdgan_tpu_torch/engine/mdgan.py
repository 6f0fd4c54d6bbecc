"""The MD-GAN round, on one device or sharded over ``torch.distributed`` ranks.

Port of ``mdgan_tpu/engine/mdgan.py:59-608``.
Per round (``MDGANEngine._step``, ``:392-483``, with ``_d_region``,
``:203-310``):

 1. **Generate** k*b fakes in one train-mode G forward, k = max(floor(ln N), 2);
    the graph is kept for the one G backward of step 5.
 2. **Distribute**: worker n trains on batch ``(n+1) % k`` and gives feedback
    on batch ``n % k``.
 3. **Local D training**: each worker takes its real batch (gathered and
    normalized by the sampling kernel, once per chunk of rounds in
    :meth:`EngineBase.run_rounds`) and takes ``local_epochs`` Adam
    steps on ``BCE(D(real), 1) + BCE(D(X_d), 0)`` — two sequential train-mode
    forwards, each with its own batch statistics.  One Adam launch updates
    all N discriminators.
 4. **Error feedback** through the UPDATED discriminators: the gradient of
    ``BCE(D_n(X_g), 1)`` with respect to the images.  This forward updates
    D's running statistics too.
 5. The feedbacks are scatter-added onto their source batches, scaled by
    1/(b*N), and pushed through one G backward; then the G Adam step.

Swaps (``sample_swap_perm``/``swap``, ``:531-590``) permute the
discriminators' params and BN stats; Adam moments stay put unless
``swap_opt_state``.

**The discriminators as one network** (the JAX engine vmaps its stacked
discriminators, ``:246-291``).  Where the discriminator is stackable
(``models/layers.py`` :func:`stackable`: ConvBlock stages, then one Conv2d,
no dropout; the DCGANs), steps 3 and 4 run the rank's N/W discriminators
as one grouped-convolution network on channel-stacked batches
(:meth:`MDGANEngine._d_region_stacked`): each D input (N/W, b, C, H, W)
becomes (b, N/W*C, H, W), every conv is a grouped conv of N/W groups (run
as one batched GEMM), BatchNorm runs over the stacked channels with each
worker's own statistics, and the
weights are copied dense from strided (N/W, *shape) views of the
worker-major arenas (``engine/state.py`` :meth:`NetState.stacked`) once a
D step and once a feedback, and their gradients written back through the
same views into the arena Adam reads.  The real and fake forwards stay two
forwards.  Other discriminators (MLP-GAN's dropout,
StyleGAN2's modulated convs and minibatch statistic) run one worker at a
time (:meth:`MDGANEngine._d_region_loop`).

**Stragglers** (``--straggler_rate``, ``:404-414, 445-459, 476-479``): every
round draws u ~ U(0,1) for the N workers from lane (STRAGGLER, step) and the
server keeps the feedbacks with ``u <= 1 - rate``, and always the earliest
one.  The dropped feedbacks add nothing to the cotangent, ``feedback_norm``
is taken before the drop, the G step averages over the kept ones,
1/(b*|S|), and the round reports ``n_feedbacks`` = |S|.

**Sharded over ranks.**  Under ``torch.distributed`` (``core/mesh.py``)
each of the W ranks holds the replicated generator and N/W discriminators,
their shards and their Adam state; the round is then the explicit SPMD
program that ``_d_region_shard_map`` (``:312-390``) and
``parallel/shard_map_step.py`` write with ``shard_map``, and there is no
second form of it.  Each rank gathers its workers' real batches (its columns
of the global sampler's (T, N, b) indices; every rank runs the same seeded
sampler), trains them, and scatter-adds their feedbacks into a local
(k, b, C, H, W) cotangent; one ``all_reduce`` of the cotangent and the
feedbacks' squared sum is the round's one collective (the ``psum`` of
``:372-375``).  Then every rank runs the same G backward and G Adam step, so
G stays bit-equal on every rank.  Initial weights, dropout keys and the
straggler mask are keyed by the GLOBAL worker id, so the run equals the
single-process one up to the order of that sum.  The per-worker losses are
gathered to (N,) once a chunk.

**The replica and tensor axes** (``--num_replicas R``, ``--num_tensor T``;
``core/mesh.py``).  Rank (r, w, t) holds worker slot w's discriminators,
replicated over r and t, and the generator's tensor slice t
(``parallel/tensor.py``).  The round splits every batch over the replicas:
replica r takes rows ``rows`` of each worker's b (sizes differing by at
most one), gathers only those real rows, and draws the round's k*b latents
as (k, b) and keeps the same columns, so its share of every fake batch is
exactly the rows its discriminators train and feed back on.  BatchNorm
statistics (and StyleGAN2's minibatch statistic) are the whole batch's;
losses are local sums over the global b; the D and G gradients are summed
over the replica group before each Adam launch; the cotangent is summed over
the workers group (same r and t) only.  Metrics are made whole once a
chunk: the loss parts and the feedbacks' squared sums summed over the
replicas, the per-worker series gathered over the workers group, and
``x_eval`` gathered over the replicas in the single-process row order.
Without those axes the round is the one above, op for op.

A discriminator with dropout (the MLP's) draws its masks from the DROPOUT
lane, keyed as the JAX engine folds its dropout key (``:252-268, 287-288``):
the D step's forwards by (step, local epoch l, worker w, half: 0 real, 1
fake), the feedback forward by (step, local_epochs, w).  Tests inject the
JAX side's masks by the same keys instead.

A chunk's real batches are gathered in as few sampling launches as keep
each launch's output within ``GATHER_CAP_BYTES`` (256 MiB): one launch a
chunk at CIFAR-10 (98 MB for 100 rounds at N=8, b=10), several at
128x128x3 (1.57 GB).

**Generator inputs.**  A generator that takes per-pixel noise (StyleGAN2
config-f) declares its inputs' per-sample shapes (``noise_shapes()``).  A
round's inputs are :meth:`EngineBase.g_inputs`: z, then one (k*b, *shape)
tensor a noise input, each given or drawn from its lane; a replica keeps its
rows.  Images outside the round come from :func:`sample_generator`: z, then
any noise, from the caller's ``torch.Generator``.

Both engines mark their phases with the same spans (``obs/spans.py``
:func:`phase`, recorded only under ``torch.profiler``): ``engine.chunk``
(``run_rounds``), ``engine.sample`` (each sampling launch),
``engine.round``, and inside it ``engine.generate`` (step 1),
``engine.d_step`` (a local epoch of step 3), ``engine.feedback`` (step 4)
and ``engine.g_update`` (step 5); ``engine.d_stacked`` inside the D step and
the feedback around each forward of the stacked discriminators (2 a local
epoch, 1 a feedback); ``engine.collective`` around each collective of an
active axis, ``engine.metrics`` around the chunk's metrics,
``engine.swap``.  There is no span per worker.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mdgan_tpu_torch.core import distributed, prng
from mdgan_tpu_torch.core.config import TrainConfig, k_batches, resolve_device
from mdgan_tpu_torch.core.mesh import RankLayout, rank_layout
from mdgan_tpu_torch.core.registry import DatasetSpec
from mdgan_tpu_torch.engine.state import MDGANState, NetState, moment_dtype
from mdgan_tpu_torch.models.layers import (dcgan_init_, stack_batches, stackable,
                                           stacked_forward, stacked_weights)
from mdgan_tpu_torch.obs.spans import phase
from mdgan_tpu_torch.ops import losses
from mdgan_tpu_torch.ops.sampling import sample_normalize
from mdgan_tpu_torch.parallel import swap as swap_lib
from mdgan_tpu_torch.parallel import tensor as tensor_lib

# the most float32 bytes one sampling launch of a chunk writes
GATHER_CAP_BYTES = 256 * 2 ** 20
# injected dropout masks: the key path of a D forward -> its layers' keep masks
Masks = Dict[Tuple[int, ...], Sequence[torch.Tensor]]


class EngineBase:
    """What both engines share: the device, the compute dtype, the latent,
    noise and dropout lanes, the family's init, index upload, the chunk
    loop and its gather, the round's generator inputs and sampling outside
    the round."""

    def __init__(self, spec: DatasetSpec, train_cfg: TrainConfig,
                 model_kwargs: Optional[Dict] = None):
        """``train_cfg.device`` picks the device (None: cuda, raising when
        there is none); ``model_kwargs`` passes width keywords to the model
        factories, each to the nets whose ``spec.g_widths``/``d_widths``
        name it (``ngf``/``ndf`` for the DCGANs; ``base_features``,
        ``max_res`` and ``map_layers`` for StyleGAN2; ``fmap_base``,
        ``fmap_max``, ``max_res`` and ``map_layers`` for its config-f)."""
        self._g_moments = moment_dtype(train_cfg.generator_opt)
        self._d_moments = moment_dtype(train_cfg.discriminator_opt)
        if train_cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {train_cfg.compute_dtype!r}")
        unknown = set(model_kwargs or {}) - set(spec.g_widths) - set(spec.d_widths)
        if unknown:
            raise ValueError(f"{spec.name} takes no width keywords {sorted(unknown)}; "
                             f"it takes {sorted(set(spec.g_widths) | set(spec.d_widths))}")
        self.spec = spec
        self.cfg = train_cfg
        self.device = resolve_device(train_cfg.device)
        self.model_kwargs = dict(model_kwargs or {})
        self._bf16 = train_cfg.compute_dtype == "bfloat16"
        self._g_batch = train_cfg.batch_size  # samples a round's G forward makes
        self._zgen = torch.Generator(device=self.device)
        self._dropgen = torch.Generator(device=self.device)
        self._noisegen = torch.Generator(device=self.device)
        self._init = spec.init_weights or dcgan_init_

    def _kw(self, widths: Sequence[str]) -> Dict:
        return {k: self.model_kwargs[k] for k in widths if k in self.model_kwargs}

    def new_generator(self, seed: int) -> NetState:
        """A generator on the device, initialized from lane INIT_G (drawn on
        the CPU, so every device starts from the same weights)."""
        g = self._init(self.spec.make_generator(**self._kw(self.spec.g_widths)),
                       prng.generator(seed, prng.INIT_G))
        return NetState([g], self.device, self._g_moments)

    def _new_discriminators(self, seed: int, workers: Sequence[int]) -> NetState:
        """The discriminators of global worker ids ``workers``, worker w
        from lane (INIT_D, w)."""
        return NetState([self._init(self.spec.make_discriminator(**self._kw(self.spec.d_widths)),
                                    prng.generator(seed, prng.INIT_D, w))
                         for w in workers], self.device, self._d_moments)

    def _d_forward(self, d, x: torch.Tensor, seed: int, step: int, path: Tuple[int, ...],
                   masks: Optional[Masks]) -> torch.Tensor:
        """D(x) in train mode.  A discriminator with dropout gets the keep
        masks injected under ``path``, or the DROPOUT lane's generator
        re-seeded at (step, *path)."""
        if not getattr(d, "uses_dropout", False):
            return d(x)
        if masks is not None:
            return d(x, masks[path])
        return d(x, prng.reseed(self._dropgen, seed, prng.DROPOUT, step, *path))

    def _real_batches(self, data: torch.Tensor, idx: torch.Tensor) -> Iterator[torch.Tensor]:
        """A chunk's real batches, (N, b, C, H, W) a round, from (T, N, b)
        indices: gathered in as few sampling launches as keep each launch's
        output within ``GATHER_CAP_BYTES`` (the shards are read-only during
        a chunk, so this equals one gather per round)."""
        per_round = idx[0].numel() * data[0, 0].numel() * 4
        span = max(1, GATHER_CAP_BYTES // per_round)
        for s in range(0, idx.shape[0], span):
            with phase("engine.sample"):
                reals = sample_normalize(data, idx[s:s + span])
            yield from reals

    def _my_indices(self, idx: np.ndarray) -> np.ndarray:
        """This process's columns of a chunk's (T, N, b) sampler indices."""
        return idx

    def put_indices(self, idx: np.ndarray, shard_size: int) -> torch.Tensor:
        """Validate sampler indices on the host, then copy them to the device."""
        idx = np.asarray(idx)
        if idx.size and (idx.min() < 0 or idx.max() >= shard_size):
            raise IndexError(f"sample index outside [0, {shard_size})")
        return torch.from_numpy(np.ascontiguousarray(idx, np.int32)).to(self.device)

    def _autocast(self):
        if not self._bf16:
            return contextlib.nullcontext()
        return torch.autocast(device_type=self.device.type, dtype=torch.bfloat16)

    def latents(self, st) -> torch.Tensor:
        """This round's latents from lane (LATENT, step), one for each
        sample of its G forward: k*b in MD-GAN, b standalone."""
        prng.reseed(self._zgen, st.seed, prng.LATENT, st.step)
        return torch.randn(self._g_batch, self.spec.z_dim, generator=self._zgen,
                           device=self.device)

    def g_inputs(self, st, z: Optional[torch.Tensor] = None,
                 noise: Optional[Sequence[torch.Tensor]] = None) -> List[torch.Tensor]:
        """This round's generator inputs, ``[z, *noise]``: z from
        :meth:`latents`, and, where the generator declares
        ``noise_shapes()``, noise input i from lane (NOISE, step, i); the
        inputs given are used as given."""
        z = self.latents(st) if z is None else z
        declared = getattr(st.g.modules[0], "noise_shapes", None)
        if declared is None:
            if noise is not None:
                raise ValueError(f"{self.spec.name}'s generator takes no noise")
            return [z]
        shapes = declared()
        if noise is None:
            return [z] + [torch.randn(self._g_batch, *shape, device=self.device,
                                      generator=prng.reseed(self._noisegen, st.seed, prng.NOISE,
                                                            st.step, i))
                          for i, shape in enumerate(shapes)]
        if len(noise) != len(shapes) or any(tuple(n.shape[1:]) != tuple(s)
                                            for n, s in zip(noise, shapes)):
            raise ValueError(f"noise must be {len(shapes)} tensors of (samples, *shape) with "
                             f"shapes {shapes}, got {[tuple(n.shape) for n in noise]}")
        return [z, *noise]

    def generate(self, g: NetState, z: torch.Tensor,
                 noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """G(z) (with its noise inputs, where it takes noise) in train-mode
        BN and the compute dtype, as ``sample_fn`` (``mdgan.py:596-608``);
        G's running stats are left as they were."""
        with self._autocast():
            return generate_kept(g.modules[0], [z, *(noise or ())], g.stats)

    def sample(self, g: NetState, num: int, seed: int = 0,
               gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """``num`` images in the compute dtype (:func:`sample_generator`),
        drawn from ``gen``, or from lane (EVAL, seed)."""
        if gen is None:
            gen = prng.generator(seed, prng.EVAL, 0, device=self.device)
        with self._autocast():
            return sample_generator(g.modules[0], num, self.spec.z_dim, gen, g.stats)

    def run_rounds(self, st, data: torch.Tensor, sampler, num_rounds: int,
                   z: Optional[torch.Tensor] = None,
                   noise: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """One chunk of ``num_rounds`` rounds with indices from ``sampler``
        (the analogue of ``chunk_fn``): metrics stacked on a leading round
        axis, except ``x_eval``, which is the last round's.

        The chunk's real batches come from :meth:`_real_batches`: one
        sampling launch a chunk unless the chunk's output passes
        ``GATHER_CAP_BYTES``.  z: optional (T, samples, z_dim) latents;
        noise (a generator that takes noise): optional, one (T, samples,
        *shape) tensor a noise input, in the generator's order; round t
        gets slice t of each (:meth:`g_inputs`).
        """
        if z is not None and z.shape[0] != num_rounds:
            raise ValueError(f"z holds {z.shape[0]} rounds of latents, want {num_rounds}")
        if noise is not None and any(n.shape[0] != num_rounds for n in noise):
            raise ValueError(f"noise must hold {num_rounds} rounds, got "
                             f"{[tuple(n.shape) for n in noise]}")
        with phase("engine.chunk", st.step):
            idx = sampler.next_chunk(num_rounds)
            reals = self._real_batches(data, self.put_indices(self._my_indices(idx),
                                                              data.shape[1]))
            out: List[Dict[str, torch.Tensor]] = [
                self._round(st, real, None if z is None else z[t],
                            noise=None if noise is None else [x[t] for x in noise])
                for t, real in enumerate(reals)]
            with phase("engine.metrics"):
                stacked = {key: torch.stack([m[key] for m in out])
                           for key in out[0] if key != "x_eval"}
                stacked["x_eval"] = out[-1]["x_eval"]
                return self._chunk_metrics(stacked, idx)


def generate_kept(g: nn.Module, inputs: Sequence[torch.Tensor],
                  stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """G on ``inputs`` (``[z, *noise]``) in train-mode BN without a graph,
    G's statistics left as they were: the arena ``stats`` that holds them,
    kept in one copy, or each of G's buffers."""
    kept = list(g.buffers()) if stats is None else [stats]
    with torch.no_grad():
        saved = [t.clone() for t in kept]
        out = run_generator(g, inputs)
        for t, before in zip(kept, saved):
            t.copy_(before)
    return out


def run_generator(g: nn.Module, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """G on its inputs: ``g(z)``, or ``g(z, noise)`` where it takes noise."""
    z, *noise = inputs
    return g(z, noise) if noise else g(z)


def sample_generator(g: nn.Module, num: int, z_dim: int, gen: torch.Generator,
                     stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``num`` images of ``g`` outside the round: (num, z_dim) latents, then,
    where ``g`` declares ``noise_shapes()``, each noise input, all drawn
    from ``gen`` in that order; G runs as :func:`generate_kept` runs it."""
    z = torch.randn(num, z_dim, generator=gen, device=gen.device)
    declared = getattr(g, "noise_shapes", None)
    noise = [] if declared is None else [torch.randn(num, *shape, generator=gen, device=gen.device)
                                         for shape in declared()]
    return generate_kept(g, [z, *noise], stats)


class MDGANEngine(EngineBase):
    """Holds the models' factories, the device, the rank layout and the round."""

    def __init__(self, spec: DatasetSpec, train_cfg: TrainConfig, num_workers: int,
                 model_kwargs: Optional[Dict] = None, layout: Optional[RankLayout] = None):
        """The workers this process holds, its replica rows and its tensor
        slice come from ``layout`` (default: the ``torch.distributed`` group's
        workers axis, ``core/mesh.py``; all N without one)."""
        if num_workers < 1:
            raise ValueError("need at least one discriminator worker")
        if not 0.0 <= train_cfg.straggler_rate < 1.0:
            raise ValueError(
                f"straggler_rate must be in [0, 1), got {train_cfg.straggler_rate}")
        super().__init__(spec, train_cfg, model_kwargs)
        self.n = num_workers
        self.layout = rank_layout(num_workers) if layout is None else layout
        if self.layout.idle:
            raise ValueError(f"rank {self.layout.rank} is idle in the (R, W, T) = "
                             f"{self.layout.shape} mesh: it holds no worker")
        self._replica, self._tensor = self.layout.replica_axis, self.layout.tensor_axis
        b = train_cfg.batch_size
        if b < self._replica.size:
            raise ValueError(f"batch_size={b} must be at least num_replicas="
                             f"{self._replica.size}: every replica takes rows of each batch")
        # this replica's rows of every batch: np.array_split's sizes
        self._row_sizes = [len(a) for a in np.array_split(np.arange(b), self._replica.size)]
        lo_row = sum(self._row_sizes[:self._replica.index])
        self._rows = slice(lo_row, lo_row + self._row_sizes[self._replica.index])
        self._split = self._replica.active
        self._total = b if self._split else None  # losses: a mean, or a part of one
        self.k = k_batches(num_workers)
        self._g_batch = self.k * b
        w = torch.arange(self.layout.lo, self.layout.hi, device=self.device)
        self._g_assign = w % self.k          # X_g batch per worker (server.py:238)
        self._d_assign = (w + 1) % self.k    # X_d batch per worker (server.py:239)
        self._stragen = torch.Generator(device=self.device)

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------

    def init_state(self, seed: int) -> MDGANState:
        """G from lane INIT_G (this rank's tensor slice of it), discriminator
        w from lane (INIT_D, w), for this rank's global worker ids w."""
        g = self._init(self.spec.make_generator(**self._kw(self.spec.g_widths)),
                       prng.generator(seed, prng.INIT_G))
        g = tensor_lib.shard_module(g, self._tensor)
        d = self._new_discriminators(seed, self.layout.workers)
        for m in [g, *d.modules]:
            for sub in m.modules():
                if hasattr(sub, "replica"):  # BatchNorm, the minibatch statistic
                    sub.replica = self._replica
        return MDGANState(g=NetState([g], self.device, self._g_moments), d=d, seed=seed)

    def shard_data(self, shards: np.ndarray) -> torch.Tensor:
        """This rank's rows of the (N, S, H, W, C) uint8 shard stack,
        resident on the device."""
        if shards.dtype != np.uint8 or shards.ndim != 5 or shards.shape[0] != self.n:
            raise ValueError(f"shards must be (N={self.n}, S, H, W, C) uint8, "
                             f"got {shards.shape} {shards.dtype}")
        mine = shards[self.layout.lo:self.layout.hi]
        return torch.from_numpy(np.ascontiguousarray(mine)).to(self.device)

    # ------------------------------------------------------------------
    # one training round
    # ------------------------------------------------------------------

    def _my_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This replica's rows of every batch of a (k*b, ...) tensor, as
        (k*b_r, ...)."""
        if not self._split:
            return x
        k, b = self.k, self.cfg.batch_size
        return x.reshape(k, b, *x.shape[1:])[:, self._rows].reshape(-1, *x.shape[1:])

    def _d_forward(self, d, x: torch.Tensor, seed: int, step: int, path: Tuple[int, ...],
                   masks: Optional[Masks]) -> torch.Tensor:
        """As the base class's, with this replica's rows of the whole batch's
        dropout masks when the batch is split."""
        if not (self._split and getattr(d, "uses_dropout", False)):
            return super()._d_forward(d, x, seed, step, path, masks)
        full = masks[path] if masks is not None else d.draw_masks(
            prng.reseed(self._dropgen, seed, prng.DROPOUT, step, *path),
            self.cfg.batch_size, x.device)
        return d(x, [m[self._rows] for m in full])

    def straggler_mask(self, st: MDGANState) -> torch.Tensor:
        """This round's (N,) accepted-feedback mask from lane (STRAGGLER,
        step): u ~ U(0,1) a worker, kept iff ``u <= 1 - rate``, and the
        earliest arrival always (``mdgan.py:404-414``).  Every rank draws
        all N."""
        prng.reseed(self._stragen, st.seed, prng.STRAGGLER, st.step)
        u = torch.rand(self.n, generator=self._stragen, device=self.device)
        return (u <= 1.0 - self.cfg.straggler_rate) | (u == u.min())

    def step(self, st: MDGANState, data: torch.Tensor, idx: torch.Tensor,
             z: Optional[torch.Tensor] = None, masks: Optional[Masks] = None,
             fb_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One round, updating ``st`` in place.

        data: this rank's (N/W, S, H, W, C) uint8 shards on the device
        (:meth:`shard_data`); idx: the round's (N, b) int32 indices of all
        N workers, on the device; z: optional (k*b, z_dim) latents, all of
        them (a replica keeps its rows); masks:
        optional dropout keep masks by key path, (l, w, half) for the D step
        and (local_epochs, w) for the feedback, w the global worker id
        (tests inject JAX's); fb_mask: optional (N,) bool straggler mask
        (tests inject JAX's; drawn from its lane when ``straggler_rate`` > 0).
        Returns device tensors: ``mean_d_loss`` (N,), ``g_feedback_loss``
        (N,), ``feedback_norm`` (), ``n_feedbacks`` () under the straggler
        policy, and ``x_eval`` (k*b, C, H, W), the images of the pre-update
        generator.
        """
        lo, hi = self.layout.lo, self.layout.hi
        with phase("engine.sample"):
            real = sample_normalize(data, idx[lo:hi, self._rows].contiguous())
        m = self._round(st, real, z, masks, fb_mask)
        with phase("engine.metrics"):
            return self._whole({k: v[None] if k != "x_eval" else v for k, v in m.items()},
                               squeeze=True)

    def _whole(self, m: Dict[str, torch.Tensor], squeeze: bool = False
               ) -> Dict[str, torch.Tensor]:
        """Rounds of this rank's metric parts -> the run's: the loss parts
        and the feedbacks' squared sums summed over the replicas (one
        ``all_reduce``), the per-worker series (rounds, N/W) gathered to
        (rounds, N) over the workers group (one ``all_gather``), the norm
        taken, and ``x_eval`` gathered over the replicas in the
        single-process row order."""
        parts = [m["mean_d_loss"], m["g_feedback_loss"], m.pop("fb_sq")[:, None]]
        if self._split:
            with phase("engine.collective"):
                flat = distributed.all_reduce_(torch.cat(parts, 1).float(), self._replica)
            parts = [p.to(q.dtype) for p, q in zip(flat.split([q.shape[1] for q in parts], 1),
                                                   parts)]
        m["feedback_norm"] = parts[2][:, 0].sqrt()
        local = parts[:2]
        if self.layout.worker_axis.active:
            with phase("engine.collective"):
                full = distributed.all_gather_cat(torch.stack([t.float() for t in local]),
                                                  self.layout.worker_axis, dim=-1)
            local = [f.to(t.dtype) for f, t in zip(full.unbind(0), local)]
        m["mean_d_loss"], m["g_feedback_loss"] = local
        if self._split:
            x = m["x_eval"]
            x = x.reshape(self.k, -1, *x.shape[1:])
            with phase("engine.collective"):
                x = distributed.gather(x, self._replica, 1, self._row_sizes)
            m["x_eval"] = x.reshape(-1, *x.shape[2:])
        if squeeze:
            m = {k: v if k == "x_eval" else v[0] for k, v in m.items()}
        return m

    def _round(self, st: MDGANState, real: torch.Tensor, z: Optional[torch.Tensor],
               masks: Optional[Masks] = None, fb_mask: Optional[torch.Tensor] = None,
               noise: Optional[List[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """The round's body on this rank's real batches ``real``,
        (N/W, b_r, C, H, W) float32, with the round's k*b latents ``z`` and
        noise (each drawn from its lane when None; this replica keeps its
        rows of both).  The metrics it returns are this rank's
        parts: its workers' losses (summed over its rows, over the global b,
        under a replica split), the feedbacks' squared sum ``fb_sq`` and its
        rows of ``x_eval``; :meth:`_whole` makes them the run's."""
        with phase("engine.round", st.step):
            inputs = [self._my_rows(x) for x in self.g_inputs(st, z, noise)]
            if fb_mask is None and self.cfg.straggler_rate > 0.0:
                fb_mask = self.straggler_mask(st)

            # (1) generate k*b fakes in one forward; the graph waits for (5)
            with phase("engine.generate"), self._autocast():
                x_all = run_generator(st.g.modules[0], inputs)
            x_k = x_all.detach().view(self.k, -1, *x_all.shape[1:])
            # (2)-(4) local D steps and feedback, then (5) the G step
            mean_d_loss, g_losses, feedback = self._d_region(st, real, x_k, masks)
            fb_sq = self._g_update(st, x_all, feedback, fb_mask)
            st.step += 1
            out = {
                "mean_d_loss": mean_d_loss,
                "g_feedback_loss": g_losses,
                "fb_sq": fb_sq,
                "x_eval": x_all.detach(),
            }
            if fb_mask is not None:
                out["n_feedbacks"] = fb_mask.sum().to(torch.int32)
            return out

    def _d_fwd(self, st: MDGANState, i: int, x: torch.Tensor, masks: Optional[Masks],
               *path: int) -> torch.Tensor:
        """This rank's discriminator ``i`` on ``x``, its dropout keyed by
        (step, *path)."""
        return self._d_forward(st.d.modules[i], x, st.seed, st.step, path, masks)

    def _d_region(self, st: MDGANState, real: torch.Tensor, x_k: torch.Tensor,
                  masks: Optional[Masks] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Steps (2)-(4) on this rank's workers (``_d_region``,
        ``mdgan.py:203-310``): worker n's ``local_epochs`` Adam steps on its
        real batch and fake batch ``(n+1) % k`` of ``x_k`` (k, b_r, C, H, W),
        one Adam launch a local epoch for all of them, then its feedback on
        batch ``n % k`` (:meth:`_feedback`).  The discriminators run as one
        network where they are stackable (:meth:`_d_region_stacked`), else
        one at a time (:meth:`_d_region_loop`).  Returns ``mean_d_loss``
        and ``g_feedback_loss`` (N/W,) and the feedbacks (N/W, b_r, C, H,
        W)."""
        if stackable(st.d.modules[0]):
            return self._d_region_stacked(st, real, x_k)
        return self._d_region_loop(st, real, x_k, masks)

    def _feedback(self, st: MDGANState, x_g: torch.Tensor, masks: Optional[Masks] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Step (4): worker n's ``BCE(D_n(x_g[n]), 1)`` through its updated
        discriminator and the gradient with respect to ``x_g[n]``; x_g:
        (N/W, b_r, C, H, W), a tensor of its own.  Returns the losses (N/W,)
        and the feedbacks."""
        if stackable(st.d.modules[0]):
            return self._feedback_stacked(st, x_g)
        return self._feedback_loop(st, x_g, masks)

    def _d_region_stacked(self, st: MDGANState, real: torch.Tensor, x_k: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """:meth:`_d_region` with the rank's discriminators as one grouped
        network (``models/layers.py``): each local epoch's real and fake
        forwards (each with its own batch statistics) on the dense weights,
        the gradient of every one of them written over its rows of the
        ``grads`` arena (cast to float32 in the same copy), and Adam."""
        cfg, d = self.cfg, st.d.modules[0]
        params, grads = st.d.stacked(st.d.params), st.d.stacked(st.d.grads)
        stats = st.d.stacked(st.d.stats, stats=True)
        x_d = x_k[self._d_assign]
        d_loss_sum = torch.zeros(self.layout.per_rank, device=self.device)
        for _ in range(cfg.local_epochs):
            with phase("engine.d_step"):
                with self._autocast():
                    w = {k: t.detach().requires_grad_(True)
                         for k, t in stacked_weights(d, params).items()}
                    with phase("engine.d_stacked"):
                        logits_real = stacked_forward(d, stack_batches(real), w, stats)
                    with phase("engine.d_stacked"):
                        logits_fake = stacked_forward(d, stack_batches(x_d), w, stats)
                    loss = losses.d_loss(logits_real, logits_fake, self._total)
                for name, g in zip(w, torch.autograd.grad(loss.sum(), list(w.values()))):
                    grads[name].copy_(g.reshape(grads[name].shape))
                self._replica_sum(st.d.grads)
                st.d.adam_step(cfg.discriminator_opt)
                d_loss_sum += loss.detach()
        g_losses, feedback = self._feedback_stacked(st, x_k[self._g_assign])
        return d_loss_sum / cfg.local_epochs, g_losses, feedback

    def _feedback_stacked(self, st: MDGANState, x_g: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`_feedback` through the rank's discriminators as one grouped
        network; the gradient comes back in ``x_g``'s (N/W, b_r, C, H, W)."""
        d = st.d.modules[0]
        with phase("engine.feedback"):
            x_g = x_g.requires_grad_(True)
            with self._autocast():
                w = stacked_weights(d, st.d.stacked(st.d.params))
                with phase("engine.d_stacked"):
                    logits = stacked_forward(d, stack_batches(x_g), w,
                                             st.d.stacked(st.d.stats, stats=True))
                g_losses = losses.g_loss(logits, self._total)
            (feedback,) = torch.autograd.grad(g_losses.sum(), x_g)
        return g_losses.detach(), feedback

    def _d_region_loop(self, st: MDGANState, real: torch.Tensor, x_k: torch.Tensor,
                       masks: Optional[Masks] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """:meth:`_d_region` one discriminator at a time."""
        cfg, lo, nl = self.cfg, self.layout.lo, self.layout.per_rank
        x_d = x_k[self._d_assign]
        d_loss_sum = torch.zeros(nl, device=self.device)
        for l in range(cfg.local_epochs):
            with phase("engine.d_step"):
                st.d.zero_grad()
                with self._autocast():
                    loss = torch.stack([
                        losses.d_loss(self._d_fwd(st, i, real[i], masks, l, lo + i, 0),
                                      self._d_fwd(st, i, x_d[i], masks, l, lo + i, 1),
                                      self._total)
                        for i in range(nl)])
                loss.sum().backward()
                self._replica_sum(st.d.grads)
                st.d.adam_step(cfg.discriminator_opt)
                d_loss_sum += loss.detach()
        g_losses, feedback = self._feedback_loop(st, x_k[self._g_assign], masks)
        return d_loss_sum / cfg.local_epochs, g_losses, feedback

    def _feedback_loop(self, st: MDGANState, x_g: torch.Tensor, masks: Optional[Masks] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`_feedback` one discriminator at a time."""
        lo, nl = self.layout.lo, self.layout.per_rank
        with phase("engine.feedback"):
            x_g = x_g.requires_grad_(True)
            with self._autocast():
                g_losses = torch.stack([
                    losses.g_loss(self._d_fwd(st, i, x_g[i], masks, self.cfg.local_epochs,
                                              lo + i),
                                  self._total)
                    for i in range(nl)])
            (feedback,) = torch.autograd.grad(g_losses.sum(), x_g)
        return g_losses.detach(), feedback

    def _g_update(self, st: MDGANState, x_all: torch.Tensor, feedback: torch.Tensor,
                  fb_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Step (5): the feedbacks (N/W, b_r, C, H, W), less the stragglers'
        under ``fb_mask``, scatter-added onto their source batches of
        ``x_all``'s k*b_r fakes and summed over the workers, then one G
        backward through ``x_all``'s graph at 1/(b*N), or 1/(b*|S|) under
        stragglers, and the G Adam step.  Returns the feedbacks' squared
        sum over the workers, taken before the drop."""
        b, n, lo, nl = self.cfg.batch_size, self.n, self.layout.lo, self.layout.per_rank
        with phase("engine.g_update"):
            fb_sq = feedback.square().sum()
            if fb_mask is not None:
                # the server's straggler discard: late feedbacks contribute zero
                keep = fb_mask[lo:lo + nl].to(feedback.dtype)
                feedback = feedback * keep.view(-1, *([1] * (feedback.dim() - 1)))
            cot = torch.zeros_like(x_all).view(self.k, -1, *x_all.shape[1:]).index_add_(
                0, self._g_assign, feedback)
            if self.layout.worker_axis.active:
                cot, fb_sq = self._sum_over_workers(cot, fb_sq)
            st.g.zero_grad()
            if fb_mask is None:
                x_all.backward(cot.view_as(x_all) * (1.0 / (b * n)))
            else:
                scale = 1.0 / (b * fb_mask.sum().to(torch.float32))
                x_all.backward((cot.view_as(x_all).float() * scale).to(x_all.dtype))
            self._replica_sum(st.g.grads)
            st.g.adam_step(self.cfg.generator_opt)
        return fb_sq

    def _replica_sum(self, grads: torch.Tensor) -> None:
        """An arena's gradients summed over the replica group, in place
        (nothing without one)."""
        if self._replica.active:
            with phase("engine.collective"):
                distributed.all_reduce_(grads, self._replica)

    def _sum_over_workers(self, cot: torch.Tensor, fb_sq: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The workers' collective: the cotangent and the feedbacks' squared
        sum packed into one float32 buffer and summed over the workers group
        (the two ``psum``s of ``mdgan.py:372-375``)."""
        with phase("engine.collective"):
            buf = torch.cat([cot.reshape(-1).float(), fb_sq.reshape(1).float()])
            distributed.all_reduce_(buf, self.layout.worker_axis)
        return buf[:-1].view(cot.shape).to(cot.dtype), buf[-1].to(fb_sq.dtype)

    def _my_indices(self, idx: np.ndarray) -> np.ndarray:
        """This rank's columns of a chunk's (T, N, b) sampler indices: its
        workers' rows of its replica."""
        return idx[:, self.layout.lo:self.layout.hi, self._rows]

    def _chunk_metrics(self, stacked: Dict[str, torch.Tensor], idx: np.ndarray
                       ) -> Dict[str, torch.Tensor]:
        return self._whole(stacked)

    # ------------------------------------------------------------------
    # discriminator swap
    # ------------------------------------------------------------------

    def sample_swap_perm(self, rng: np.random.Generator) -> np.ndarray:
        """Random non-overlapping pairs -> involutive permutation
        (``mdgan.py:531-541``); needs an even worker count."""
        if self.n % 2 != 0:
            raise ValueError("discriminator swap requires an even worker count")
        pairs = rng.permutation(self.n).reshape(-1, 2)
        perm = np.arange(self.n)
        perm[pairs[:, 0]] = pairs[:, 1]
        perm[pairs[:, 1]] = pairs[:, 0]
        return perm.astype(np.int32)

    def swap(self, st: MDGANState, perm: np.ndarray) -> MDGANState:
        """Worker w takes worker perm[w]'s params and BN stats (and Adam
        moments under ``swap_opt_state``), honouring ``swap_impl``
        (``mdgan.py:543-570``): the pair swap where there is one worker per
        rank (``auto``, or ``ppermute``, which raises elsewhere), else the
        gather swap (``parallel/swap.py``)."""
        perm = np.asarray(perm, np.int64)
        if sorted(perm.tolist()) != list(range(self.n)):
            raise ValueError(f"swap needs a permutation of range({self.n}), got {perm}")
        impl, lay = self.cfg.swap_impl, self.layout
        eligible = lay.worker_axis.active and lay.worker_axis.size == self.n
        if impl == "ppermute" and not eligible:
            raise ValueError(
                "swap_impl='ppermute' needs one worker per rank (workers axis "
                f"{lay.worker_axis.size}, workers={self.n}); use 'gather' or 'auto'")
        with phase("engine.swap"):
            if impl == "ppermute" or (impl == "auto" and eligible):
                swap_lib.swap_pairs(st.d, perm, lay, self.cfg.swap_opt_state)
            else:
                swap_lib.swap_gather(st.d, perm, lay, self.cfg.swap_opt_state)
        return st
