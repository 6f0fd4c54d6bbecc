"""The MD-GAN round on one device.

Port of the single-device branches of ``mdgan_tpu/engine/mdgan.py:59-608``.
Per round (``MDGANEngine._step``, ``:392-483``, with ``_d_region``,
``:203-310``):

 1. **Generate** k*b fakes in one train-mode G forward, k = max(floor(ln N), 2);
    the graph is kept for the one G backward of step 5.
 2. **Distribute**: worker n trains on batch ``(n+1) % k`` and gives feedback
    on batch ``n % k``.
 3. **Local D training**: each worker takes its real batch (gathered and
    normalized by the sampling kernel, once per chunk of rounds in
    :meth:`MDGANEngine.run_rounds`) and takes ``local_epochs`` Adam
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
``swap_opt_state``.  A loop over the N discriminators is the first form;
batching them into grouped convolutions is later work.

A discriminator with dropout (the MLP's) draws its masks from the DROPOUT
lane, keyed as the JAX engine folds its dropout key (``:252-268, 287-288``):
the D step's forwards by (step, local epoch l, worker w, half: 0 real, 1
fake), the feedback forward by (step, local_epochs, w).  Tests inject the
JAX side's masks by the same keys instead.

A chunk's real batches are gathered in as few sampling launches as keep
each launch's output within ``GATHER_CAP_BYTES`` (256 MiB): one launch a
chunk at CIFAR-10 (98 MB for 100 rounds at N=8, b=10), several at
128x128x3 (1.57 GB).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mdgan_tpu_torch.core import prng
from mdgan_tpu_torch.core.config import TrainConfig, k_batches, resolve_device
from mdgan_tpu_torch.core.registry import DatasetSpec
from mdgan_tpu_torch.engine.state import MDGANState, NetState
from mdgan_tpu_torch.models.layers import dcgan_init_
from mdgan_tpu_torch.ops import losses
from mdgan_tpu_torch.ops.sampling import sample_normalize

# the most float32 bytes one sampling launch of a chunk writes
GATHER_CAP_BYTES = 256 * 2 ** 20
# injected dropout masks: the key path of a D forward -> its layers' keep masks
Masks = Dict[Tuple[int, ...], Sequence[torch.Tensor]]


class EngineBase:
    """What both engines share: the device, the compute dtype, the latent
    and dropout lanes, the family's init, index upload, the chunk's gather
    and generator sampling."""

    def __init__(self, spec: DatasetSpec, train_cfg: TrainConfig,
                 model_kwargs: Optional[Dict] = None):
        """``train_cfg.device`` picks the device (None: cuda, raising when
        there is none); ``model_kwargs`` passes width keywords to the model
        factories, each to the nets whose ``spec.g_widths``/``d_widths``
        name it (``ngf``/``ndf`` for the DCGANs; ``base_features``,
        ``max_res`` and ``map_layers`` for StyleGAN2)."""
        for opt in (train_cfg.generator_opt, train_cfg.discriminator_opt):
            if (opt.mu_dtype, opt.nu_dtype) != ("float32", "float32"):
                raise NotImplementedError(
                    "bfloat16 Adam moments are not ported yet (ROADMAP.md A.6)")
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
        self._zgen = torch.Generator(device=self.device)
        self._dropgen = torch.Generator(device=self.device)
        self._init = spec.init_weights or dcgan_init_

    def _kw(self, widths: Sequence[str]) -> Dict:
        return {k: self.model_kwargs[k] for k in widths if k in self.model_kwargs}

    def new_generator(self, seed: int) -> NetState:
        """A generator on the device, initialized from lane INIT_G (drawn on
        the CPU, so every device starts from the same weights)."""
        g = self._init(self.spec.make_generator(**self._kw(self.spec.g_widths)),
                       prng.generator(seed, prng.INIT_G))
        return NetState([g], self.device)

    def _new_discriminators(self, seed: int, n: int) -> NetState:
        """n discriminators, copy w from lane (INIT_D, w)."""
        return NetState([self._init(self.spec.make_discriminator(**self._kw(self.spec.d_widths)),
                                    prng.generator(seed, prng.INIT_D, w))
                         for w in range(n)], self.device)

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
            yield from sample_normalize(data, idx[s:s + span])

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

    def _latents(self, step: int, seed: int, num: int) -> torch.Tensor:
        """``num`` latents from lane (LATENT, step)."""
        prng.reseed(self._zgen, seed, prng.LATENT, step)
        return torch.randn(num, self.spec.z_dim, generator=self._zgen, device=self.device)

    @torch.no_grad()
    def generate(self, g: NetState, z: torch.Tensor) -> torch.Tensor:
        """G(z) with train-mode BN, as ``sample_fn`` (``mdgan.py:596-608``);
        G's running stats are left as they were."""
        saved = g.stats.clone()
        with self._autocast():
            out = g.modules[0](z)
        g.stats.copy_(saved)
        return out

    def sample(self, g: NetState, num: int, seed: int) -> torch.Tensor:
        """``num`` images from lane (EVAL, seed)."""
        gen = prng.generator(seed, prng.EVAL, 0, device=self.device)
        return self.generate(g, torch.randn(num, self.spec.z_dim, generator=gen,
                                            device=self.device))


class MDGANEngine(EngineBase):
    """Holds the models' factories, the device and the round."""

    def __init__(self, spec: DatasetSpec, train_cfg: TrainConfig, num_workers: int,
                 model_kwargs: Optional[Dict] = None):
        if num_workers < 1:
            raise ValueError("need at least one discriminator worker")
        if train_cfg.straggler_rate != 0.0:
            raise NotImplementedError(
                "straggler_rate > 0 is not ported yet (ROADMAP.md A.6, the "
                "straggler mask and the 1/(b*|S|) mean)")
        if train_cfg.swap_impl == "ppermute":
            raise NotImplementedError(
                "swap_impl='ppermute' needs the multi-GPU port (ROADMAP.md A.8)")
        super().__init__(spec, train_cfg, model_kwargs)
        self.n = num_workers
        self.k = k_batches(num_workers)
        w = torch.arange(num_workers, device=self.device)
        self._g_assign = w % self.k          # X_g batch per worker (server.py:238)
        self._d_assign = (w + 1) % self.k    # X_d batch per worker (server.py:239)

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------

    def init_state(self, seed: int) -> MDGANState:
        """G from lane INIT_G, discriminator w from lane (INIT_D, w)."""
        return MDGANState(g=self.new_generator(seed),
                          d=self._new_discriminators(seed, self.n), seed=seed)

    def shard_data(self, shards: np.ndarray) -> torch.Tensor:
        """The (N, S, H, W, C) uint8 shard stack, resident on the device."""
        if shards.dtype != np.uint8 or shards.ndim != 5 or shards.shape[0] != self.n:
            raise ValueError(f"shards must be (N={self.n}, S, H, W, C) uint8, "
                             f"got {shards.shape} {shards.dtype}")
        return torch.from_numpy(np.ascontiguousarray(shards)).to(self.device)

    # ------------------------------------------------------------------
    # one training round
    # ------------------------------------------------------------------

    def latents(self, st: MDGANState) -> torch.Tensor:
        """This round's k*b latents from lane (LATENT, step)."""
        return self._latents(st.step, st.seed, self.k * self.cfg.batch_size)

    def step(self, st: MDGANState, data: torch.Tensor, idx: torch.Tensor,
             z: Optional[torch.Tensor] = None,
             masks: Optional[Masks] = None) -> Dict[str, torch.Tensor]:
        """One round, updating ``st`` in place.

        data: (N, S, H, W, C) uint8 on the device; idx: (N, b) int32 on the
        device; z: optional (k*b, z_dim) latents; masks: optional dropout
        keep masks by key path, (l, w, half) for the D step and
        (local_epochs, w) for the feedback (tests inject JAX's).
        Returns device tensors: ``mean_d_loss`` (N,), ``g_feedback_loss``
        (N,), ``feedback_norm`` () and ``x_eval`` (k*b, C, H, W), the images
        of the pre-update generator.
        """
        return self._round(st, sample_normalize(data, idx), z, masks)

    def _round(self, st: MDGANState, real: torch.Tensor, z: Optional[torch.Tensor],
               masks: Optional[Masks] = None) -> Dict[str, torch.Tensor]:
        """The round's body on its real batch ``real``, (N, b, C, H, W) float32."""
        cfg, n, k, b = self.cfg, self.n, self.k, self.cfg.batch_size
        if z is None:
            z = self.latents(st)
        g_net, d_net = st.g.modules[0], st.d.modules

        def d_fwd(w, x, *path):
            return self._d_forward(d_net[w], x, st.seed, st.step, path, masks)

        # (1) generate k*b fakes in one forward; the graph waits for (5)
        with self._autocast():
            x_all = g_net(z)
        img_shape = x_all.shape[1:]
        x_k = x_all.detach().view(k, b, *img_shape)

        # (2) fake batches per worker, (3) real batches and local D steps
        x_d = x_k[self._d_assign]
        d_loss_sum = torch.zeros(n, device=self.device)
        for l in range(cfg.local_epochs):
            st.d.zero_grad()
            with self._autocast():
                loss = torch.stack([losses.d_loss(d_fwd(w, real[w], l, w, 0),
                                                  d_fwd(w, x_d[w], l, w, 1))
                                    for w in range(n)])
            loss.sum().backward()
            st.d.adam_step(cfg.discriminator_opt)
            d_loss_sum += loss.detach()
        mean_d_loss = d_loss_sum / cfg.local_epochs

        # (4) feedback through the updated discriminators
        x_g = x_k[self._g_assign].requires_grad_(True)
        with self._autocast():
            g_losses = torch.stack([losses.g_loss(d_fwd(w, x_g[w], cfg.local_epochs, w))
                                    for w in range(n)])
        (feedback,) = torch.autograd.grad(g_losses.sum(), x_g)
        fb_sq = feedback.square().sum()

        # (5) scatter-add onto the source batches, one G backward at 1/(b*N)
        cot = torch.zeros_like(x_k).index_add_(0, self._g_assign, feedback)
        st.g.zero_grad()
        x_all.backward(cot.view_as(x_all) * (1.0 / (b * n)))
        st.g.adam_step(cfg.generator_opt)
        st.step += 1
        return {
            "mean_d_loss": mean_d_loss,
            "g_feedback_loss": g_losses.detach(),
            "feedback_norm": fb_sq.sqrt(),
            "x_eval": x_k.reshape(k * b, *img_shape),
        }

    def run_rounds(self, st: MDGANState, data: torch.Tensor, sampler, num_rounds: int,
                   z: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One chunk of ``num_rounds`` rounds with indices from ``sampler``
        (the analogue of ``chunk_fn``): metrics stacked on a leading round
        axis, except ``x_eval``, which is the last round's.

        The chunk's real batches come from :meth:`_real_batches`: one
        sampling launch a chunk unless the chunk's output passes
        ``GATHER_CAP_BYTES``.  z: optional (T, k*b, z_dim) latents.
        """
        if z is not None and z.shape[0] != num_rounds:
            raise ValueError(f"z holds {z.shape[0]} rounds of latents, want {num_rounds}")
        idx = self.put_indices(sampler.next_chunk(num_rounds), data.shape[1])
        out: List[Dict[str, torch.Tensor]] = [
            self._round(st, real, None if z is None else z[t])
            for t, real in enumerate(self._real_batches(data, idx))]
        stacked = {key: torch.stack([m[key] for m in out])
                   for key in ("mean_d_loss", "g_feedback_loss", "feedback_norm")}
        stacked["x_eval"] = out[-1]["x_eval"]
        return stacked

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
        """Worker w takes worker perm[w]'s params and BN stats."""
        perm = np.asarray(perm, np.int64)
        if sorted(perm.tolist()) != list(range(self.n)):
            raise ValueError(f"swap needs a permutation of range({self.n}), got {perm}")
        perm_t = torch.as_tensor(perm, device=self.device)
        st.d.permute_(perm_t, with_opt_state=self.cfg.swap_opt_state)
        return st
