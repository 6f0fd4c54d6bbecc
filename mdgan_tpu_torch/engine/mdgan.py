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
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from mdgan_tpu_torch.core import prng
from mdgan_tpu_torch.core.config import TrainConfig, k_batches, resolve_device
from mdgan_tpu_torch.core.registry import DatasetSpec
from mdgan_tpu_torch.engine.state import MDGANState, NetState
from mdgan_tpu_torch.models.layers import dcgan_init_
from mdgan_tpu_torch.ops import losses
from mdgan_tpu_torch.ops.sampling import sample_normalize


class MDGANEngine:
    """Holds the models' factories, the device and the round."""

    def __init__(self, spec: DatasetSpec, train_cfg: TrainConfig, num_workers: int,
                 model_kwargs: Optional[Dict] = None):
        """``train_cfg.device`` picks the device (None: cuda, raising when
        there is none); ``model_kwargs`` passes widths (``ngf``, ``ndf``)
        to the model factories."""
        if num_workers < 1:
            raise ValueError("need at least one discriminator worker")
        if train_cfg.straggler_rate != 0.0:
            raise NotImplementedError(
                "straggler_rate > 0 is not ported yet (ROADMAP.md A.6, the "
                "straggler mask and the 1/(b*|S|) mean)")
        for opt in (train_cfg.generator_opt, train_cfg.discriminator_opt):
            if (opt.mu_dtype, opt.nu_dtype) != ("float32", "float32"):
                raise NotImplementedError(
                    "bfloat16 Adam moments are not ported yet (ROADMAP.md A.6)")
        if train_cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {train_cfg.compute_dtype!r}")
        if train_cfg.swap_impl == "ppermute":
            raise NotImplementedError(
                "swap_impl='ppermute' needs the multi-GPU port (ROADMAP.md A.8)")
        self.spec = spec
        self.cfg = train_cfg
        self.n = num_workers
        self.k = k_batches(num_workers)
        self.device = resolve_device(train_cfg.device)
        self.model_kwargs = dict(model_kwargs or {})
        self._bf16 = train_cfg.compute_dtype == "bfloat16"
        w = torch.arange(num_workers, device=self.device)
        self._g_assign = w % self.k          # X_g batch per worker (server.py:238)
        self._d_assign = (w + 1) % self.k    # X_d batch per worker (server.py:239)
        self._zgen = torch.Generator(device=self.device)

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------

    def init_state(self, seed: int) -> MDGANState:
        """G from lane INIT_G, discriminator w from lane (INIT_D, w); drawn on
        the CPU so every device starts from the same weights."""
        g = dcgan_init_(self.spec.make_generator(**self._kw("ngf")),
                        prng.generator(seed, prng.INIT_G))
        ds = [dcgan_init_(self.spec.make_discriminator(**self._kw("ndf")),
                          prng.generator(seed, prng.INIT_D, w))
              for w in range(self.n)]
        return MDGANState(g=NetState([g], self.device),
                          d=NetState(ds, self.device), seed=seed)

    def _kw(self, width: str) -> Dict:
        return {width: self.model_kwargs[width]} if width in self.model_kwargs else {}

    def shard_data(self, shards: np.ndarray) -> torch.Tensor:
        """The (N, S, H, W, C) uint8 shard stack, resident on the device."""
        if shards.dtype != np.uint8 or shards.ndim != 5 or shards.shape[0] != self.n:
            raise ValueError(f"shards must be (N={self.n}, S, H, W, C) uint8, "
                             f"got {shards.shape} {shards.dtype}")
        return torch.from_numpy(np.ascontiguousarray(shards)).to(self.device)

    def put_indices(self, idx: np.ndarray, shard_size: int) -> torch.Tensor:
        """Validate sampler indices on the host, then copy them to the device."""
        idx = np.asarray(idx)
        if idx.size and (idx.min() < 0 or idx.max() >= shard_size):
            raise IndexError(f"sample index outside [0, {shard_size})")
        return torch.from_numpy(np.ascontiguousarray(idx, np.int32)).to(self.device)

    # ------------------------------------------------------------------
    # one training round
    # ------------------------------------------------------------------

    def _autocast(self):
        if not self._bf16:
            return contextlib.nullcontext()
        return torch.autocast(device_type=self.device.type, dtype=torch.bfloat16)

    def latents(self, st: MDGANState) -> torch.Tensor:
        """This round's k*b latents from lane (LATENT, step)."""
        prng.reseed(self._zgen, st.seed, prng.LATENT, st.step)
        return torch.randn(self.k * self.cfg.batch_size, self.spec.z_dim,
                           generator=self._zgen, device=self.device)

    def step(self, st: MDGANState, data: torch.Tensor, idx: torch.Tensor,
             z: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One round, updating ``st`` in place.

        data: (N, S, H, W, C) uint8 on the device; idx: (N, b) int32 on the
        device; z: optional (k*b, z_dim) latents (tests inject JAX's).
        Returns device tensors: ``mean_d_loss`` (N,), ``g_feedback_loss``
        (N,), ``feedback_norm`` () and ``x_eval`` (k*b, C, H, W), the images
        of the pre-update generator.
        """
        return self._round(st, sample_normalize(data, idx), z)

    def _round(self, st: MDGANState, real: torch.Tensor,
               z: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The round's body on its real batch ``real``, (N, b, C, H, W) float32."""
        cfg, n, k, b = self.cfg, self.n, self.k, self.cfg.batch_size
        if z is None:
            z = self.latents(st)
        g_net, d_net = st.g.modules[0], st.d.modules

        # (1) generate k*b fakes in one forward; the graph waits for (5)
        with self._autocast():
            x_all = g_net(z)
        img_shape = x_all.shape[1:]
        x_k = x_all.detach().view(k, b, *img_shape)

        # (2) fake batches per worker, (3) real batches and local D steps
        x_d = x_k[self._d_assign]
        d_loss_sum = torch.zeros(n, device=self.device)
        for _ in range(cfg.local_epochs):
            st.d.zero_grad()
            with self._autocast():
                loss = torch.stack([losses.d_loss(d(real[w]), d(x_d[w]))
                                    for w, d in enumerate(d_net)])
            loss.sum().backward()
            st.d.adam_step(cfg.discriminator_opt)
            d_loss_sum += loss.detach()
        mean_d_loss = d_loss_sum / cfg.local_epochs

        # (4) feedback through the updated discriminators
        x_g = x_k[self._g_assign].requires_grad_(True)
        with self._autocast():
            g_losses = torch.stack([losses.g_loss(d(x_g[w]))
                                    for w, d in enumerate(d_net)])
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

        The chunk's real batches are gathered in one sampling launch,
        (T, N, b, C, H, W): the shards are read-only during a chunk, so this
        equals a gather per round.  z: optional (T, k*b, z_dim) latents.
        """
        if z is not None and z.shape[0] != num_rounds:
            raise ValueError(f"z holds {z.shape[0]} rounds of latents, want {num_rounds}")
        idx = self.put_indices(sampler.next_chunk(num_rounds), data.shape[1])
        real = sample_normalize(data, idx)
        out: List[Dict[str, torch.Tensor]] = [
            self._round(st, real[t], None if z is None else z[t]) for t in range(num_rounds)]
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

    # ------------------------------------------------------------------
    # sampling (the reference's gen_images path)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def sample(self, g: NetState, num: int, seed: int) -> torch.Tensor:
        """``num`` images from lane (EVAL, seed) with train-mode BN, as
        ``sample_fn`` (``mdgan.py:596-608``); G's running stats are left as
        they were."""
        gen = prng.generator(seed, prng.EVAL, 0, device=self.device)
        z = torch.randn(num, self.spec.z_dim, generator=gen, device=self.device)
        saved = g.stats.clone()
        with self._autocast():
            out = g.modules[0](z)
        g.stats.copy_(saved)
        return out
