"""The single-device GAN baseline (``--mode standalone``).

Port of ``mdgan_tpu/engine/standalone.py:33-163``.  Per round (``_step``,
``:64-124``):

 1. One fake batch ``fake0`` from the round-start generator, fixed for the
    whole round (``:74-76``).  That forward's new BN statistics are
    discarded, as ``fake0, _ = apply_train(...)`` discards them.
 2. ``local_epochs`` times: a D Adam step on ``BCE(D(real), 1) +
    BCE(D(fake0), 0)`` (two sequential train-mode forwards, each writing D's
    running statistics, which is what the JAX pair forward's chained rule
    reproduces, ``:78-83``); then a G Adam step on ``BCE(D(G(z)), 1)``
    against the UPDATED D, with G's forward recomputed at the current G
    params (``:85-94``).  That D(fake) forward updates D's BN statistics
    too (``:89-90``), and G's statistics come from its forward.

D and G are each a :class:`NetState` with n=1: one Adam launch per net per
local epoch.  A chunk runs through the MD-GAN engine's loop
(``EngineBase.run_rounds``), its real batches gathered as there (N=1): one
sampling launch a chunk unless its output passes ``GATHER_CAP_BYTES``.  A
discriminator with dropout keys its masks as the JAX round splits its
dropout key (``:98-99``): local epoch i's D step by (step, i, 0, half), its
G step's D forward by (step, i, 1).  A generator that takes noise gets the
round's b samples of each noise input (``EngineBase.g_inputs``: given, or
drawn from lane (NOISE, step, input)) in both of its forwards.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from mdgan_tpu_torch.engine.mdgan import EngineBase, Masks, run_generator
from mdgan_tpu_torch.engine.state import StandaloneState
from mdgan_tpu_torch.obs.spans import phase
from mdgan_tpu_torch.ops import losses
from mdgan_tpu_torch.ops.sampling import sample_normalize


class StandaloneEngine(EngineBase):
    """One generator against one discriminator on one device."""

    def init_state(self, seed: int) -> StandaloneState:
        """G from lane INIT_G, D from lane (INIT_D, 0)."""
        return StandaloneState(g=self.new_generator(seed),
                               d=self._new_discriminators(seed, [0]), seed=seed)

    def put_data(self, data: np.ndarray) -> torch.Tensor:
        """The (S, H, W, C) uint8 dataset, resident on the device as a
        one-shard stack (1, S, H, W, C)."""
        if data.dtype != np.uint8 or data.ndim != 4:
            raise ValueError(f"data must be (S, H, W, C) uint8, got {data.shape} {data.dtype}")
        return torch.from_numpy(np.ascontiguousarray(data)[None]).to(self.device)

    def step(self, st: StandaloneState, data: torch.Tensor, idx: torch.Tensor,
             z: Optional[torch.Tensor] = None,
             masks: Optional[Masks] = None) -> Dict[str, torch.Tensor]:
        """One round, updating ``st`` in place.  data: (1, S, H, W, C) uint8;
        idx: (1, b) int32, both on the device; z: optional (b, z_dim);
        masks: optional dropout keep masks by key path, (i, 0, half) and
        (i, 1) (tests inject JAX's)."""
        with phase("engine.sample"):
            real = sample_normalize(data, idx)
        return self._round(st, real, z, masks)

    def _round(self, st: StandaloneState, real: torch.Tensor, z: Optional[torch.Tensor],
               masks: Optional[Masks] = None,
               noise: Optional[List[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """The round's body on its one shard's real batch ``real``, (1, b, C,
        H, W) float32, with the round's latents ``z`` and noise (each drawn
        from its lane when None, :meth:`g_inputs`)."""
        cfg, real = self.cfg, real[0]
        with phase("engine.round", st.step):
            inputs = self.g_inputs(st, z, noise)
            g_net, d_net = st.g.modules[0], st.d.modules[0]
            g_params = list(g_net.parameters())

            def d_fwd(x, *path):
                return self._d_forward(d_net, x, st.seed, st.step, path, masks)

            # (1) the round's fake batch; this forward's G statistics are dropped
            with phase("engine.generate"):
                fake0 = self.generate(st.g, inputs[0], inputs[1:])

            d_sum = torch.zeros((), device=self.device)
            g_sum = torch.zeros((), device=self.device)
            for i in range(cfg.local_epochs):
                # (2) D step on (real, fake0)
                with phase("engine.d_step"):
                    st.d.zero_grad()
                    with self._autocast():
                        d_loss = losses.d_loss(d_fwd(real, i, 0, 0), d_fwd(fake0, i, 0, 1))
                    d_loss.backward()
                    st.d.adam_step(cfg.discriminator_opt)
                # (3) G step against the updated D; gradients land in G's arena
                # only, so D's arena holds nothing the next D step would add to
                with phase("engine.g_update"):
                    st.g.zero_grad()
                    with self._autocast():
                        g_loss = losses.g_loss(d_fwd(run_generator(g_net, inputs), i, 1))
                    g_loss.backward(inputs=g_params)
                    st.g.adam_step(cfg.generator_opt)
                d_sum += d_loss.detach()
                g_sum += g_loss.detach()
            st.step += 1
            return {"mean_d_loss": d_sum / cfg.local_epochs,
                    "mean_g_loss": g_sum / cfg.local_epochs,
                    "x_eval": fake0}

    def _chunk_metrics(self, stacked: Dict[str, torch.Tensor], idx: np.ndarray) -> Dict:
        """A chunk's metrics (:meth:`run_rounds`): ``mean_d_loss`` and
        ``mean_g_loss`` (T,), ``x_eval`` the last round's fake batch, and
        ``idx`` the chunk's host indices (T, 1, b)."""
        return {**stacked, "idx": idx}
