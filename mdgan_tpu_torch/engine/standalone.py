"""The single-device DCGAN baseline (``--mode standalone``).

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
local epoch.  A chunk's real batches are gathered in one sampling launch
(N=1).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from mdgan_tpu_torch.engine.mdgan import EngineBase
from mdgan_tpu_torch.engine.state import StandaloneState
from mdgan_tpu_torch.ops import losses
from mdgan_tpu_torch.ops.sampling import sample_normalize


class StandaloneEngine(EngineBase):
    """One generator against one discriminator on one device."""

    def init_state(self, seed: int) -> StandaloneState:
        """G from lane INIT_G, D from lane (INIT_D, 0)."""
        return StandaloneState(g=self.new_generator(seed),
                               d=self._new_discriminators(seed, 1), seed=seed)

    def put_data(self, data: np.ndarray) -> torch.Tensor:
        """The (S, H, W, C) uint8 dataset, resident on the device as a
        one-shard stack (1, S, H, W, C)."""
        if data.dtype != np.uint8 or data.ndim != 4:
            raise ValueError(f"data must be (S, H, W, C) uint8, got {data.shape} {data.dtype}")
        return torch.from_numpy(np.ascontiguousarray(data)[None]).to(self.device)

    def latents(self, st: StandaloneState) -> torch.Tensor:
        """This round's b latents from lane (LATENT, step) (``standalone.py:68-72``)."""
        return self._latents(st.step, st.seed, self.cfg.batch_size)

    def step(self, st: StandaloneState, data: torch.Tensor, idx: torch.Tensor,
             z: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One round, updating ``st`` in place.  data: (1, S, H, W, C) uint8;
        idx: (1, b) int32, both on the device; z: optional (b, z_dim)."""
        return self._round(st, sample_normalize(data, idx)[0], z)

    def _round(self, st: StandaloneState, real: torch.Tensor,
               z: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The round's body on its real batch ``real``, (b, C, H, W) float32."""
        cfg = self.cfg
        if z is None:
            z = self.latents(st)
        g_net, d_net = st.g.modules[0], st.d.modules[0]
        g_params = list(g_net.parameters())

        # (1) the round's fake batch; this forward's G statistics are dropped
        fake0 = self.generate(st.g, z)

        d_sum = torch.zeros((), device=self.device)
        g_sum = torch.zeros((), device=self.device)
        for _ in range(cfg.local_epochs):
            # (2) D step on (real, fake0)
            st.d.zero_grad()
            with self._autocast():
                d_loss = losses.d_loss(d_net(real), d_net(fake0))
            d_loss.backward()
            st.d.adam_step(cfg.discriminator_opt)
            # (3) G step against the updated D; gradients land in G's arena
            # only, so D's arena holds nothing the next D step would add to
            st.g.zero_grad()
            with self._autocast():
                g_loss = losses.g_loss(d_net(g_net(z)))
            g_loss.backward(inputs=g_params)
            st.g.adam_step(cfg.generator_opt)
            d_sum += d_loss.detach()
            g_sum += g_loss.detach()
        st.step += 1
        return {"mean_d_loss": d_sum / cfg.local_epochs,
                "mean_g_loss": g_sum / cfg.local_epochs,
                "x_eval": fake0}

    def run_rounds(self, st: StandaloneState, data: torch.Tensor, sampler, num_rounds: int,
                   z: Optional[torch.Tensor] = None) -> Dict:
        """One chunk of ``num_rounds`` rounds with indices from ``sampler``
        (a ``ShardSampler`` over one shard), the analogue of ``chunk_fn``:
        ``mean_d_loss`` and ``mean_g_loss`` (T,), ``x_eval`` the last
        round's fake batch, and ``idx`` the chunk's host indices (T, 1, b).
        The chunk's real batches are gathered in one sampling launch.
        z: optional (T, b, z_dim) latents."""
        if z is not None and z.shape[0] != num_rounds:
            raise ValueError(f"z holds {z.shape[0]} rounds of latents, want {num_rounds}")
        idx = sampler.next_chunk(num_rounds)
        real = sample_normalize(data, self.put_indices(idx, data.shape[1]))
        out: List[Dict[str, torch.Tensor]] = [
            self._round(st, real[t, 0], None if z is None else z[t]) for t in range(num_rounds)]
        stacked = {key: torch.stack([m[key] for m in out])
                   for key in ("mean_d_loss", "mean_g_loss")}
        stacked["x_eval"] = out[-1]["x_eval"]
        stacked["idx"] = idx
        return stacked
