"""What the modes share in driving the port: its training configuration at a
cell's sizes, the benchmark's weights in a fresh state, the shards, a chunk
through ``run_rounds`` (with the generator's noise where the family takes
any), and an arena's leaves by the reference's names."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from perfbench import inputs


def train_config(cfg: dict, traffic: dict, device):
    """The port's ``TrainConfig``: Adam as the configuration states it, for
    the generator and every discriminator."""
    from mdgan_tpu_torch.core.config import OptimizerConfig, TrainConfig

    opt = OptimizerConfig(lr=cfg["lr"], beta_1=cfg["beta_1"], beta_2=cfg["beta_2"],
                          eps=cfg["eps"], mu_dtype=cfg["moment_dtype"],
                          nu_dtype=cfg["moment_dtype"])
    return TrainConfig(batch_size=traffic["batch_size"], local_epochs=cfg["local_epochs"],
                       chunk_size=traffic["chunk"], compute_dtype=cfg["compute_dtype"],
                       generator_opt=opt, discriminator_opt=opt, device=str(device))


class Program:
    """The port's engine ``eng`` at a cell's shapes, holding this process's
    ``workers``; a mode builds the engine and names the ``losses`` its
    ``run_rounds`` returns."""

    losses: tuple = ()

    def __init__(self, eng, cfg: dict, device, workers: List[int], shard_size: int):
        self.eng, self.cfg, self.device = eng, cfg, torch.device(device)
        self.workers, self.shard_size = workers, shard_size

    def state(self, seed: int, g: Dict[str, torch.Tensor], ds: Dict[int, Dict[str, torch.Tensor]]):
        """A fresh state holding the given weights (the program's own init
        is overwritten, leaf by leaf)."""
        st = self.eng.init_state(seed)
        with torch.no_grad():
            for name, p in st.g.modules[0].named_parameters():
                p.copy_(g[name])
            for i, w in enumerate(self.workers):
                for name, p in st.d.modules[i].named_parameters():
                    p.copy_(ds[w][name])
        return st

    def data(self, seed: int) -> torch.Tensor:
        """This process's shards, (workers, S, H, W, C) uint8 on the device."""
        out = torch.empty((len(self.workers), self.shard_size, *self.cfg["image_shape"]),
                          dtype=torch.uint8, device=self.device)
        for i, w in enumerate(self.workers):
            inputs.shard(self.device, seed, w, self.shard_size, self.cfg["image_shape"], out[i])
        return out

    def chunk(self, st, data, sampler, num_rounds: int, z,
              noise: Optional[List[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """``run_rounds`` on the chunk's latents and, where the family takes
        noise, its noise (``inputs.noise``)."""
        extra = {} if noise is None else {"noise": noise}
        m = self.eng.run_rounds(st, data, sampler, num_rounds, z=z, **extra)
        return {k: m[k] for k in self.losses}

    def leaves(self, st, arena: str) -> Dict[str, torch.Tensor]:
        """This process's leaves of an arena (``params`` or ``mu``), by the
        reference's leaf names."""
        out = {f"g/{k}": v for k, v in st.g.views(getattr(st.g, arena), 0).items()}
        for i, w in enumerate(self.workers):
            out.update({f"d{w}/{k}": v for k, v in st.d.views(getattr(st.d, arena), i).items()})
        return out
