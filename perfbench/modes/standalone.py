"""The standalone mode: the program's ``StandaloneEngine.run_rounds`` (one
generator, one discriminator), and the reference's standalone round.

Traffic keys: ``batch_size``, ``chunk``, ``traced_chunks``, ``device_rounds``
(the rounds of the chunk ``device_ms_per_round`` reads); ``num_workers`` is
1 and ``ranks`` 1.
"""

from __future__ import annotations

from typing import List

from perfbench import program
from perfbench.reference import rounds

LOSSES = ("mean_d_loss", "mean_g_loss")


def latents_per_round(traffic: dict) -> int:
    return traffic["batch_size"]


def shard_size(cfg: dict, traffic: dict) -> int:
    return cfg["num_images"]


def flops_per_round(cfg: dict, traffic: dict) -> int:
    """One b-sample G forward for the round's fake batch; per local epoch a D
    step (two forwards, the backward to D's parameters) and a G step (G
    forward, D forward, backward through D to the images and through G to
    its parameters)."""
    f, b, e = cfg["flops_per_sample"], traffic["batch_size"], cfg["local_epochs"]
    return b * f["g_fwd"] + e * (2 * b * (f["d_fwd"] + f["d_bwd_train"])
                                 + b * (f["g_fwd"] + f["d_fwd"] + f["d_bwd_input"] + f["g_bwd"]))


def adam_elements_per_round(cfg: dict, traffic: dict) -> int:
    return cfg["local_epochs"] * (cfg["g_params"] + cfg["d_params"])


def sampled_rows_per_round(traffic: dict) -> int:
    return traffic["batch_size"]


class Program(program.Program):
    """The port's standalone engine at a cell's shapes."""

    losses = LOSSES

    def __init__(self, fam, cfg: dict, traffic: dict, device):
        from mdgan_tpu_torch.core.registry import get as get_spec
        from mdgan_tpu_torch.engine.standalone import StandaloneEngine

        if traffic.get("num_workers", 1) != 1 or traffic.get("ranks", 1) != 1:
            raise ValueError("the standalone mode runs one discriminator in one process")
        eng = StandaloneEngine(get_spec(cfg["dataset"]), program.train_config(cfg, traffic, device),
                               model_kwargs={k: cfg[k] for k in fam.WIDTHS})
        super().__init__(eng, cfg, device, [0], shard_size(cfg, traffic))


def reference(fam, cfg: dict, traffic: dict, g, ds: List[dict], reals, zs, ops, fault=None,
              noise=None):
    return rounds.standalone_rounds(fam, cfg, g, ds[0], [r[0] for r in reals], zs, ops, fault,
                                    noise)
