"""The MD-GAN mode: the program's ``MDGANEngine.run_rounds``, and the
reference's MD-GAN round.

Traffic keys: ``num_workers`` (N), ``batch_size`` (b), ``chunk`` (rounds a
``run_rounds`` call), ``traced_chunks``, ``device_rounds`` (the rounds of
the chunk ``device_ms_per_round`` reads), ``ranks`` (processes, one card
each; the discriminators are split over them).
"""

from __future__ import annotations

from typing import List

from perfbench import program
from perfbench.reference import rounds

LOSSES = ("mean_d_loss", "g_feedback_loss", "feedback_norm")


def latents_per_round(traffic: dict) -> int:
    return rounds.k_batches(traffic["num_workers"]) * traffic["batch_size"]


def shard_size(cfg: dict, traffic: dict) -> int:
    return cfg["num_images"] // traffic["num_workers"]


def flops_per_round(cfg: dict, traffic: dict) -> int:
    """The reference round's FLOPs from the configuration's per-sample
    counts: k*b generated and pushed back through G; per worker, local
    epochs of two b-sample forwards and the backward to D's parameters, then
    the feedback's forward and backward to the images."""
    f = cfg["flops_per_sample"]
    n, b, e = traffic["num_workers"], traffic["batch_size"], cfg["local_epochs"]
    kb = latents_per_round(traffic)
    return (kb * (f["g_fwd"] + f["g_bwd"])
            + n * (e * 2 * b * (f["d_fwd"] + f["d_bwd_train"]) + b * (f["d_fwd"] + f["d_bwd_input"])))


def adam_elements_per_round(cfg: dict, traffic: dict) -> int:
    """Parameters Adam updates a round on one rank: G once, each of the
    rank's N/ranks discriminators once a local epoch."""
    per_rank = traffic["num_workers"] // traffic.get("ranks", 1)
    return cfg["g_params"] + cfg["local_epochs"] * per_rank * cfg["d_params"]


def sampled_rows_per_round(traffic: dict) -> int:
    """Real rows one rank gathers a round: b for each of its workers."""
    return traffic["num_workers"] // traffic.get("ranks", 1) * traffic["batch_size"]


class Program(program.Program):
    """The port's MD-GAN engine at a cell's shapes, on this process's rank."""

    losses = LOSSES

    def __init__(self, fam, cfg: dict, traffic: dict, device):
        from mdgan_tpu_torch.core.registry import get as get_spec
        from mdgan_tpu_torch.engine.mdgan import MDGANEngine

        eng = MDGANEngine(get_spec(cfg["dataset"]), program.train_config(cfg, traffic, device),
                          traffic["num_workers"], model_kwargs={k: cfg[k] for k in fam.WIDTHS})
        super().__init__(eng, cfg, device, list(eng.layout.workers), shard_size(cfg, traffic))


def reference(fam, cfg: dict, traffic: dict, g, ds: List[dict], reals, zs, ops, fault=None,
              noise=None):
    return rounds.mdgan_rounds(fam, cfg, traffic["num_workers"], g, ds, reals, zs, ops, fault,
                               noise)
