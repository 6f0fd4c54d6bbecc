"""The yardstick's counts: parameters, FLOPs a round (frozen in the
configuration files) and the bytes the two kernels' rooflines charge; every
configuration of ``BENCHMARK.json`` and every cell, found by name."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import roofline, spec
from perfbench.reference.ops import Ops
from perfbench.tests import tiny

# DCGAN-32's parameter counts at the MD-GAN reference's widths (ngf = ndf =
# 64, z 100), counted from its layers
DCGAN32_PARAMS = (3_448_576, 663_296)
CONFIGS = [c["name"] for c in spec.benchmark()["configs"]]


def _config(name):
    """The first cell of configuration ``name``."""
    return spec.cell(next(w["name"] for w in spec.benchmark()["workloads"]
                          if w["config"] == name))


@pytest.mark.parametrize("name", CONFIGS)
def test_parameter_counts(name):
    cell = _config(name)
    g, d = (roofline.leaf_elements(cell.family, cell.config, n) for n in ("g", "d"))
    assert (g, d) == (cell.config["g_params"], cell.config["d_params"])
    if name == "dcgan32_cifar10":
        assert (g, d) == DCGAN32_PARAMS


@pytest.mark.parametrize("name", CONFIGS)
def test_leaves_are_the_programs_parameters(name):
    from mdgan_tpu_torch.core.registry import get

    cell = _config(name)
    port = get(cell.config["dataset"])
    kw = {k: cell.config[k] for k in cell.family.WIDTHS}
    for net, make, widths in (("g", port.make_generator, port.g_widths),
                              ("d", port.make_discriminator, port.d_widths)):
        module = make(**{k: v for k, v in kw.items() if k in widths})
        want = {n: tuple(p.shape) for n, p in module.named_parameters()}
        assert {n: tuple(s) for n, s, _ in cell.family.leaves(cell.config, net)} == want


@pytest.mark.parametrize("name", CONFIGS)
def test_frozen_flops_per_sample(name):
    cell = _config(name)
    assert roofline.per_sample_flops(cell.family, cell.config, batch=3) == \
        cell.config["flops_per_sample"]


def _meta_round_flops(cell) -> int:
    """FlopCounterMode over one whole reference round at the cell's shapes,
    on the meta device."""
    cfg, traffic, mode = cell.config, cell.traffic, cell.mode
    meta = torch.device("meta")
    n, b = traffic["num_workers"], traffic["batch_size"]
    h, w, c = cfg["image_shape"]

    def leaves(net):
        return {k: torch.empty(s, device=meta) for k, s, _ in cell.family.leaves(cfg, net)}

    per_round = mode.latents_per_round(traffic)
    reals = [torch.empty(n, b, c, h, w, device=meta)]
    zs = [torch.empty(per_round, cfg["z_dim"], device=meta)]
    shapes = spec.noise_shapes(cell.family, cfg)
    extra = {} if shapes is None else {
        "noise": [torch.zeros(1, per_round, *s, device=meta) for s in shapes]}
    with FlopCounterMode(display=False) as counter:
        mode.reference(cell.family, cfg, traffic, leaves("g"), [leaves("d") for _ in range(n)],
                       reals, zs, Ops("float32"), **extra)
    return counter.get_total_flops()


@pytest.mark.parametrize("name", tiny.cells())
def test_round_flops_formula(name):
    cell = spec.cell(name)
    assert cell.mode.flops_per_round(cell.config, cell.traffic) == _meta_round_flops(cell)


def test_headline_round_flops():
    cell = spec.cell("dcgan32_mdgan_n8")
    assert cell.mode.flops_per_round(cell.config, cell.traffic) == 30_542_397_440


@pytest.mark.parametrize("traffic,adam,sampling", [
    ("mdgan_n8_c100", 245_138_432, 1_229_120),
    ("standalone_c100", 115_132_416, 10 * (32 * 32 * 3 * 5 + 4)),
    # one rank of four: G and 2 of the 8 discriminators, 20 rows
    ("mdgan_n8_c100_r4", 28 * (3_448_576 + 2 * 663_296), 20 * (32 * 32 * 3 * 5 + 4)),
])
def test_kernel_bytes_a_round(traffic, adam, sampling):
    cfg = spec.cell("dcgan32_mdgan_n8").config
    traffic = json.loads((spec.HERE / "traffic" / f"{traffic}.json").read_text())
    mode = spec.mode(traffic["mode"])
    assert roofline.adam_bytes(mode.adam_elements_per_round(cfg, traffic),
                               cfg["moment_dtype"]) == adam
    assert roofline.sampling_bytes(mode.sampled_rows_per_round(traffic),
                                   cfg["image_shape"]) == sampling
