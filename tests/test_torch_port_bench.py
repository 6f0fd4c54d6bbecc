"""The port's benchmark (``mdgan_tpu_torch/cli/bench.py``) on the CPU.

Every config is patched to 2 workers, b=2 and chunks of 2 rounds; each line
is held to the JAX bench's own committed line of the same metric
(``BENCH_r05.json``'s ``parsed`` and ``artifacts/bench/BENCH_*.json``): the
same keys, less the two bytes keys that only XLA's cost model gives, plus
the port's additions; on the CPU also less the H100's peak and ``mfu``.
The FLOPs of one full-width headline round are held to the band of
``tests/test_bench_artifacts.py`` and to JAX's count.
"""

import json
import math
from pathlib import Path

import pytest
import torch

from mdgan_tpu_torch.cli import bench

ROOT = Path(__file__).resolve().parents[1]
# JAX's bytes fields come from XLA's fusion-boundary count: no counterpart
LEFT_OUT = {"bytes_per_round", "hbm_util_analytical"}
ADDED = {"compute_dtype", "power_limit_w", "flops_counted"}
H100_ONLY = {"mfu", "peak_flops_per_sec", "peak_hbm_bytes_per_sec"}
TINY = {"headline": ("CIFAR10", 2, 2, 2, 1, 40), "mnist4": ("MNIST", 2, 2, 2, 1, 40),
        "bigbatch": ("CIFAR10", 2, 3, 2, 1, 40)}
H100 = {"device": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0}


def jax_keys() -> dict:
    """metric -> the keys of the JAX bench's newest committed line with
    float32 moments (the files of a config sort by round)."""
    rows = []
    for path in sorted((ROOT / "artifacts" / "bench").glob("BENCH_*.json")):
        rows += [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    rows.append(json.loads((ROOT / "BENCH_r05.json").read_text())["parsed"])
    return {row["metric"]: set(row) for row in rows if "moment_dtype" not in row}


JAX = jax_keys()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def tiny(monkeypatch):
    monkeypatch.setattr(bench, "CONFIGS", dict(TINY))
    monkeypatch.setattr(bench, "STANDALONE", ("MNIST", 2, 2, 1, 40))
    monkeypatch.setattr(bench, "SCALING_WORKERS", (2, 4))


def check_line(row: dict, jax_metric: str, on_h100: bool = False):
    want = JAX[jax_metric] - LEFT_OUT | ADDED
    if not on_h100:
        want -= H100_ONLY
    assert set(row) == want, (sorted(set(row) - want), sorted(want - set(row)))
    assert row["unit"] == "rounds/s"
    for key, value in row.items():
        if isinstance(value, float):
            assert math.isfinite(value), key
    assert row["value"] > 0 and row["wall_s"] > 0
    assert 0 < row["flops_per_round"] < 1e12
    if "vs_baseline" in row:
        assert row["vs_baseline"] == pytest.approx(row["value"] / 7.63)
    if on_h100:
        peak = bench.H100_PEAK_FLOPS[row["compute_dtype"]]
        assert row["mfu"] == pytest.approx(row["flops_per_round"] * row["value"] / peak)
    else:
        assert row["device"] == "cpu" and row["power_limit_w"] is None


@pytest.mark.parametrize("name,metric", [
    ("headline", "mdgan_cifar10_8worker_steps_per_sec"),
    ("mnist4", "mdgan_mnist_4worker_steps_per_sec"),
    ("bigbatch", "mdgan_cifar10_8worker_b256_steps_per_sec"),
])
def test_bench_mdgan_line(tiny, name, metric):
    row = bench.bench_mdgan(name, device="cpu")
    check_line(row, metric)
    dataset, n, b, chunk, n_chunks, _ = TINY[name]
    assert row["metric"] == {"headline": metric,
                             "mnist4": "mdgan_mnist_2worker_steps_per_sec",
                             "bigbatch": "mdgan_cifar10_2worker_b3_steps_per_sec"}[name]
    assert (row["num_workers"], row["batch_size"]) == (n, b)
    assert row["steps_timed"] == chunk * n_chunks
    assert row["images_per_sec_per_chip"] == pytest.approx(row["value"] * b * n)
    assert row["compute_dtype"] == "bfloat16"


def test_bench_mdgan_moment_dtype_and_float32(tiny):
    row = bench.bench_mdgan("headline", "bfloat16", compute_dtype="float32", device="cpu")
    assert row["moment_dtype"] == "bfloat16" and row["compute_dtype"] == "float32"
    row.pop("moment_dtype")
    check_line(row, "mdgan_cifar10_8worker_steps_per_sec")


def test_bench_standalone_line(tiny):
    check_line(bench.bench_standalone("cpu"), "standalone_mnist_steps_per_sec")


def test_bench_sustained_line(tiny):
    row = bench.bench_sustained(rounds=4, warm_rounds=2, device="cpu")
    check_line(row, "mdgan_cifar10_8worker_sustained_steps_per_sec")
    assert row["steps_timed"] == 4


def test_bench_scaling_lines(tiny):
    rows = bench.bench_scaling(device="cpu")
    assert [r["num_workers"] for r in rows] == [2, 4]
    for row in rows:
        check_line(row, "mdgan_cifar10_scaling_steps_per_sec")
    assert "_scaling" not in bench.CONFIGS


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_h100_line_leaves_out_only_the_bytes_keys(tiny, monkeypatch, compute_dtype):
    """On an H100 the headline line has every key of JAX's but the two bytes
    keys, and ``mfu`` against the dense tensor-core peak of its dtype."""
    monkeypatch.setattr(bench, "card", lambda device: dict(H100))
    row = bench.bench_mdgan("headline", compute_dtype=compute_dtype, device="cpu")
    check_line(row, "mdgan_cifar10_8worker_steps_per_sec", on_h100=True)
    assert set(JAX["mdgan_cifar10_8worker_steps_per_sec"]) - set(row) == LEFT_OUT
    assert row["peak_flops_per_sec"] == {"bfloat16": 989e12, "float32": 494.7e12}[compute_dtype]
    assert row["power_limit_w"] == 700.0


def test_headline_flops_per_round_in_band(monkeypatch):
    """One full-width headline round (DCGAN-32, N=8, b=10) under
    FlopCounterMode: within ``tests/test_bench_artifacts.py``'s band and
    within 0.5-2x of XLA's count of JAX's round."""
    monkeypatch.setitem(bench.CONFIGS, "headline", ("CIFAR10", 8, 10, 500, 6, 800))
    eng, st, shards, sampler = bench._setup_mdgan("headline", "float32", "bfloat16", "cpu")
    flops = bench.round_flops(eng, st, shards, sampler)
    jax_flops = json.loads((ROOT / "BENCH_r05.json").read_text())["parsed"]["flops_per_round"]
    assert 8e9 < flops < 9e10
    assert 0.5 < flops / jax_flops < 2.0
    assert st.step == 1  # the counted round ran


def test_main_prints_one_line_and_needs_a_device(tiny, capsys):
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    check_line(json.loads(lines[0]), "mdgan_cifar10_8worker_steps_per_sec")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            bench.main([])


def test_main_config_all_prints_every_config(tiny, monkeypatch, capsys):
    """``--config all``: a line for each config, then standalone and the
    sustained loop (its rounds cut here)."""
    sustained = bench.bench_sustained
    monkeypatch.setattr(bench, "bench_sustained",
                        lambda device=None: sustained(rounds=4, warm_rounds=2, device=device))
    assert bench.main(["--config", "all", "--device", "cpu"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert [r["metric"] for r in rows] == [
        "mdgan_cifar10_8worker_steps_per_sec", "mdgan_mnist_2worker_steps_per_sec",
        "mdgan_cifar10_2worker_b3_steps_per_sec", "standalone_mnist_steps_per_sec",
        "mdgan_cifar10_8worker_sustained_steps_per_sec"]
