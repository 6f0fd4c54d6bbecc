"""Pins over the port's recorded runs (``artifacts_torch/``), each the
counterpart of a test in ``tests/test_golden_artifacts.py`` or
``tests/test_convergence_artifacts.py``, and the two checks that hold them
against the JAX package's records (``artifacts/``), fixed before any run:

(a) whether the golden N=8 run's D-loss window mean m (the mean over
    workers of each worker's mean ``mean_d_loss`` over rounds 1000-1999)
    satisfies |m_port(42) - m_jax(42)| <= max(3 |m_port(42) - m_port(43)|,
    0.05), the port's seed-43 twin giving its own seed-to-seed spread;
(b) whether the standalone leg's best standard-protocol FID is below every
    MD-GAN leg's (N=2, 4, 8), the reference's conclusion as JAX reproduced it.

Both missed on the card; the tests pin the recorded values and verdicts
(``CHECK_A``, ``CHECK_B``; ROADMAP C.6).

Recorded on the card by ``python -m mdgan_tpu_torch.cli.record_artifacts``
(each run's MANIFEST.md names the card and its power limit).  FID values
compare only within the port: the two packages' random-init Inception
weights differ.  Read with the JAX package's tooling, so the records stay
readable by it.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path

import numpy as np
import pytest

from mdgan_tpu.cli import analyze as janalyze
from mdgan_tpu.obs import spans as jspans

ROOT = Path(__file__).resolve().parents[1]
ART = ROOT / "artifacts_torch"
JAX_ART = ROOT / "artifacts"
GOLDEN = ART / "golden" / "cifar10_w8_r2000"
SEED43 = ART / "golden" / "cifar10_w8_r2000_seed43"
GOLDEN_SA = ART / "golden" / "cifar10_standalone_r2000"
HEADLINE = ART / "headline" / "cifar10_w8_r30000"
CONV = ART / "convergence"

pytestmark = pytest.mark.skipif(not ART.exists(), reason="the port's runs not recorded")

EPOCHS = 30000
# the standard protocol at every 10th eval event (log_interval 300) and the final round
STD_ROUNDS = list(range(0, EPOCHS, 3000)) + [EPOCHS - 1]
RECORDED = [GOLDEN, SEED43, ART / "golden" / "cifar10_w8_r2000_float32", GOLDEN_SA, HEADLINE,
            CONV / "cifar10_standalone_r30000", CONV / "cifar10_w2_r30000",
            CONV / "cifar10_w4_r30000"]


def _worker_csv(logs: Path, n: int, w: int) -> Path:
    plain = logs / f"mdgan.{n}.CIFAR10.worker.{w}.logs.csv"
    return plain if plain.exists() else Path(f"{plain}.gz")


def _workers(logs: Path, n: int):
    return [jspans.read_spans(_worker_csv(logs, n, w)) for w in range(1, n + 1)]


def _window_mean(logs: Path, n: int, lo: int, hi: int) -> float:
    """The mean over workers of each worker's mean D loss over rounds lo..hi."""
    return float(np.mean([np.mean([r["mean_d_loss"] for r in rows if lo <= r["epoch"] <= hi])
                          for rows in _workers(logs, n)]))


def _std_series(rows):
    return [(int(r["epoch"]), r["fid_standard"]) for r in rows
            if isinstance(r.get("fid_standard"), float)]


def _swap_partners(workers):
    partners = {}
    for w, rows in enumerate(workers, start=1):
        for r in rows:
            if isinstance(r.get("swap_with"), float):
                partners.setdefault(int(r["epoch"]), {})[w] = int(r["swap_with"])
    return partners


@pytest.mark.parametrize("run", RECORDED, ids=lambda p: p.relative_to(ART).as_posix())
def test_run_summary_and_manifest(run):
    summary = json.loads((run / "summary.json").read_text())
    assert summary["rounds"] in (2000, EPOCHS)
    assert summary["all_finite"]
    assert np.isfinite(summary["final_mean_d_loss"])
    assert summary["steps_per_sec"] > 0
    assert "H100" in summary["device"]
    manifest = (run / "MANIFEST.md").read_text()
    assert "python -m mdgan_tpu_torch.cli.train" in manifest
    assert "H100" in manifest and " W" in manifest  # the card and its power limit
    assert "random-init" in manifest


def test_golden_server_csv():
    server = GOLDEN / "logs" / "mdgan.8.CIFAR10.server.logs.csv"
    rep = janalyze.analyze_file(server)
    assert rep["rounds"] == 2000
    assert [e for e, _ in rep["fid_curve"]] == [0, 300, 600, 900, 1200, 1500, 1800, 1999]
    assert rep["ops"]["swap"]["count"] == 3
    assert rep["ops"]["checkpoint"]["count"] == 1
    summary = json.loads((GOLDEN / "summary.json").read_text())
    assert {(int(e), round(f, 6)) for e, f in rep["fid_curve"]} == {
        (e["epoch"], round(e["fid"], 6)) for e in summary["evals"]}
    # the 10k-sample standard protocol at every eval
    std = _std_series(jspans.read_spans(server))
    assert [e for e, _ in std] == [0, 300, 600, 900, 1200, 1500, 1800, 1999]
    assert all(np.isfinite(v) for _, v in std)


@pytest.mark.parametrize("run", [GOLDEN, SEED43], ids=["seed42", "seed43"])
def test_golden_worker_csvs(run):
    workers = _workers(run / "logs", 8)
    for rows in workers:
        assert [int(r["epoch"]) for r in rows] == list(range(2000))
        assert np.isfinite([r["mean_d_loss"] for r in rows]).all()
    partners = _swap_partners(workers)
    assert sorted(partners) == [500, 1000, 1500]
    for mapping in partners.values():  # each swap a pairing of the 8 workers
        assert sorted(mapping) == list(range(1, 9))
        assert all(mapping[p] == w and p != w for w, p in mapping.items())
    summary = json.loads((run / "summary.json").read_text())
    assert np.mean([rows[-1]["mean_d_loss"] for rows in workers]) == pytest.approx(
        summary["final_mean_d_loss"], rel=1e-6)


def test_golden_host_metrics():
    path = GOLDEN / "logs" / "host.csv"
    assert janalyze.is_host_csv(path)
    rep = janalyze.analyze_host_file(path)
    assert rep["rows"] > 10 and rep["mem_max_mb"] > 100


def test_golden_generator_export_matches_flax():
    """The port's exported generator loads through JAX's codec, and flax's
    DCGAN-32 and the port's give the same train-mode images from it."""
    import jax
    import jax.numpy as jnp
    import torch

    from mdgan_tpu.models.dcgan32 import DCGANGenerator32 as JaxG
    from mdgan_tpu.utils import checkpoint as jckpt
    from mdgan_tpu_torch.models import from_jax
    from mdgan_tpu_torch.models.dcgan32 import DCGANGenerator32

    path = GOLDEN / "weights" / "generator_final.npz"
    params, stats = jckpt.load_weights_only(path)
    z = np.random.default_rng(0).standard_normal((8, 100)).astype(np.float32)
    want, _ = JaxG().apply({"params": params, "batch_stats": stats}, jnp.asarray(z),
                           train=True, mutable=["batch_stats"])
    port = from_jax.load_into(DCGANGenerator32(), *from_jax.load_npz(path)).train()
    with torch.no_grad():
        got = port(torch.from_numpy(z)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == (8, 32, 32, 3)
    assert float(np.abs(got - np.asarray(want)).max()) <= 2e-4
    d_params, d_stats = jckpt.load_weights_only(
        GOLDEN / "weights" / "worker_1" / "discriminator.npz")
    assert jax.tree.leaves(d_params) and jax.tree.leaves(d_stats)


def test_standalone_golden():
    rows = list(csv.DictReader(open(GOLDEN_SA / "logs" / "CIFAR10.standalone.logs.csv")))
    evals = [(int(r["epoch"]), float(r["fid"])) for r in rows if r["fid"]]
    assert [e for e, _ in evals] == [0, 300, 600, 900, 1200, 1500, 1800]
    summary = json.loads((GOLDEN_SA / "summary.json").read_text())
    assert {(e, round(f, 6)) for e, f in evals} == {
        (e["epoch"], round(e["fid"], 6)) for e in summary["evals"]}
    assert summary["rounds"] == 2000 and np.isfinite(summary["final_mean_g_loss"])


def test_headline_run():
    summary = json.loads((HEADLINE / "summary.json").read_text())
    assert summary["rounds"] == EPOCHS and len(summary["evals"]) == 101
    server = HEADLINE / "logs" / "mdgan.8.CIFAR10.server.logs.csv"
    rep = janalyze.analyze_file(server)
    assert rep["rounds"] == EPOCHS
    assert rep["ops"]["fid"]["count"] == 101
    assert rep["ops"]["swap"]["count"] == 5
    assert rep["ops"]["checkpoint"]["count"] == 10  # every 3000 and the final round
    assert rep["best_fid"] == pytest.approx(min(e["fid"] for e in summary["evals"]))
    assert [e for e, _ in _std_series(jspans.read_spans(server))] == STD_ROUNDS
    workers = _workers(HEADLINE / "logs", 8)
    assert all(len(rows) == EPOCHS for rows in workers)
    partners = _swap_partners(workers)
    assert sorted(partners) == list(range(5000, EPOCHS, 5000))
    for mapping in partners.values():
        assert all(mapping[p] == w and p != w for w, p in mapping.items())


@pytest.mark.parametrize("leg,n", [("cifar10_standalone_r30000", 1), ("cifar10_w2_r30000", 2),
                                   ("cifar10_w4_r30000", 4)])
def test_convergence_leg(leg, n):
    out = CONV / leg
    summary = json.loads((out / "summary.json").read_text())
    assert summary["rounds"] == EPOCHS
    if n == 1:
        rows = jspans.read_spans(out / "logs" / "CIFAR10.standalone.logs.csv")
        assert np.isfinite(summary["final_mean_g_loss"])
        # no 5-sample eval at the final round in standalone, as in the reference
        assert [int(r["epoch"]) for r in rows if isinstance(r.get("fid"), float)] == list(
            range(0, EPOCHS, 300))
    else:
        rows = jspans.read_spans(out / "logs" / f"mdgan.{n}.CIFAR10.server.logs.csv")
        assert len([r for r in rows if r.get("swap") in (True, "True", 1.0)]) == 5
        assert (out / "logs" / f"mdgan.{n}.CIFAR10.worker.1.logs.csv").exists()
        workers = _workers(out / "logs", n)
        assert all(len(w) == EPOCHS for w in workers)
        for mapping in _swap_partners(workers).values():
            assert all(mapping[p] == w and p != w for w, p in mapping.items())
    series = _std_series(rows)
    assert [e for e, _ in series] == STD_ROUNDS
    assert all(np.isfinite(v) for _, v in series)


def test_comparison_consistent_with_series():
    comp = json.loads((CONV / "COMPARISON.json").read_text())
    assert set(comp) == {"standalone", "mdgan_w2", "mdgan_w4", "mdgan_w8"}
    for rec in comp.values():
        assert [e for e, _ in rec["fid_standard"]] == STD_ROUNDS
        vals = [v for _, v in rec["fid_standard"]]
        assert rec["best_fid_standard"] == pytest.approx(min(vals))
        assert rec["final_fid_standard"] == pytest.approx(vals[-1])
    headline = jspans.read_spans(HEADLINE / "logs" / "mdgan.8.CIFAR10.server.logs.csv")
    assert [round(v, 2) for _, v in _std_series(headline)] == [
        v for _, v in comp["mdgan_w8"]["fid_standard"]]
    figs = {p.name for p in (CONV / "figures").glob("compare.*.png")}
    assert {"compare.fid_standard.png", "compare.is_standard.png"} <= figs


# Checks (a) and (b) as recorded on the card: both miss (ROADMAP C.6, with
# the bisection: one round of the port equals one round of JAX's engine
# at full width in float32, and JAX's own engine on the CPU reads the port's
# D-loss level, not its TPU recording's).  Nothing was re-seeded or re-run
# to move them; these pins hold the recorded values and verdicts, and a
# re-recording that moves them updates ROADMAP C.6 with them.
CHECK_A = {"m42": 0.6621247, "m43": 0.6396424, "jax": 1.1709855, "holds": False}
CHECK_B = {"best": {"standalone": 39.11, "mdgan_w2": 24.99, "mdgan_w4": 13.73,
                    "mdgan_w8": 11.70}, "holds": False}


def test_check_a_golden_d_loss_against_jax():
    want = _window_mean(JAX_ART / "golden" / "cifar10_w8_r2000" / "logs", 8, 1000, 1999)
    m42 = _window_mean(GOLDEN / "logs", 8, 1000, 1999)
    m43 = _window_mean(SEED43 / "logs", 8, 1000, 1999)
    assert (m42, m43, want) == pytest.approx(
        (CHECK_A["m42"], CHECK_A["m43"], CHECK_A["jax"]), abs=1e-6)
    holds = abs(m42 - want) <= max(3 * abs(m42 - m43), 0.05)
    assert holds == CHECK_A["holds"], (m42, m43, want)


def test_check_b_standalone_converges_best():
    best = {k: v["best_fid_standard"]
            for k, v in json.loads((CONV / "COMPARISON.json").read_text()).items()}
    assert best == CHECK_B["best"]
    holds = all(best["standalone"] < best[leg] for leg in ("mdgan_w2", "mdgan_w4", "mdgan_w8"))
    assert holds == CHECK_B["holds"], best


def test_records_fit_their_budget():
    size = sum(p.stat().st_size for p in ART.rglob("*") if p.is_file())
    assert size < 45e6
