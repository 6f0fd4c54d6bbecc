"""The port's recorder (``mdgan_tpu_torch/cli/record_artifacts.py``) against
the JAX recorder (``scripts/record_artifacts.py``), on the CPU.

Both recorders run each step with the training CLIs, the benches and the
profiler stubbed by one fake that writes a run's files and records its
arguments: the argv lists and bench configs handed over must be equal, with
``artifacts/`` mapped to ``artifacts_torch/``, ``/tmp/`` to the temporary
directory and the round tags (``_r4``, ``_r04``, ``_r05``) to ``_h100``, and
the two recorders must leave the same files.  The prune rules are held to
each other on one fabricated tree, and the port's golden and convergence
steps run for 6 rounds at width 8 through its CLI, leaving JAX's layout,
which JAX's ``cli.analyze`` reads.
"""

from __future__ import annotations

import dataclasses
import functools
import gzip
import importlib.util
import json
import re
import sys
import tempfile
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from mdgan_tpu.cli import analyze as janalyze
from mdgan_tpu.cli import train as jtrain
from mdgan_tpu.obs import spans as jspans
from mdgan_tpu_torch.cli import bench as pbench
from mdgan_tpu_torch.cli import profile_parts as pparts
from mdgan_tpu_torch.cli import record_artifacts as recorder
from mdgan_tpu_torch.cli import train as ptrain
from mdgan_tpu_torch.core import registry
from mdgan_tpu_torch.models import dcgan32

ROOT = Path(__file__).resolve().parents[1]
JAX_RECORDER = ROOT / "scripts" / "record_artifacts.py"
TAG = re.compile(r"_r0?[345](?![0-9])")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the narrow runs gain nothing from more, and
    threads spin against the other test processes beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_recorder(tmp_dir: Path):
    """``scripts/record_artifacts.py`` loaded by path, its ``/tmp/`` paths
    moved under ``tmp_dir`` (those under the test's own directory, its
    parent, stay)."""
    spec = importlib.util.spec_from_file_location("jax_record_artifacts", JAX_RECORDER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def mapped(*parts):
        p = Path(*parts)
        s = str(p)
        if s.startswith("/tmp/") and not s.startswith(str(tmp_dir.parent)):
            return tmp_dir / s[len("/tmp/"):]
        return p
    mod.Path = mapped
    return mod


def _eval_epochs(epochs: int, log: int):
    out = list(range(0, epochs, log))
    return out + ([epochs - 1] if out[-1] != epochs - 1 else [])


def fake_train(calls: list):
    """A training CLI's ``main``: records its argv, writes the files of a
    run (span CSVs, grids, exports, host metrics) and prints a summary."""
    def main(argv):
        calls.append(list(argv))
        a = ptrain.build_parser().parse_args(argv)
        logs, imgs, weights = Path(a.log_dir), Path(a.image_dir), Path(a.weights_dir)
        for d in (logs, imgs, weights):
            d.mkdir(parents=True, exist_ok=True)
        evals = _eval_epochs(a.epochs, a.log_interval)
        k = max(a.eval_standard_interval, 1)
        mdgan = a.mode == "mdgan"
        server = logs / (f"mdgan.{a.num_workers}.{a.dataset}.server.logs.csv" if mdgan
                         else f"{a.dataset}.standalone.logs.csv")
        cols = ["epoch", "fid", "is", "fid_standard", "is_standard"]
        if a.straggler_rate > 0:
            cols.append("n_feedbacks")
        rows = []
        for e in evals:
            std = a.eval_n_samples > 0 and ((e // a.log_interval) % k == 0 or e == a.epochs - 1)
            fid = 100.0 + (e * 7919 + a.seed * 31 + a.num_workers) % 997
            rows.append([e, fid, 1.5, fid * 2 if std else "", 1.2 if std else "",
                         *([7.0] if a.straggler_rate > 0 else [])])
        server.write_text(",".join(cols) + "\n"
                          + "".join(",".join(map(str, r)) + "\n" for r in rows))
        if mdgan:
            for w in range(1, a.num_workers + 1):
                (logs / f"mdgan.{a.num_workers}.{a.dataset}.worker.{w}.logs.csv").write_text(
                    "epoch,mean_d_loss,swap_with\n"
                    + "".join(f"{e},{1.0 + w / 100 + e / 1e5},\n" for e in evals))
        grid = "generated_epoch_{}.png" if mdgan else "fake_samples_{}.png"
        for e in evals:
            if mdgan or e % a.log_interval == 0:
                (imgs / grid.format(e)).write_bytes(b"png")
        (imgs / "real_images.png").write_bytes(b"png")
        if mdgan:
            for e in evals:
                (weights / f"generator_{e}.npz").write_bytes(b"npz")
            (weights / "generator_final.npz").write_bytes(b"npz")
            for w in range(1, a.num_workers + 1):
                (weights / f"worker_{w}").mkdir()
                (weights / f"worker_{w}" / "discriminator.npz").write_bytes(b"npz")
        else:
            for net in ("netG", "netD"):
                (weights / f"{net}_epoch_{a.epochs - 1}.npz").write_bytes(b"npz")
        if a.host_metrics:
            Path(a.host_metrics).write_text("time,cpu_percent\n0,1\n")
        print(json.dumps({"rounds": a.epochs, "wall_time_s": 1.0, "steps_per_sec": 1.0,
                          "final_mean_d_loss": 1.0 + a.seed / 100,
                          "feature_source": "random-init"}))
        return 0
    return main


def _bench_row(name, moment_dtype="float32", n_workers=8):
    return {"metric": f"bench_{name}", "value": 3.0, "num_workers": n_workers,
            "moment_dtype": moment_dtype}


def fake_bench(calls: list, argv_of):
    """The bench functions both recorders call, recording each call."""
    def bench_mdgan(name, moment_dtype="float32", **kw):
        calls.append(("bench_mdgan", name, moment_dtype))
        return _bench_row(name, moment_dtype)

    def bench_standalone(**kw):
        calls.append(("bench_standalone",))
        return _bench_row("standalone")

    def bench_scaling(moment_dtype="float32", **kw):
        calls.append(("bench_scaling", moment_dtype))
        return [_bench_row("scaling", moment_dtype, n) for n in (1, 2, 4, 8)]

    def main(argv=None):
        calls.append(("main", *argv_of(argv)))
        print(json.dumps(_bench_row("main")))
        return 0
    return dict(bench_mdgan=bench_mdgan, bench_standalone=bench_standalone,
                bench_scaling=bench_scaling, main=main)


def _map_jax(token, base: Path, jroot: Path, proot: Path, tmp_dir: Path):
    """A JAX recorder's argv token as the port's recorder should give it."""
    if not isinstance(token, str):
        return token
    token = token.replace(str(jroot / "artifacts"), str(proot / recorder.ARTIFACTS))
    if token.startswith("/tmp/") and not token.startswith(str(base)):
        token = str(tmp_dir / token[len("/tmp/"):])
    if token.startswith(str(base)):
        return str(base) + TAG.sub("_" + recorder.TAG, token[len(str(base)):])
    return TAG.sub("_" + recorder.TAG, token)


def _tree(base: Path, jax_side: bool):
    """The files under ``base`` (tags mapped, ``.gz`` and MANIFESTs aside)
    and the JSON ones' contents without their wall-clock keys."""
    names, jsons = set(), {}
    for p in base.rglob("*"):
        if not p.is_file() or p.name == "MANIFEST.md":
            continue
        rel = p.relative_to(base).as_posix()
        rel = TAG.sub("_" + recorder.TAG, rel) if jax_side else rel
        rel = rel[:-3] if rel.endswith(".gz") else rel
        names.add(rel)
        if p.suffix == ".json":
            text = p.read_text()
            try:
                data = json.loads(text)
            except json.JSONDecodeError:  # a bench file: one JSON line a row
                data = [json.loads(ln) for ln in text.splitlines() if ln]
            jsons[rel] = _drop_clock(data)
    return names, jsons


def _drop_clock(data):
    if isinstance(data, dict):
        return {k: _drop_clock(v) for k, v in data.items()
                if k not in ("wall_s", "rounds_per_sec")}
    if isinstance(data, list):
        return [_drop_clock(v) for v in data]
    return data


STEPS = {
    "golden": ("record_golden_mdgan", "record_golden_mdgan"),
    "standalone": ("record_golden_standalone", "record_golden_standalone"),
    "headline": ("record_headline", "record_headline"),
    "bench": ("record_bench", "record_bench"),
    "families": ("record_bench_families", "record_bench_families"),
    "straggler": ("record_straggler_sweep", "record_straggler_sweep"),
    "scale": ("record_scale_runs", "record_scale_runs"),
    "convergence": ("record_convergence", "record_convergence"),
    "convergence_only_w2": ("record_convergence", "record_convergence"),
    "straggler2": ("record_straggler_seed2", "record_straggler_seed2"),
    "bench_bf16": ("record_bench_bf16", "record_bench_bf16"),
    "profile": ("record_profile", "record_profile"),
}


@pytest.mark.parametrize("step", sorted(STEPS))
def test_step_hands_over_jax_argv(step, tmp_path, monkeypatch):
    tmp_dir = tmp_path / "tmp"
    tmp_dir.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_dir))
    monkeypatch.setattr(sys, "path", list(sys.path))  # the JAX bench steps extend it
    jroot, proot = tmp_path / "jax", tmp_path / "port"
    jmod = _jax_recorder(tmp_dir)
    jcalls, pcalls = [], []
    monkeypatch.setattr(jtrain, "main", fake_train(jcalls))
    monkeypatch.setattr(ptrain, "main", fake_train(pcalls))
    jbench = types.ModuleType("bench")
    for k, v in fake_bench(jcalls, lambda argv: sys.argv[1:]).items():
        setattr(jbench, k, v)
    monkeypatch.setitem(sys.modules, "bench", jbench)
    for k, v in fake_bench(pcalls, lambda argv: list(argv)).items():
        monkeypatch.setattr(pbench, k, v)
    jparts = types.ModuleType("profile_parts")
    jparts.main = lambda: jcalls.append(("profile_parts", *sys.argv[1:]))
    monkeypatch.setitem(sys.modules, "profile_parts", jparts)
    monkeypatch.setattr(pparts, "main", lambda argv=None: pcalls.append(
        ("profile_parts", *argv)) or 0)
    if step == "straggler2":  # it reads the seed-11 sweep of the straggler step
        first = {r: {"best_fid_standard": 50.0 + i} for i, r in enumerate(("0", "0.3"))}
        for base, name in ((jroot / "artifacts", "STRAGGLER_sweep_r04.json"),
                           (proot / recorder.ARTIFACTS, f"STRAGGLER_sweep_{recorder.TAG}.json")):
            (base / "bench").mkdir(parents=True)
            (base / "bench" / name).write_text(json.dumps(first))

    jfn, pfn = (getattr(jmod, STEPS[step][0]), getattr(recorder, STEPS[step][1]))
    if step == "convergence_only_w2":
        jfn(jroot, only="cifar10_w2_r30000")
        pfn(proot, only="cifar10_w2_r30000")
    else:
        jfn(jroot)
        pfn(proot)

    want = [type(c)(_map_jax(t, tmp_path, jroot, proot, tmp_dir) for t in c) for c in jcalls]
    assert pcalls == want
    assert pcalls, "the step handed nothing over"
    jnames, jjson = _tree(jroot / "artifacts", jax_side=True)
    pnames, pjson = _tree(proot / recorder.ARTIFACTS, jax_side=False)
    assert pnames == jnames
    assert pjson == jjson


def _fabricated(base: Path):
    """Golden and headline runs as the recorders leave them, before pruning."""
    for run, epochs, log in (("golden/cifar10_w8_r2000", 2000, 300),
                             ("headline/cifar10_w8_r30000", 30000, 300)):
        out = base / run
        for d in ("logs", "images", "weights"):
            (out / d).mkdir(parents=True)
        evals = _eval_epochs(epochs, log)
        fids = {e: 500.0 - (e * 37 % 401) for e in evals}
        (out / "logs" / "mdgan.8.CIFAR10.server.logs.csv").write_text(
            "epoch,fid\n" + "".join(f"{e},{fids[e]}\n" for e in evals) + f"{epochs - 1},\n")
        for w in range(1, 9):
            (out / "logs" / f"mdgan.8.CIFAR10.worker.{w}.logs.csv").write_text("epoch\n0\n")
        (out / "logs" / "mdgan.8.CIFAR10.worker.3.logs.csv.gz").write_bytes(
            gzip.compress(b"epoch\n0\n"))
        for e in evals:
            (out / "images" / f"generated_epoch_{e}.png").write_bytes(b"png")
            (out / "weights" / f"generator_{e}.npz").write_bytes(b"npz")
        (out / "images" / "real_images.png").write_bytes(b"png")
        (out / "weights" / "generator_final.npz").write_bytes(b"npz")
        (out / "weights" / "generator_best.npz").write_bytes(b"npz")
        (out / "weights" / "worker_1").mkdir()
        (out / "weights" / "worker_1" / "discriminator.npz").write_bytes(b"npz")


def test_prune_weights_leaves_jax_survivors(tmp_path):
    jroot, proot = tmp_path / "jax", tmp_path / "port"
    _fabricated(jroot / "artifacts")
    _fabricated(proot / recorder.ARTIFACTS)
    _jax_recorder(tmp_path).prune_weights(jroot)
    recorder.prune_weights(proot)
    jnames, _ = _tree(jroot / "artifacts", jax_side=True)
    pnames, _ = _tree(proot / recorder.ARTIFACTS, jax_side=False)
    assert pnames == jnames
    assert "headline/cifar10_w8_r30000/logs/mdgan.8.CIFAR10.worker.1.logs.csv" not in pnames
    assert "golden/cifar10_w8_r2000/weights/generator_final.npz" in pnames


def test_trim_inventory_keeps_golden_exports_and_three_grids(tmp_path):
    base = tmp_path / recorder.ARTIFACTS
    _fabricated(base)
    for run in ("golden/cifar10_w8_r2000", "headline/cifar10_w8_r30000"):
        (base / run / "summary.json").write_text("{}")
        (base / run / "MANIFEST.md").write_text("# run\n")
    recorder.prune_weights(tmp_path)
    recorder.trim_inventory(tmp_path)
    golden = base / "golden/cifar10_w8_r2000"
    assert sorted(p.relative_to(golden / "weights").as_posix()
                  for p in (golden / "weights").rglob("*.npz")) == [
        "generator_final.npz", "worker_1/discriminator.npz"]
    assert not (base / "headline/cifar10_w8_r30000/weights").exists()
    for run in ("golden/cifar10_w8_r2000", "headline/cifar10_w8_r30000"):
        grids = sorted((base / run / "images").glob("generated_epoch_*.png"))
        assert len(grids) == 3 and (base / run / "images" / "real_images.png").exists()
        assert "Dropped from the committed inventory" in (base / run / "MANIFEST.md").read_text()


def test_with_overrides_replaces_and_appends():
    argv = ["--epochs", "2000", "--seed", "42"]
    assert recorder.with_overrides(argv, {"--epochs": 6, "--device": "cpu"}) == [
        "--epochs", "6", "--seed", "42", "--device", "cpu"]
    assert recorder.with_overrides(argv, None) == argv


WIDTH = 8


@pytest.fixture()
def narrow_cifar10(monkeypatch):
    """CIFAR-10's DCGAN-32 at width 8, and a stand-in for the Inception
    trackers (the narrow runs test the recorder's layout, not FID)."""
    from mdgan_tpu_torch.metrics import fid as fid_mod

    spec = registry.get("CIFAR10")
    monkeypatch.setitem(registry._REGISTRY, "CIFAR10", dataclasses.replace(
        spec, make_generator=functools.partial(dcgan32.DCGANGenerator32, ngf=WIDTH),
        make_discriminator=functools.partial(dcgan32.DCGANDiscriminator32, ndf=WIDTH)))

    class FakeTracker:
        def __init__(self, real, device=None):
            self.real = float(np.mean(real))

        def score(self, fakes):
            return 100.0 + float(np.mean(fakes)) - self.real

        def inception_score(self, fakes, splits=1):
            return (1.0 + float(np.std(fakes)), 0.0)

    monkeypatch.setattr(fid_mod, "FIDTracker", FakeTracker)


CUT = {"--device": "cpu", "--epochs": "6", "--log_interval": "3", "--swap_interval": "3",
       "--eval_n_samples": "8", "--max_examples": "400", "--compute_dtype": "float32",
       "--chunk_size": "3"}


def test_golden_and_convergence_steps_write_jax_layout(tmp_path, monkeypatch, narrow_cifar10):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    recorder.record_golden_mdgan(tmp_path, CUT)
    recorder.record_convergence(tmp_path, "cifar10_standalone_r30000", CUT)
    recorder.record_convergence(tmp_path, "cifar10_w2_r30000", CUT)
    art = tmp_path / recorder.ARTIFACTS

    golden = art / "golden/cifar10_w8_r2000"
    jgolden = ROOT / "artifacts/golden/cifar10_w8_r2000"
    assert ({p.name for p in (golden / "logs").iterdir()}
            == {p.name for p in (jgolden / "logs").iterdir()})
    server = golden / "logs/mdgan.8.CIFAR10.server.logs.csv"
    rep = janalyze.analyze_file(server)
    assert rep["rounds"] == 6
    assert [e for e, _ in rep["fid_curve"]] == [0, 3, 5]
    assert rep["ops"]["swap"]["count"] == 1
    summary = json.loads((golden / "summary.json").read_text())
    assert summary["rounds"] == 6 and summary["device"] == "cpu"
    assert {(e["epoch"], round(e["fid"], 6)) for e in summary["evals"]} == {
        (int(e), round(f, 6)) for e, f in rep["fid_curve"]}
    for w in range(1, 9):
        wrep = janalyze.analyze_file(golden / f"logs/mdgan.8.CIFAR10.worker.{w}.logs.csv")
        assert wrep["rows"] == 6
    assert janalyze.is_host_csv(golden / "logs/host.csv")
    assert {p.name for p in (golden / "images").iterdir()} == {
        "generated_epoch_0.png", "generated_epoch_3.png", "generated_epoch_5.png",
        "real_images.png"}
    manifest = (golden / "MANIFEST.md").read_text()
    assert "python -m mdgan_tpu_torch.cli.train" in manifest and "- card: cpu" in manifest
    assert "kernel launches" in manifest

    w2 = art / "convergence/cifar10_w2_r30000/logs"
    assert {p.name for p in w2.iterdir()} == {
        p.name for p in (ROOT / "artifacts/convergence/cifar10_w2_r30000/logs").iterdir()}
    assert len(jspans.read_spans(w2 / "mdgan.2.CIFAR10.worker.2.logs.csv.gz")) == 6
    sa = art / "convergence/cifar10_standalone_r30000/logs/CIFAR10.standalone.logs.csv"
    assert janalyze.analyze_file(sa)["rounds"] == 6
    comp = json.loads((art / "convergence/COMPARISON.json").read_text())
    assert set(comp) == {"standalone", "mdgan_w2"}
    for c in comp.values():
        assert [e for e, _ in c["fid_standard"]] == [0, 5]
        assert c["best_fid_standard"] == min(v for _, v in c["fid_standard"])

    recorder.main(["--repo", str(tmp_path), "--prune"])
    assert sorted(p.relative_to(golden / "weights").as_posix()
                  for p in (golden / "weights").rglob("*.npz")) == [
        "generator_final.npz", "worker_1/discriminator.npz"]
    assert not (art / "convergence/cifar10_w2_r30000/weights").exists()
