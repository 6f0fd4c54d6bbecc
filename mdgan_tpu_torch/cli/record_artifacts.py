"""Recorder of the port's committed runs (port of ``scripts/record_artifacts.py``).

Runs the JAX recorder's steps, argv for argv, through the port's entry points
(``cli.train.main``, ``cli.bench``, ``cli.profile_parts``,
``cli.analyze.plot_compare``), on the card unless ``--device cpu`` says
otherwise, and writes under ``<repo>/artifacts_torch/``, never under
``artifacts/`` (the JAX package's records).  Each step, and what it writes:

  golden       MD-GAN, CIFAR-10, N=8, 2000 rounds, seed 42, the 10k-sample
               standard FID/IS at every eval, host metrics
               -> golden/cifar10_w8_r2000
  standalone   the standalone baseline, 2000 rounds, seed 42
               -> golden/cifar10_standalone_r2000
  headline     MD-GAN, N=8, 30000 rounds, 101 evals, the standard protocol
               at every 10th -> headline/cifar10_w8_r30000
  bench        ``cli.bench`` headline, sustained, scaling
               -> bench/BENCH_{headline,sustained,scaling}_h100.json
  families     ``cli.bench`` mnist4, celeba16, ffhq128_stylegan and the
               standalone config -> bench/BENCH_families_h100.json
  straggler    drop rates 0, 0.3, 0.6, 0.9 (2000 rounds, seed 11)
               -> bench/STRAGGLER_sweep_h100.json, bench/straggler_sweep_h100/
  scale        N=20 (10000 rounds) and N=40 (5000) -> scale/cifar10_w{20,40}_*
  convergence  standalone against MD-GAN at N=2 and N=4, 30000 rounds each,
               at the headline's standard-protocol cadence, and
               convergence/COMPARISON.json over those legs and the headline
               (``--only <leg>`` records one leg; a name that is no leg only
               rewrites the comparison)
  straggler2   the sweep's rates 0 and 0.3 again with seed 12
               -> bench/STRAGGLER_sweep_seed2_h100.json
  bench_bf16   bfloat16 Adam moments against float32: headline and scaling
               -> bench/BENCH_moments_bf16_h100.json
  profile      ``cli.profile_parts`` -> bench/PROFILE_parts_h100.json

File names keep the JAX recorder's stems with ``_h100`` in place of its round
tags (``_r04``, ``_r05``); checkpoints and the sweeps' scratch runs go under
the temporary directory (``TMPDIR``).  Each recorded run directory gets a
``MANIFEST.md``: the command, the card's name and power limit
(``nvidia-smi``), the torch and CUDA versions, the kernels' launches and the
feature source.  Figures need matplotlib; where it does not import, the
recorder says so on a line and writes the rest (render them later from the
committed CSVs with ``record_convergence(root, only="")``).

Usage:
    python -m mdgan_tpu_torch.cli.record_artifacts --steps golden,standalone
    python -m mdgan_tpu_torch.cli.record_artifacts --steps convergence \\
        --only cifar10_w2_r30000
    python -m mdgan_tpu_torch.cli.record_artifacts --prune
    python -m mdgan_tpu_torch.cli.record_artifacts --report
    python -m mdgan_tpu_torch.cli.record_artifacts --device cpu --steps golden

``--prune`` keeps, of the runs' weight exports, the best-FID and final
generators of the golden and headline runs and drops the headline's plain
worker CSVs (the JAX rule, :func:`prune_weights`), then cuts every recorded
run to its committed inventory (:func:`trim_inventory`): the golden N=8 run's
``generator_final.npz`` and ``worker_1/discriminator.npz`` and no other
export, and three image grids a run.  ``--report`` prints the checks that
hold the port's records against the JAX package's (:func:`report`).
"""

from __future__ import annotations

import argparse
import csv
import gzip
import io
import json
import shutil
import sys
import tempfile
import time
from contextlib import redirect_stdout
from pathlib import Path
from typing import Dict, List, Optional, Sequence

ARTIFACTS = "artifacts_torch"
TAG = "h100"  # in place of the JAX recorder's round tags
# what trim_inventory keeps of each recorded run's weight exports
KEEP_WEIGHTS = {"golden/cifar10_w8_r2000": {"generator_final.npz",
                                            "worker_1/discriminator.npz"}}
FID_NOTE = ("FID and IS here come from the port's own random-init InceptionV3 "
            "(mdgan_tpu_torch/metrics/inception.py); the JAX package's random-init "
            "weights differ, so their magnitudes compare only between runs of the port.")


def _fresh(d: Path) -> str:
    if d.exists():
        shutil.rmtree(d)
    d.mkdir(parents=True)
    return str(d)


def _scratch(name: str) -> Path:
    """A run's checkpoint or scratch directory, under ``TMPDIR``."""
    return Path(tempfile.gettempdir()) / name


def with_overrides(argv: Sequence[str], overrides: Optional[Dict[str, str]]) -> List[str]:
    """``argv`` with each flag of ``overrides`` set to its value: replaced
    where the flag is present, appended where it is not."""
    out = list(argv)
    for flag, value in (overrides or {}).items():
        if flag in out:
            out[out.index(flag) + 1] = str(value)
        else:
            out += [flag, str(value)]
    return out


def card_line(device_name: Optional[str]) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or the
    device the run used where that is no card."""
    from mdgan_tpu_torch.core import timing

    if device_name in (None, "cpu"):
        return str(device_name or "not recorded")
    return timing.card_line() or f"{device_name} (nvidia-smi failed)"


def write_manifest(out: Path, argv: Sequence[str], summary: Dict,
                   launches: Optional[Dict[str, int]] = None, note: str = "") -> None:
    """``out/MANIFEST.md``: how the run in ``out`` was made and on what."""
    import torch

    rel = "/".join(out.parts[-2:])
    lines = [
        f"# {rel}", "",
        "Command:", "",
        "    python -m mdgan_tpu_torch.cli.train " + " ".join(argv), "",
        f"- card: {card_line(summary.get('device'))}",
        f"- torch {torch.__version__}, CUDA {torch.version.cuda}",
        f"- compute dtype: {summary.get('compute_dtype')}",
        f"- rounds: {summary.get('rounds')}, wall time {summary.get('wall_time_s')} s, "
        f"{summary.get('steps_per_sec')} rounds/s with evals",
        f"- final mean D loss: {summary.get('final_mean_d_loss')}",
        f"- feature_source: {summary.get('feature_source')}",
    ]
    if launches is not None:
        lines.append("- kernel launches: " + ", ".join(f"{k} {v}" for k, v in launches.items()))
    lines += ["", FID_NOTE, ""]
    if note:
        lines += [note, ""]
    (out / "MANIFEST.md").write_text("\n".join(lines))


def run_train(argv, summary_path: Path, overrides: Optional[Dict[str, str]] = None) -> Dict:
    """Run the training CLI in this process with ``argv`` (and
    ``overrides``), keep the summary JSON of its last stdout line in
    ``summary_path`` and a ``MANIFEST.md`` beside it; returns the summary."""
    from mdgan_tpu_torch.cli import train as train_cli
    from mdgan_tpu_torch.ops import _build

    argv = with_overrides(argv, overrides)
    print(f"== train {' '.join(argv)}", flush=True)
    t0 = time.time()
    before = _build.reported()
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = train_cli.main(argv)
    assert rc == 0, f"train exited {rc}"
    line = buf.getvalue().strip().splitlines()[-1]
    summary = json.loads(line)  # must be the summary JSON line
    summary_path.write_text(line)
    launches = {k: v - before[k] for k, v in _build.reported().items()}
    write_manifest(summary_path.parent, argv, summary, launches)
    print(f"== done in {time.time() - t0:.1f}s, launches {launches}: {line[:300]}",
          flush=True)
    return summary


def _gzip_workers(logs: Path, keep_plain: Sequence[int] = (1,)) -> None:
    """Gzip the worker CSVs of ``logs`` but those of ``keep_plain``."""
    keep = {f".worker.{w}.logs.csv" for w in keep_plain}
    for p in sorted(logs.glob("mdgan.*.worker.*.logs.csv")):
        if not any(p.name.endswith(k) for k in keep):
            with open(p, "rb") as src, gzip.open(f"{p}.gz", "wb", compresslevel=9) as dst:
                shutil.copyfileobj(src, dst)
            p.unlink()


def _grid_epoch(p: Path) -> int:
    return int(p.stem.rsplit("_", 1)[1])


def _keep_three_grids(images: Path) -> List[str]:
    """Drop every image grid of a run but its first, middle and last;
    returns the names dropped."""
    grids = sorted(images.glob("*_[0-9]*.png"), key=_grid_epoch)
    keep = {grids[0], grids[len(grids) // 2], grids[-1]} if grids else set()
    dropped = [p.name for p in grids if p not in keep]
    for p in grids:
        if p not in keep:
            p.unlink()
    return dropped


def _plot_compare(paths: List[Path], out_dir: Path) -> None:
    """``cli.analyze.plot_compare`` where matplotlib imports; a line saying
    so where it does not."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print(f"== figures skipped ({out_dir}): matplotlib is not installed", flush=True)
        return
    from mdgan_tpu_torch.cli.analyze import plot_compare

    plot_compare(paths, out_dir)


def record_golden_mdgan(root: Path, overrides: Optional[Dict[str, str]] = None) -> None:
    out = root / ARTIFACTS / "golden" / "cifar10_w8_r2000"
    logs, imgs, weights = _fresh(out / "logs"), _fresh(out / "images"), _fresh(out / "weights")
    run_train([
        "--mode", "mdgan", "--dataset", "CIFAR10", "--num_workers", "8",
        "--epochs", "2000", "--batch_size", "10", "--swap_interval", "500",
        "--log_interval", "300", "--seed", "42",
        "--eval_n_samples", "10000",
        "--host_metrics", str(out / "logs" / "host.csv"),
        "--log_dir", logs, "--image_dir", imgs, "--weights_dir", weights,
        "--checkpoint_dir", str(_scratch(f"golden_ckpt_{TAG}")),
    ], out / "summary.json", overrides)


def record_golden_standalone(root: Path, overrides: Optional[Dict[str, str]] = None) -> None:
    out = root / ARTIFACTS / "golden" / "cifar10_standalone_r2000"
    logs, imgs, weights = _fresh(out / "logs"), _fresh(out / "images"), _fresh(out / "weights")
    run_train([
        "--mode", "standalone", "--dataset", "CIFAR10",
        "--epochs", "2000", "--batch_size", "10",
        "--log_interval", "300", "--seed", "42",
        "--log_dir", logs, "--image_dir", imgs, "--weights_dir", weights,
        "--checkpoint_dir", str(_scratch(f"golden_sa_ckpt_{TAG}")),
    ], out / "summary.json", overrides)


def record_headline(root: Path, overrides: Optional[Dict[str, str]] = None) -> None:
    """The headline run.  Its worker CSVs are all gzipped, worker 1's too:
    the prune rule drops the plain ones, and the D-loss comparison reads
    them."""
    out = root / ARTIFACTS / "headline" / "cifar10_w8_r30000"
    logs, imgs, weights = _fresh(out / "logs"), _fresh(out / "images"), _fresh(out / "weights")
    run_train([
        "--mode", "mdgan", "--dataset", "CIFAR10", "--num_workers", "8",
        "--epochs", "30000", "--batch_size", "10", "--swap_interval", "5000",
        "--log_interval", "300", "--seed", "42",
        # the standard protocol at every 10th eval event and the final round
        "--eval_n_samples", "10000", "--eval_standard_interval", "10",
        "--log_dir", logs, "--image_dir", imgs, "--weights_dir", weights,
        "--checkpoint_dir", str(_scratch(f"headline_ckpt_{TAG}")),
    ], out / "summary.json", overrides)
    _gzip_workers(Path(logs), keep_plain=())


def _bench_argv(overrides: Optional[Dict[str, str]]) -> List[str]:
    device = (overrides or {}).get("--device")
    return ["--device", device] if device else []


def _bench_device(overrides: Optional[Dict[str, str]]) -> Dict[str, str]:
    device = (overrides or {}).get("--device")
    return {"device": device} if device else {}


def record_bench(root: Path, overrides: Optional[Dict[str, str]] = None) -> None:
    from mdgan_tpu_torch.cli import bench

    out = root / ARTIFACTS / "bench"
    out.mkdir(parents=True, exist_ok=True)

    def capture(argv, dest):
        buf = io.StringIO()
        with redirect_stdout(buf):
            bench.main(argv + _bench_argv(overrides))
        (out / dest).write_text(buf.getvalue())
        print(f"== bench {argv} ->\n{buf.getvalue()}", flush=True)

    capture(["--config", "headline"], f"BENCH_headline_{TAG}.json")
    capture(["--config", "sustained"], f"BENCH_sustained_{TAG}.json")
    capture(["--config", "scaling"], f"BENCH_scaling_{TAG}.json")


def record_bench_families(root: Path, overrides: Optional[Dict[str, str]] = None) -> None:
    """The non-headline configs, one JSON line each."""
    from mdgan_tpu_torch.cli import bench

    out = root / ARTIFACTS / "bench"
    out.mkdir(parents=True, exist_ok=True)
    kw = _bench_device(overrides)
    lines = []
    for name in ("mnist4", "celeba16", "ffhq128_stylegan"):
        r = bench.bench_mdgan(name, **kw)
        print(f"== bench family {name} -> {r}", flush=True)
        lines.append(json.dumps(r))
    r = bench.bench_standalone(**kw)
    print(f"== bench standalone -> {r}", flush=True)
    lines.append(json.dumps(r))
    (out / f"BENCH_families_{TAG}.json").write_text("\n".join(lines) + "\n")


def record_scale_runs(root: Path, overrides: Optional[Dict[str, str]] = None,
                      only: Optional[int] = None) -> None:
    """The reference-scale runs, N=20 for 10000 rounds and N=40 for 5000
    (``only``: one worker count): server CSV, every worker CSV (past worker 1
    gzipped), summary and three grids; no weights."""
    for n, epochs in ((20, 10000), (40, 5000)):
        if only is not None and n != only:
            continue
        out = root / ARTIFACTS / "scale" / f"cifar10_w{n}_r{epochs}"
        logs, imgs, weights = (_fresh(out / "logs"), _fresh(out / "images"),
                               _fresh(out / "weights"))
        run_train([
            "--mode", "mdgan", "--dataset", "CIFAR10",
            "--num_workers", str(n), "--epochs", str(epochs),
            "--batch_size", "10", "--swap_interval", "5000",
            "--log_interval", "300", "--seed", "42",
            "--log_dir", logs, "--image_dir", imgs, "--weights_dir", weights,
            "--checkpoint_dir", str(_scratch(f"scale_ckpt_w{n}_{TAG}")),
        ], out / "summary.json", overrides)
        _gzip_workers(Path(logs))
        shutil.rmtree(weights)
        _keep_three_grids(Path(imgs))
        print(f"== scale w{n} r{epochs} recorded (all worker logs)", flush=True)


def _series(rows, key: str = "fid_standard"):
    """(epoch, value) of the rows that carry ``key``."""
    return [(r["epoch"], r[key]) for r in rows if isinstance(r.get(key), float)]


def record_straggler_sweep(root: Path, overrides: Optional[Dict[str, str]] = None) -> None:
    """Seeded 2000-round runs at drop rates 0, 0.3, 0.6, 0.9: the
    standard-protocol FID/IS, the D loss over the final 200 rounds of every
    worker, each rate's server and worker-1 CSVs and overlay figures."""
    import numpy as np

    from mdgan_tpu_torch.obs import spans as spans_lib

    out = root / ARTIFACTS / "bench"
    keep = out / f"straggler_sweep_{TAG}"
    if keep.exists():
        shutil.rmtree(keep)
    sweep = {}
    n_workers = 8
    for rate in ("0", "0.3", "0.6", "0.9"):
        scratch = _scratch(f"straggler_{TAG}_{rate}")
        logs, imgs, weights = (_fresh(scratch / "logs"), _fresh(scratch / "imgs"),
                               _fresh(scratch / "weights"))
        t0 = time.time()
        summary = run_train([
            "--mode", "mdgan", "--dataset", "CIFAR10",
            "--num_workers", str(n_workers),
            "--epochs", "2000", "--batch_size", "10", "--swap_interval", "500",
            "--log_interval", "500", "--seed", "11", "--checkpoint_interval", "0",
            "--straggler_rate", rate, "--eval_n_samples", "10000",
            "--log_dir", logs, "--image_dir", imgs, "--weights_dir", weights,
            "--checkpoint_dir", str(scratch / "ckpt"),
        ], scratch / "summary.json", overrides)
        wall = time.time() - t0
        server = Path(logs) / f"mdgan.{n_workers}.CIFAR10.server.logs.csv"
        rows = spans_lib.read_spans(server)
        nfb = [v for _, v in _series(rows, "n_feedbacks")]
        fids = [v for _, v in _series(rows, "fid")]
        fstd = _series(rows)
        tail = []
        for w in range(1, n_workers + 1):
            wrows = spans_lib.read_spans(
                Path(logs) / f"mdgan.{n_workers}.CIFAR10.worker.{w}.logs.csv")
            tail.append([r["mean_d_loss"] for r in wrows[-200:]])
        dest = keep / f"rate_{rate}"
        dest.mkdir(parents=True)
        shutil.copy(server, dest)
        shutil.copy(Path(logs) / f"mdgan.{n_workers}.CIFAR10.worker.1.logs.csv", dest)
        sweep[rate] = dict(
            final_mean_d_loss=summary["final_mean_d_loss"],
            d_loss_last200_mean=round(float(np.mean(tail)), 4),
            wall_s=round(wall, 2),
            rounds_per_sec=round(2000 / wall, 1),
            # the rate-0 control writes no n_feedbacks column: every
            # feedback is kept
            n_feedbacks_mean=(round(float(np.mean(nfb)), 2) if nfb else float(n_workers)),
            best_fid_standard=round(min(v for _, v in fstd), 2) if fstd else None,
            final_fid_standard=round(fstd[-1][1], 2) if fstd else None,
            best_fid_5sample=round(min(fids), 2) if fids else None,
            final_fid_5sample=round(fids[-1], 2) if fids else None,
            feature_source=summary.get("feature_source"),
        )
        print(f"== straggler rate={rate}: {sweep[rate]}", flush=True)
    (out / f"STRAGGLER_sweep_{TAG}.json").write_text(json.dumps(sweep, indent=1) + "\n")
    _plot_compare(sorted(keep.glob("rate_*/mdgan.*.server.logs.csv")), keep / "figures")
    _plot_compare(sorted(keep.glob("rate_*/mdgan.*.worker.1.logs.csv")), keep / "figures")
    print(f"== straggler sweep -> {keep}", flush=True)


CONVERGENCE_LEGS = {
    "cifar10_standalone_r30000": [
        "--mode", "standalone", "--dataset", "CIFAR10",
        "--epochs", "30000", "--batch_size", "10",
        "--log_interval", "300", "--seed", "42",
        "--checkpoint_interval", "0",
        "--eval_n_samples", "10000", "--eval_standard_interval", "10",
    ],
    "cifar10_w2_r30000": [
        "--mode", "mdgan", "--dataset", "CIFAR10", "--num_workers", "2",
        "--epochs", "30000", "--batch_size", "10",
        "--swap_interval", "5000", "--log_interval", "300",
        "--seed", "42", "--checkpoint_interval", "0",
        "--eval_n_samples", "10000", "--eval_standard_interval", "10",
    ],
    "cifar10_w4_r30000": [
        "--mode", "mdgan", "--dataset", "CIFAR10", "--num_workers", "4",
        "--epochs", "30000", "--batch_size", "10",
        "--swap_interval", "5000", "--log_interval", "300",
        "--seed", "42", "--checkpoint_interval", "0",
        "--eval_n_samples", "10000", "--eval_standard_interval", "10",
    ],
}


def record_convergence(root: Path, only: Optional[str] = None,
                       overrides: Optional[Dict[str, str]] = None) -> None:
    """Standalone against MD-GAN at N=2 and N=4, 30000 rounds each, seed 42,
    the 10k-sample standard protocol at the headline's cadence; then the
    overlay figures and ``COMPARISON.json`` from every leg whose CSV is on
    disk.  ``only`` records one leg."""
    from mdgan_tpu_torch.obs import spans as spans_lib

    base = root / ARTIFACTS / "convergence"
    for name, argv in CONVERGENCE_LEGS.items():
        if only is not None and name != only:
            continue
        out = base / name
        logs, imgs, weights = (_fresh(out / "logs"), _fresh(out / "images"),
                               _fresh(out / "weights"))
        run_train(argv + [
            "--log_dir", logs, "--image_dir", imgs, "--weights_dir", weights,
            "--checkpoint_dir", str(_scratch(f"conv_ckpt_{name}")),
        ], out / "summary.json", overrides)
        # committed: logs, summary, three grids; worker CSVs past worker 1 gzipped
        shutil.rmtree(weights)
        _gzip_workers(Path(logs))
        _keep_three_grids(Path(imgs))
        print(f"== convergence {name} recorded", flush=True)

    # the w8 leg is the headline run's
    csvs = {
        "standalone": base / "cifar10_standalone_r30000" / "logs" / "CIFAR10.standalone.logs.csv",
        "mdgan_w2": base / "cifar10_w2_r30000" / "logs" / "mdgan.2.CIFAR10.server.logs.csv",
        "mdgan_w4": base / "cifar10_w4_r30000" / "logs" / "mdgan.4.CIFAR10.server.logs.csv",
        "mdgan_w8": root / ARTIFACTS / "headline" / "cifar10_w8_r30000" / "logs"
        / "mdgan.8.CIFAR10.server.logs.csv",
    }
    _plot_compare([p for p in csvs.values() if p.exists()], base / "figures")
    comp = {}
    for label, p in csvs.items():
        if not p.exists():
            continue
        rows = spans_lib.read_spans(p)
        series = [(int(e), round(v, 2)) for e, v in _series(rows)]
        iss = [(int(e), round(v, 4)) for e, v in _series(rows, "is_standard")]
        comp[label] = {
            "fid_standard": series,
            "is_standard": iss,
            "best_fid_standard": min(v for _, v in series) if series else None,
            "final_fid_standard": series[-1][1] if series else None,
        }
    base.mkdir(parents=True, exist_ok=True)
    (base / "COMPARISON.json").write_text(json.dumps(comp, indent=1) + "\n")
    print(f"== convergence comparison -> {base / 'COMPARISON.json'}", flush=True)


def record_straggler_seed2(root: Path, rates: tuple = ("0", "0.3"),
                           overrides: Optional[Dict[str, str]] = None) -> None:
    """The sweep's rates again with seed 12, merged into any earlier record
    of this step, with the best-FID spread against the seed-11 sweep."""
    import numpy as np

    from mdgan_tpu_torch.obs import spans as spans_lib

    out = root / ARTIFACTS / "bench"
    artifact = out / f"STRAGGLER_sweep_seed2_{TAG}.json"
    n_workers = 8
    sweep = json.loads(artifact.read_text()) if artifact.exists() else {}
    for rate in rates:
        scratch = _scratch(f"straggler_{TAG}_s12_{rate}")
        logs, imgs, weights = (_fresh(scratch / "logs"), _fresh(scratch / "imgs"),
                               _fresh(scratch / "weights"))
        t0 = time.time()
        summary = run_train([
            "--mode", "mdgan", "--dataset", "CIFAR10",
            "--num_workers", str(n_workers),
            "--epochs", "2000", "--batch_size", "10", "--swap_interval", "500",
            "--log_interval", "500", "--seed", "12", "--checkpoint_interval", "0",
            "--straggler_rate", rate, "--eval_n_samples", "10000",
            "--log_dir", logs, "--image_dir", imgs, "--weights_dir", weights,
            "--checkpoint_dir", str(scratch / "ckpt"),
        ], scratch / "summary.json", overrides)
        wall = time.time() - t0
        rows = spans_lib.read_spans(
            Path(logs) / f"mdgan.{n_workers}.CIFAR10.server.logs.csv")
        fstd = _series(rows)
        nfb = [v for _, v in _series(rows, "n_feedbacks")]
        sweep[rate] = dict(
            seed=12,
            final_mean_d_loss=summary["final_mean_d_loss"],
            wall_s=round(wall, 2),
            n_feedbacks_mean=(round(float(np.mean(nfb)), 2) if nfb else float(n_workers)),
            best_fid_standard=round(min(v for _, v in fstd), 2) if fstd else None,
            final_fid_standard=round(fstd[-1][1], 2) if fstd else None,
            feature_source=summary.get("feature_source"),
        )
        print(f"== straggler seed2 rate={rate}: {sweep[rate]}", flush=True)

    first = json.loads((out / f"STRAGGLER_sweep_{TAG}.json").read_text())
    spread = sweep.get("cross_seed_best_fid_spread", {})
    for rate in sorted(k for k in sweep if k != "cross_seed_best_fid_spread"):
        a, b = first[rate]["best_fid_standard"], sweep[rate]["best_fid_standard"]
        spread[rate] = dict(seed11=a, seed12=b, abs_spread=round(abs(a - b), 2),
                            rel_spread=round(abs(a - b) / min(a, b), 3))
    sweep["cross_seed_best_fid_spread"] = spread
    artifact.write_text(json.dumps(sweep, indent=1) + "\n")
    print(f"== straggler seed2 sweep -> spread {spread}", flush=True)


def record_bench_bf16(root: Path, overrides: Optional[Dict[str, str]] = None) -> None:
    """bfloat16 Adam moments against float32 in one process: the headline
    line and the worker-count sweep, both moment dtypes."""
    from mdgan_tpu_torch.cli import bench

    out = root / ARTIFACTS / "bench"
    out.mkdir(parents=True, exist_ok=True)
    kw = _bench_device(overrides)
    lines = []
    for dtype in ("float32", "bfloat16"):
        r = bench.bench_mdgan("headline", dtype, **kw)
        print(f"== bench headline moment_dtype={dtype} -> {r}", flush=True)
        lines.append(json.dumps(r))
    for dtype in ("float32", "bfloat16"):
        for r in bench.bench_scaling(dtype, **kw):
            print(f"== bench scaling moment_dtype={dtype} N={r['num_workers']}"
                  f" -> {r['value']} rounds/s", flush=True)
            lines.append(json.dumps(r))
    (out / f"BENCH_moments_bf16_{TAG}.json").write_text("\n".join(lines) + "\n")


def record_profile(root: Path, overrides: Optional[Dict[str, str]] = None) -> None:
    """The round's parts (``cli.profile_parts``) as a committed JSON."""
    from mdgan_tpu_torch.cli import profile_parts

    out = root / ARTIFACTS / "bench" / f"PROFILE_parts_{TAG}.json"
    profile_parts.main(["--json", str(out)] + _bench_argv(overrides))
    print(f"== profile parts -> {out}", flush=True)


def prune_weights(root: Path) -> None:
    """The JAX recorder's rule (``scripts/record_artifacts.py:492-531``): of
    the golden and headline runs' per-eval generator exports keep the
    best-FID snapshot and the final one; of the headline's logs drop the
    plain worker CSVs and of its grids keep rounds 0 and the first eval,
    the 1/3 and 2/3 points, best-FID and final."""
    for run in ("golden/cifar10_w8_r2000", "headline/cifar10_w8_r30000"):
        out = root / ARTIFACTS / run
        csvs = list((out / "logs").glob("mdgan.*.server.logs.csv"))
        if not csvs:
            continue
        with open(csvs[0]) as f:
            rows = list(csv.DictReader(f))
        fids = [(float(r["fid"]), int(float(r["epoch"]))) for r in rows if r.get("fid")]
        keep = {min(fids)[1]} if fids else set()
        for p in sorted((out / "weights").glob("generator_*.npz")):
            stem = p.stem.replace("generator_", "")
            if stem != "final" and (not stem.isdigit() or int(stem) not in keep):
                p.unlink()
        print(f"pruned {run}: kept best-FID {sorted(keep)} + final", flush=True)

        if run.startswith("headline/"):
            for p in sorted((out / "logs").glob("mdgan.*.worker.*.logs.csv")):
                p.unlink()
            epochs = sorted(int(float(r["epoch"])) for r in rows if r.get("fid"))
            final, cadence = epochs[-1], epochs[2] - epochs[1]
            spread = {round(final / 3 / cadence) * cadence,
                      round(2 * final / 3 / cadence) * cadence}
            keep_imgs = {0, epochs[1], final} | keep | spread
            for p in sorted((out / "images").glob("generated_epoch_*.png")):
                e = p.stem.replace("generated_epoch_", "")
                if not e.isdigit() or int(e) not in keep_imgs:
                    p.unlink()
            print(f"pruned {run}: worker CSVs dropped, images kept "
                  f"{sorted(keep_imgs)}", flush=True)


def trim_inventory(root: Path) -> None:
    """Cut each recorded run to the port's committed inventory: the weight
    exports named in ``KEEP_WEIGHTS`` and none other, three grids a run;
    each run's MANIFEST lists what went (reproducible from its command)."""
    base = root / ARTIFACTS
    for summary in sorted(base.glob("*/*/summary.json")):
        out = summary.parent
        rel = out.relative_to(base).as_posix()
        dropped = []
        weights = out / "weights"
        if weights.is_dir():
            keep = KEEP_WEIGHTS.get(rel, set())
            for p in sorted(q for q in weights.rglob("*") if q.is_file()):
                name = p.relative_to(weights).as_posix()
                if name not in keep:
                    dropped.append(f"weights/{name}")
                    p.unlink()
            for d in sorted((q for q in weights.rglob("*") if q.is_dir()), reverse=True):
                if not any(d.iterdir()):
                    d.rmdir()
            if not any(weights.iterdir()):
                weights.rmdir()
        if (out / "images").is_dir():
            dropped += [f"images/{n}" for n in _keep_three_grids(out / "images")]
        manifest = out / "MANIFEST.md"
        if dropped and manifest.exists():
            with open(manifest, "a") as f:
                f.write("Dropped from the committed inventory, reproducible from the "
                        "seeded command above: " + ", ".join(dropped) + ".\n")
        print(f"trimmed {rel}: dropped {len(dropped)} files", flush=True)


def window_d_loss(logs: Path, lo: int, hi: int) -> List[float]:
    """Each worker's mean ``mean_d_loss`` over rounds ``lo``..``hi`` from the
    worker CSVs in ``logs`` (plain or gzipped), worker 1 first."""
    import numpy as np

    from mdgan_tpu_torch.obs import spans as spans_lib

    paths = sorted(logs.glob("mdgan.*.worker.*.logs.csv*"),
                   key=lambda p: int(p.name.split(".worker.")[1].split(".")[0]))
    return [float(np.mean([r["mean_d_loss"] for r in spans_lib.read_spans(p)
                           if lo <= r["epoch"] <= hi])) for p in paths]


def report(root: Path) -> Dict:
    """The cross-package checks over the records of both packages
    (``<root>/artifacts_torch`` and the JAX package's ``<root>/artifacts``,
    read as files): (a) the golden N=8 run's D-loss window mean over rounds
    1000-1999, the port's at seeds 42 and 43 against JAX's; (b) the
    convergence legs' best standard-protocol FID, standalone first; (c) the
    30,000-round legs' D-loss window means over rounds 20000-29999."""
    import numpy as np

    out: Dict = {}
    for pkg, base in (("port", root / ARTIFACTS), ("jax", root / "artifacts")):
        rec: Dict = {}
        for key, run in (("golden_seed42", "golden/cifar10_w8_r2000"),
                         ("golden_seed43", "golden/cifar10_w8_r2000_seed43")):
            if (base / run / "logs").is_dir():
                rec[key] = window_d_loss(base / run / "logs", 1000, 1999)
        for key, run in (("w2", "convergence/cifar10_w2_r30000"),
                         ("w4", "convergence/cifar10_w4_r30000"),
                         ("w8", "headline/cifar10_w8_r30000")):
            if (base / run / "summary.json").is_file():
                rec[key] = {"window_20000_29999": window_d_loss(base / run / "logs", 20000, 29999),
                            "final_mean_d_loss": json.loads(
                                (base / run / "summary.json").read_text())["final_mean_d_loss"]}
        comp = base / "convergence" / "COMPARISON.json"
        if comp.is_file():
            rec["best_fid_standard"] = {k: v["best_fid_standard"]
                                        for k, v in json.loads(comp.read_text()).items()}
        out[pkg] = rec
    port, jax_rec = out["port"], out["jax"]
    if {"golden_seed42", "golden_seed43"} <= set(port) and "golden_seed42" in jax_rec:
        m42, m43 = (float(np.mean(port[k])) for k in ("golden_seed42", "golden_seed43"))
        want = float(np.mean(jax_rec["golden_seed42"]))
        bound = max(3 * abs(m42 - m43), 0.05)
        out["check_a"] = {"m42": m42, "m43": m43, "jax": want, "gap": abs(m42 - want),
                          "bound": bound, "holds": abs(m42 - want) <= bound}
    best = port.get("best_fid_standard", {})
    if "standalone" in best:
        out["check_b"] = {"holds": all(best["standalone"] < v
                                       for k, v in best.items() if k != "standalone")}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--repo", default=".",
                   help=f"root whose {ARTIFACTS}/ receives the records")
    p.add_argument("--steps", default="golden,standalone,headline,bench")
    p.add_argument("--only", default=None,
                   help="the one convergence leg to record (e.g. cifar10_w2_r30000)")
    p.add_argument("--prune", action="store_true",
                   help="only prune the recorded runs to their committed inventory")
    p.add_argument("--report", action="store_true",
                   help="only print the cross-package checks over the records as JSON")
    p.add_argument("--device", default=None,
                   help="torch device of every run (default cuda; 'cpu' runs the "
                        "kernels' plain PyTorch versions)")
    args = p.parse_args(argv)
    root = Path(args.repo)
    if args.prune:
        prune_weights(root)
        trim_inventory(root)
        return 0
    if args.report:
        print(json.dumps(report(root)))
        return 0
    overrides = {"--device": args.device} if args.device else None
    steps = args.steps.split(",")
    if "golden" in steps:
        record_golden_mdgan(root, overrides)
    if "standalone" in steps:
        record_golden_standalone(root, overrides)
    if "headline" in steps:
        record_headline(root, overrides)
    if "bench" in steps:
        record_bench(root, overrides)
    if "families" in steps:
        record_bench_families(root, overrides)
    if "straggler" in steps:
        record_straggler_sweep(root, overrides)
    if "scale" in steps:
        record_scale_runs(root, overrides)
    if "convergence" in steps:
        record_convergence(root, args.only, overrides)
    if "straggler2" in steps:
        record_straggler_seed2(root, overrides=overrides)
    if "bench_bf16" in steps:
        record_bench_bf16(root, overrides)
    if "profile" in steps:
        record_profile(root, overrides)
    return 0


if __name__ == "__main__":
    sys.exit(main())
