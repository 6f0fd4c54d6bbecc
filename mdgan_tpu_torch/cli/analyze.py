"""Log-analysis CLI — the reference's ``src/results/plot_logs.ipynb`` as a command.

A copy of ``mdgan_tpu/cli/analyze.py:1-407`` that reads through the port's
``obs/spans.py`` (``read_spans``, ``span_durations``, ``open_maybe_gz``).
Parses the span CSVs written by training, pairs ``start.X``/``end.X``
columns into per-op durations (notebook cell 3's ``compute_time_elapsed``),
and prints per-op mean/median/p95 timing plus round-rate and FID/IS curves;
``--host_metrics`` CSVs get a cpu/mem/net summary.  ``--plot DIR`` writes
the notebook's figures and needs matplotlib, which is imported only then.

Usage:
    python -m mdgan_tpu_torch.cli.analyze logs/mdgan.8.CIFAR10.server.logs.csv
    python -m mdgan_tpu_torch.cli.analyze --json logs/*.csv
    python -m mdgan_tpu_torch.cli.analyze --plot figs --compare runA.csv runB.csv
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List

import numpy as np

from mdgan_tpu_torch.obs import spans as spans_lib


def analyze_file(path: Path) -> dict:
    rows = spans_lib.read_spans(path)
    durations = spans_lib.span_durations(rows)
    report = {"file": str(path), "rows": len(rows), "ops": {}}
    for op, ds in sorted(durations.items()):
        arr = np.asarray(ds)
        report["ops"][op] = {
            "count": int(arr.size),
            "mean_s": float(arr.mean()),
            "median_s": float(np.median(arr)),
            "p95_s": float(np.percentile(arr, 95)),
            "total_s": float(arr.sum()),
        }
    epochs = [r["epoch"] for r in rows if isinstance(r.get("epoch"), float)]
    spans = [
        (r.get("start.epoch"), r.get("end.epoch"))
        for r in rows
        if isinstance(r.get("start.epoch"), float) and isinstance(r.get("end.epoch"), float)
    ]
    if epochs and spans and len(epochs) > 1:
        total_rounds = max(epochs) - min(epochs) + 1
        wall = max(e for _, e in spans) - min(s for s, _ in spans)
        if wall > 0:
            report["rounds"] = int(total_rounds)
            report["wall_s"] = float(wall)
            report["rounds_per_sec"] = float(total_rounds / wall)
    fids = [(r["epoch"], r["fid"]) for r in rows if isinstance(r.get("fid"), float)]
    iss = [(r["epoch"], r["is"]) for r in rows if isinstance(r.get("is"), float)]
    if fids:
        report["fid_curve"] = fids
        report["best_fid"] = min(f for _, f in fids)
    if iss:
        report["is_curve"] = iss
        report["best_is"] = max(v for _, v in iss)
    losses = [r["mean_d_loss"] for r in rows if isinstance(r.get("mean_d_loss"), float)]
    if losses:
        report["final_mean_d_loss"] = losses[-1]
    # straggler runs (--straggler_rate): accepted-feedback counts per row
    nfb = [r["n_feedbacks"] for r in rows if isinstance(r.get("n_feedbacks"), float)]
    if nfb:
        report["n_feedbacks"] = {"mean": float(np.mean(nfb)),
                                 "min": int(min(nfb)), "max": int(max(nfb))}
    return report


def _fig_stem(path: Path) -> str:
    """Figure/label stem of a span CSV: basename minus .logs.csv[.gz]."""
    stem = path.name
    for suffix in (".gz", ".csv", ".logs"):
        stem = stem[: -len(suffix)] if stem.endswith(suffix) else stem
    return stem


def plot_file(path: Path, out_dir: Path) -> None:
    """Render the reference notebook's figure kinds: per-op mean-duration
    bars, per-round duration series, loss curve, FID/IS curves
    (plot_logs.ipynb cells 14-24)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = spans_lib.read_spans(path)
    durations = spans_lib.span_durations(rows)
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = _fig_stem(path)

    ops = [(op, np.mean(ds)) for op, ds in sorted(durations.items()) if ds]
    if ops:
        fig, ax = plt.subplots(figsize=(8, 4))
        ax.barh([o for o, _ in ops], [d * 1e3 for _, d in ops])
        ax.set_xlabel("mean duration (ms)")
        ax.set_title(f"{stem}: per-operation mean time")
        fig.tight_layout()
        fig.savefig(out_dir / f"{stem}.ops.png", dpi=120)
        plt.close(fig)

    # pair epoch label and duration per ROW (a row missing either field is
    # dropped as a unit) — zipping the separately-filtered lists would silently
    # shift the x-axis whenever one row lacks only one of the two
    ep_dur = [
        (r["epoch"], r["end.epoch"] - r["start.epoch"]) for r in rows
        if isinstance(r.get("epoch"), float)
        and isinstance(r.get("start.epoch"), float)
        and isinstance(r.get("end.epoch"), float)
    ]
    if ep_dur:
        fig, ax = plt.subplots(figsize=(8, 3))
        ax.plot([e for e, _ in ep_dur], [d for _, d in ep_dur])
        ax.set_xlabel("round")
        ax.set_ylabel("row duration (s)")
        ax.set_title(f"{stem}: duration per logged row")
        fig.tight_layout()
        fig.savefig(out_dir / f"{stem}.epoch_time.png", dpi=120)
        plt.close(fig)

    losses = [(r["epoch"], r["mean_d_loss"]) for r in rows
              if isinstance(r.get("mean_d_loss"), float)]
    if losses:
        fig, ax = plt.subplots(figsize=(8, 3))
        ax.plot(*zip(*losses))
        ax.set_xlabel("round")
        ax.set_ylabel("mean D loss")
        ax.set_title(f"{stem}: discriminator loss")
        fig.tight_layout()
        fig.savefig(out_dir / f"{stem}.d_loss.png", dpi=120)
        plt.close(fig)

    for metric in ("fid", "is", "fid_standard", "is_standard", "n_feedbacks"):
        pts = [(r["epoch"], r[metric]) for r in rows
               if isinstance(r.get(metric), float)]
        if pts:
            fig, ax = plt.subplots(figsize=(8, 3))
            ax.plot(*zip(*pts), marker="o")
            ax.set_xlabel("round")
            ax.set_ylabel(metric)
            ax.set_title(f"{stem}: {metric}")
            fig.tight_layout()
            fig.savefig(out_dir / f"{stem}.{metric}.png", dpi=120)
            plt.close(fig)

    # sent/recv payload sizes per round (plot_logs.ipynb cell 14)
    size_pts = [
        (r["epoch"], r.get("size.sent"), r.get("size.recv")) for r in rows
        if isinstance(r.get("epoch"), float)
        and (isinstance(r.get("size.sent"), float)
             or isinstance(r.get("size.recv"), float))
    ]
    if size_pts and any(s or v for _, s, v in size_pts):
        fig, ax = plt.subplots(figsize=(8, 3))
        es = [e for e, _, _ in size_pts]
        ax.plot(es, [s if isinstance(s, float) else 0.0 for _, s, _ in size_pts],
                label="size.sent")
        ax.plot(es, [v if isinstance(v, float) else 0.0 for _, _, v in size_pts],
                label="size.recv", linestyle="--")
        for static in ("size.data", "size.feedback", "size.model"):
            val = next((r.get(static) for r in rows
                        if isinstance(r.get(static), float)), None)
            if val:
                ax.axhline(val, linewidth=0.8, alpha=0.5)
                ax.annotate(f"{static}={val:.2f}MB", (es[0], val), fontsize=7)
        ax.set_xlabel("round")
        ax.set_ylabel("MB")
        ax.set_title(f"{stem}: payload sizes per round")
        ax.legend(fontsize=8)
        fig.tight_layout()
        fig.savefig(out_dir / f"{stem}.sizes.png", dpi=120)
        plt.close(fig)


def plot_timeline(paths: List[Path], out_path: Path, max_rows: int = 10) -> bool:
    """Op-timeline (Gantt) across actors — the reference's ``timeline_10`` /
    ``timeline_1`` report figures (plot_logs.ipynb cell 24): one lane per
    (actor, op), one bar per logged start./end. span, first ``max_rows`` rows
    of each file, all on a shared wall-clock axis.

    Returns False (and writes nothing) when no file contributes a span.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    lanes: List[tuple] = []  # (label, [(start, dur), ...])
    t0 = None
    for path in paths:
        rows = spans_lib.read_spans(path, max_rows=max_rows)
        actor = _fig_stem(path)
        per_op: dict = {}
        for row in rows:
            for key, val in row.items():
                if not key.startswith("start.") or not isinstance(val, float):
                    continue
                op = key[len("start."):]
                end = row.get(f"end.{op}")
                if not isinstance(end, float) or end <= val:
                    continue
                per_op.setdefault(op, []).append((val, end - val))
                t0 = val if t0 is None else min(t0, val)
        for op, bars in sorted(per_op.items()):
            lanes.append((f"{actor}: {op}", bars))
    if not lanes or t0 is None:
        return False

    fig, ax = plt.subplots(figsize=(11, 0.35 * len(lanes) + 1.5))
    cmap = plt.get_cmap("tab20")
    for i, (label, bars) in enumerate(lanes):
        ax.broken_barh([(s - t0, d) for s, d in bars], (i - 0.4, 0.8),
                       facecolors=cmap(i % 20))
    ax.set_yticks(range(len(lanes)))
    ax.set_yticklabels([l for l, _ in lanes], fontsize=7)
    ax.invert_yaxis()
    ax.set_xlabel("wall-clock time since first span (s)")
    ax.set_title(f"operation timeline (first {max_rows} rows per actor)")
    fig.tight_layout()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return True


HOST_COLUMNS = ("time", "cpu_percent", "mem_used_mb")


def _compare_labels(paths: List[Path]) -> List[str]:
    """Legend labels for a cross-run overlay: runs usually share a filename
    (runA/server.logs.csv vs runB/server.logs.csv — and the parent dir alone
    can collide too, e.g. runA/logs/), so take the shortest trailing path
    suffix that makes every label unique; filenames reduce to their
    :func:`_fig_stem` (no ``.logs.csv[.gz]``)."""
    k = 1
    while True:
        labels = ["/".join((*p.parts[-k:-1], _fig_stem(p))) for p in paths]
        if (len(set(labels)) == len(labels)
                or k >= max(len(p.parts) for p in paths)):
            return labels
        k += 1


def plot_compare(paths: List[Path], out_dir: Path) -> bool:
    """Cross-run overlay figures: FID / IS / D-loss / n_feedbacks curves from
    several runs on shared axes, labeled by file stem — the reference
    report's cross-run figure family (its ``results.tex`` compares
    ``CIFAR10.standalone`` vs ``.4`` vs ``.10`` FID/IS curves produced by
    ``plot_logs.ipynb`` over multiple runs' CSVs)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_dir.mkdir(parents=True, exist_ok=True)
    parsed = [(p, spans_lib.read_spans(p)) for p in paths]  # parse each ONCE
    labels = _compare_labels([p for p, _ in parsed])
    wrote = False
    for metric in ("fid", "is", "fid_standard", "is_standard",
                   "mean_d_loss", "n_feedbacks"):
        runs = []
        for label, (_, rows) in zip(labels, parsed):
            pts = [(r["epoch"], r[metric]) for r in rows
                   if isinstance(r.get(metric), float)
                   and isinstance(r.get("epoch"), float)]
            if pts:
                runs.append((label, pts))
        if len(runs) < 2:
            continue  # an overlay of one curve is just plot_file's figure
        fig, ax = plt.subplots(figsize=(8, 4))
        for stem, pts in runs:
            ax.plot([e for e, _ in pts], [v for _, v in pts],
                    marker="o" if len(pts) < 200 else None,
                    markersize=3, label=stem)
        ax.set_xlabel("round")
        ax.set_ylabel(metric)
        ax.set_title(f"{metric}: {len(runs)} runs")
        ax.legend(fontsize=8)
        fig.tight_layout()
        fig.savefig(out_dir / f"compare.{metric}.png", dpi=120)
        plt.close(fig)
        wrote = True
    return wrote


def is_host_csv(path: Path) -> bool:
    """A ``--host_metrics`` CSV (obs/hostmon.py), not a span CSV."""
    with spans_lib.open_maybe_gz(path) as f:
        header = f.readline().strip().split(",")
    return all(c in header for c in HOST_COLUMNS)


def analyze_host_file(path: Path) -> dict:
    """Summary stats over a host-metrics CSV — the reference's
    ``gce_stats/gce_stats.ipynb`` reduction (cpu/mem/net per run)."""
    import csv as csv_mod

    with spans_lib.open_maybe_gz(path) as f:
        rows = list(csv_mod.DictReader(f))
    t = np.array([float(r["time"]) for r in rows])
    cpu = np.array([float(r["cpu_percent"]) for r in rows])
    mem = np.array([float(r["mem_used_mb"]) for r in rows])
    rx = np.array([float(r["net_recv_mb"]) for r in rows])
    tx = np.array([float(r["net_sent_mb"]) for r in rows])
    return {
        "file": str(path), "rows": len(rows), "kind": "host_metrics",
        "duration_s": float(t[-1] - t[0]) if len(t) > 1 else 0.0,
        "cpu_mean_pct": float(cpu.mean()), "cpu_max_pct": float(cpu.max()),
        "mem_mean_mb": float(mem.mean()), "mem_max_mb": float(mem.max()),
        "net_recv_mb": float(rx[-1] - rx[0]) if len(rx) > 1 else 0.0,
        "net_sent_mb": float(tx[-1] - tx[0]) if len(tx) > 1 else 0.0,
    }


def plot_host_file(path: Path, out_dir: Path) -> bool:
    """cpu%/memory/net-rate curves (gce_stats.ipynb figure kinds)."""
    import csv as csv_mod

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with spans_lib.open_maybe_gz(path) as f:
        rows = list(csv_mod.DictReader(f))
    if len(rows) < 2:
        return False
    t = np.array([float(r["time"]) for r in rows])
    t_rel = t - t[0]
    cpu = np.array([float(r["cpu_percent"]) for r in rows])
    mem = np.array([float(r["mem_used_mb"]) for r in rows])
    rx = np.array([float(r["net_recv_mb"]) for r in rows])
    tx = np.array([float(r["net_sent_mb"]) for r in rows])
    dt = np.clip(np.diff(t), 1e-9, None)

    fig, axes = plt.subplots(3, 1, figsize=(8, 8), sharex=True)
    axes[0].plot(t_rel, cpu)
    axes[0].set_ylabel("cpu %")
    axes[1].plot(t_rel, mem / 1024.0)
    axes[1].set_ylabel("mem used (GB)")
    axes[2].plot(t_rel[1:], np.diff(rx) / dt, label="recv MB/s")
    axes[2].plot(t_rel[1:], np.diff(tx) / dt, label="sent MB/s")
    axes[2].set_ylabel("net rate")
    axes[2].set_xlabel("seconds")
    axes[2].legend()
    fig.suptitle(Path(path).name)
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{Path(path).stem}.host.png"
    fig.savefig(out, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return True


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("csvs", nargs="+")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument("--plot", type=str, default=None, metavar="DIR",
                   help="write per-op / loss / FID / payload-size / timeline "
                        "figure PNGs here (the reference plot_logs.ipynb figures)")
    p.add_argument("--timeline_rounds", type=int, default=10,
                   help="rows per actor in the op-timeline Gantt "
                        "(reference timeline_10/timeline_1 figures)")
    p.add_argument("--compare", action="store_true",
                   help="with --plot and 2+ span CSVs: overlay their FID/IS/"
                        "loss curves on shared axes (the reference report's "
                        "cross-run standalone-vs-N-workers figures)")
    args = p.parse_args(argv)
    if args.plot:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            raise SystemExit("--plot needs matplotlib, which is not installed; "
                             "run without --plot for the report") from None

    span_csvs, host_csvs = [], []
    for c in args.csvs:  # classify each file once
        (host_csvs if is_host_csv(Path(c)) else span_csvs).append(Path(c))
    reports = [analyze_file(c) for c in span_csvs]
    reports += [analyze_host_file(c) for c in host_csvs]
    if args.plot:
        for c in span_csvs:
            plot_file(c, Path(args.plot))
        for c in host_csvs:
            plot_host_file(c, Path(args.plot))
        if span_csvs:
            plot_timeline(span_csvs, Path(args.plot) / "timeline.png",
                          max_rows=args.timeline_rounds)
        if args.compare and len(span_csvs) >= 2:
            plot_compare(span_csvs, Path(args.plot))
    if args.json:
        print(json.dumps(reports, indent=2))
        return 0
    for rep in reports:
        print(f"\n== {rep['file']} ({rep['rows']} rows) ==")
        if rep.get("kind") == "host_metrics":
            print(f"  {rep['duration_s']:.0f}s sampled: "
                  f"cpu mean {rep['cpu_mean_pct']:.1f}% max {rep['cpu_max_pct']:.1f}%, "
                  f"mem mean {rep['mem_mean_mb']:.0f}MB max {rep['mem_max_mb']:.0f}MB, "
                  f"net recv {rep['net_recv_mb']:.1f}MB sent {rep['net_sent_mb']:.1f}MB")
            continue
        if "rounds_per_sec" in rep:
            print(f"  rounds/sec: {rep['rounds_per_sec']:.3f} "
                  f"({rep['rounds']} rounds in {rep['wall_s']:.1f}s)")
        for op, st in rep["ops"].items():
            print(f"  {op:22s} n={st['count']:6d} mean={st['mean_s']*1e3:9.2f}ms "
                  f"median={st['median_s']*1e3:9.2f}ms p95={st['p95_s']*1e3:9.2f}ms")
        if "best_fid" in rep:
            print(f"  best FID: {rep['best_fid']:.2f}   best IS: {rep.get('best_is', float('nan')):.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
