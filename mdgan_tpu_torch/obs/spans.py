"""Per-operation wall-clock span logging to CSV.

Copy of ``mdgan_tpu/obs/spans.py:1-223`` (the module imports no JAX): the
same server and worker columns in the same order
(``server_row_template``, ``:44``; ``worker_row_template``, ``:76``), so
``mdgan_tpu/cli/analyze.py`` reads the port's CSVs unchanged.

Rebuilds the reference's hand-rolled tracing channel: each actor appends one
row per round with ``start.<op>`` / ``end.<op>`` timestamp pairs
(reference ``src/actors/server.py:178-211, 370``; ``worker.py:128-155, 286``;
op semantics documented in the reference report ``appendix/operations.tex``).

We keep the exact column schema (so the reference's ``plot_logs``-style
analysis ports over) while noting the semantic shift: ops that were separate
network phases in the reference (``send_data``, ``recv_data``) are fused into
the round here, so the trainer logs them as zero-width spans and records
the real on-device work under ``epoch_calculation``.  For on-device breakdowns
use the CLI's ``--profile_dir`` (a ``torch.profiler`` trace).

Worker swap ops (``swap_recv_instruction`` / ``swap_send`` / ``swap_recv`` /
``load_state_dict``, measured per phase by the reference at
``worker.py:239-284``): here the swap is one gather per arena on the device, so on swap
rounds the trainer attributes the measured program span to both
``swap_send`` and ``swap_recv`` (the exchange is simultaneous) and logs
``swap_recv_instruction`` / ``load_state_dict`` as zero-width marks at the
window edges — those two phases have no physical counterpart in an in-place
swap (see ``MDGANTrainer._write_rows_for_chunk``).  A worker-CSV Gantt thus
shows the real swap cost on the rows that paid it.
"""

from __future__ import annotations

import csv
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional

SERVER_OPS = [
    "epoch", "epoch_calculation", "send_data", "recv_data", "calc_gradients",
    "agg_gradients", "generate_data", "fid", "is", "swap",
]
WORKER_OPS = [
    "epoch", "calc_gradients", "recv_data", "send", "swap_recv_instruction",
    "load_state_dict", "swap_recv", "swap_send",
]


def server_row_template(epoch: int, size_data_mb: float, size_feedback_mb: float,
                        straggler: bool = False) -> Dict:
    """Column layout of the reference server CSV (``server.py:179-208``).

    ``straggler=True`` (runs with ``straggler_rate > 0``) appends an
    ``n_feedbacks`` column — the number of worker feedbacks the server
    accepted in the row's round under the simulated timeout policy
    (reference proposal ``discussion.tex:51-55``).  Kept opt-in so parity
    runs emit the byte-stable superset schema the goldens pin.
    """
    row = {"epoch": epoch}
    for op in SERVER_OPS:
        row[f"start.{op}"] = None
        row[f"end.{op}"] = None
    row.update({
        "fid": None, "is": None,
        "size.data": size_data_mb, "size.feedback": size_feedback_mb,
        "swap": False, "size.sent": 0.0, "size.recv": 0.0,
        # rebuild-superset columns (absent in the reference; appended after
        # the reference schema so prefix parity holds): standard-protocol
        # metrics, plus a real span for full-state checkpoint handoff — the
        # reference has no checkpointing op, and reusing one of its ops
        # (e.g. agg_gradients) would misattribute checkpoint time in any
        # schema-parity tooling
        "fid_standard": None, "is_standard": None,
        "start.checkpoint": None, "end.checkpoint": None,
    })
    if straggler:
        row["n_feedbacks"] = None
    return row


def worker_row_template(epoch: int, model_size_mb: float) -> Dict:
    """Column layout of the reference worker CSV (``worker.py:129-152``)."""
    row = {"epoch": epoch}
    for op in WORKER_OPS:
        row[f"start.{op}"] = None
        row[f"end.{op}"] = None
    row.update({
        "swap_with": None, "mean_d_loss": None,
        "size.model": model_size_mb, "size.sent": 0.0, "size.recv": 0.0,
    })
    return row


class SpanLogger:
    """Appends rows with start./end. span pairs to a CSV file."""

    def __init__(self, path: Path, template: Dict):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fieldnames = list(template.keys())
        self._file = open(self.path, "a", encoding="utf-8", newline="")
        self._writer = csv.DictWriter(self._file, fieldnames=self._fieldnames)
        if self._file.tell() == 0:
            self._writer.writeheader()
        self.row: Optional[Dict] = None

    def begin_row(self, template: Dict) -> None:
        self.row = dict(template)
        self.row["start.epoch"] = time.time()
        if "start.epoch_calculation" in self.row:
            self.row["start.epoch_calculation"] = time.time()

    @contextmanager
    def span(self, op: str):
        assert self.row is not None, "begin_row first"
        self.row[f"start.{op}"] = time.time()
        try:
            yield
        finally:
            self.row[f"end.{op}"] = time.time()

    def mark(self, **values) -> None:
        assert self.row is not None
        self.row.update(values)

    def take_row(self) -> Dict:
        """Finalize the row's timestamps and detach it WITHOUT writing.

        Used by the async-eval path: the trainer holds finished rows until
        their background FID/IS marks arrive, then writes them in order via
        :meth:`write_row` — row order in the CSV stays strictly by round,
        matching the reference's synchronous logs.
        """
        assert self.row is not None
        if "end.epoch_calculation" in self.row and self.row["end.epoch_calculation"] is None:
            self.row["end.epoch_calculation"] = time.time()
        self.row["end.epoch"] = time.time()
        row, self.row = self.row, None
        return row

    def write_row(self, row: Dict) -> None:
        self._writer.writerow(row)
        self._file.flush()

    def write_raw_rows(self, rows: List[List]) -> None:
        """Bulk append value-lists already in fieldname order.

        Fast path for high-volume per-round logs (30k rounds x N workers):
        a plain ``csv.writer`` skips DictWriter's per-row key mapping
        (~10x less host time for identical output; None still renders "").
        """
        csv.writer(self._file).writerows(rows)
        self._file.flush()

    def end_row(self) -> None:
        self.write_row(self.take_row())

    def close(self) -> None:
        self._file.close()


class NullSpanLogger(SpanLogger):
    """Interface-identical logger that writes nothing.

    Used by non-primary processes in multi-host runs: every process runs the
    same host loop (row bookkeeping included, so control flow stays lockstep)
    but only process 0 owns the CSV files — the reference's analogue is that
    only the server process writes ``server.logs.csv`` (``server.py:209``).
    """

    def __init__(self, template: Dict):
        self._fieldnames = list(template.keys())
        self.row: Optional[Dict] = None

    def write_row(self, row: Dict) -> None:
        pass

    def write_raw_rows(self, rows: List[List]) -> None:
        pass

    def close(self) -> None:
        pass


def open_maybe_gz(path):
    """Text-mode open that handles ``.csv.gz`` transparently — the shared
    opener for every CSV the tooling reads (the committed scale runs gzip
    their per-worker logs — 20-40 workers × 5-10k rounds each)."""
    import gzip

    opener = gzip.open if str(path).endswith(".gz") else open
    return opener(path, "rt", encoding="utf-8")


def read_spans(path: Path, max_rows: Optional[int] = None) -> List[Dict]:
    """Parse a span CSV back into rows with float timestamps (the analysis
    side of the reference's ``plot_logs.ipynb`` cell 3).  ``max_rows`` stops
    reading early (e.g. timeline figures use only the first few rows)."""
    out = []
    with open_maybe_gz(path) as f:
        for row in csv.DictReader(f):
            if max_rows is not None and len(out) >= max_rows:
                break
            parsed = {}
            for key, val in row.items():
                if val in ("", "None", None):
                    parsed[key] = None
                else:
                    try:
                        parsed[key] = float(val)
                    except ValueError:
                        parsed[key] = val
            out.append(parsed)
    return out


def span_durations(rows: List[Dict]) -> Dict[str, List[float]]:
    """Pair start.X/end.X into per-op duration lists
    (= ``compute_time_elapsed`` in the reference notebook)."""
    durations: Dict[str, List[float]] = {}
    for row in rows:
        for key in row:
            if key.startswith("start."):
                op = key[len("start."):]
                s, e = row.get(f"start.{op}"), row.get(f"end.{op}")
                if isinstance(s, float) and isinstance(e, float):
                    durations.setdefault(op, []).append(e - s)
    return durations
