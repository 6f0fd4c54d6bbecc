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

**Phase spans** (:func:`phase`): the engines' and the trainer's phases
(``engine.round``, ``engine.d_step``, ``trainer.swap``, ...), recorded only
while a ``torch.profiler`` session runs: each shows in the profiler's trace
as a ``record_function`` range and is kept in memory, stamped with
``time.time_ns()`` (the clock of the profiler's events), for :func:`totals`,
:func:`records` and :func:`write_json`.  Without a profiler a span costs
one flag test at the outermost span of a thread and a nesting count.
"""

from __future__ import annotations

import csv
import json
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from time import time_ns
from typing import Dict, List, Optional, Tuple

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
        """The row's ``start.<op>``/``end.<op>`` pair, and the phase span
        ``trainer.<op>`` (:func:`phase`)."""
        assert self.row is not None, "begin_row first"
        self.row[f"start.{op}"] = time.time()
        try:
            with phase(f"trainer.{op}"):
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


# --- phase spans ---------------------------------------------------------------

# (name, parent index or -1, step or None, thread id, t0_ns, t1_ns or None
# while open), in the order the spans started
Record = Tuple[str, int, Optional[int], int, int, Optional[int]]
FIELDS = ("name", "parent", "step", "thread", "t0_ns", "t1_ns")

_records: List[list] = []       # the latest profiled run's spans, as mutable Records
_lock = threading.Lock()        # guards _records' indices


class _Thread(threading.local):
    """A thread's open spans: whether one is open, whether they record (the
    answer of the outermost; a profiler runs on the thread that started
    it), the record indices of the recording ones, and whether the
    thread's latest outermost span recorded."""

    def __init__(self):
        self.inside = False
        self.on = False
        self.open: List[int] = []
        self.last_on = False


_thread = _Thread()


class _Null:
    """A span nested in one that does not record: nothing at all."""

    __slots__ = ()

    def __enter__(self):
        pass

    def __exit__(self, *exc):
        pass


class _OffTop:
    """An outermost span while no profiler runs: it marks the thread as
    inside a span, so the spans nested in it need not ask the profiler."""

    __slots__ = ()

    def __enter__(self):
        _thread.inside = True

    def __exit__(self, *exc):
        _thread.inside = False


_NULL, _OFF_TOP = _Null(), _OffTop()


class _On:
    """A recording span: a ``record_function`` range and one record.  The
    record's clock is read before the range opens and after it closes, so
    it holds the range: the profiler stamps its event's start and end
    inside ``record_function``'s enter and exit, which take tens of us
    under a profiler."""

    __slots__ = ("name", "step", "top", "rf", "rec")

    def __init__(self, name: str, step: Optional[int], top: bool):
        self.name, self.step, self.top = name, step, top

    def __enter__(self):
        from torch.autograd.profiler import record_function

        t = _thread
        t.inside = True
        self.rf = record_function(self.name)
        with _lock:
            i = len(_records)
            self.rec = [self.name, t.open[-1] if t.open else -1, self.step,
                        threading.get_ident(), time_ns(), None]
            _records.append(self.rec)
        t.open.append(i)
        self.rf.__enter__()

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        self.rec[5] = time_ns()
        t = _thread
        t.open.pop()
        if self.top:
            t.inside = False


def phase(name: str, step: Optional[int] = None):
    """A context manager spanning one phase of the program, recorded while a
    ``torch.profiler`` session runs.

    The outermost span of a thread asks the profiler whether it is on, and
    the spans nested in it take that answer.  Off, a span reads no clock,
    makes no ``record_function`` call and allocates nothing.  On, it opens
    ``record_function(name)`` and keeps ``(name, parent, step, thread,
    t0_ns, t1_ns)``; an outermost span that records after one that did not
    starts the record anew, so it holds the latest profiled run (two
    profiler sessions with no span between them share one record).  A span
    adds no device work, synchronization or host read."""
    t = _thread
    if t.inside:
        return _On(name, step, False) if t.on else _NULL
    import torch  # here, so that the CSV tools import no torch

    t.on = torch.autograd._profiler_enabled()
    if t.on and not t.last_on:
        with _lock:
            _records.clear()
    t.last_on = t.on
    return _On(name, step, True) if t.on else _OFF_TOP


def records() -> List[Record]:
    """The record, in the order the spans started (``t1_ns`` None while a
    span is open)."""
    with _lock:
        return [tuple(r) for r in _records]


def totals() -> Dict[str, Tuple[int, int, int]]:
    """``{name: (count, total_ns, self_ns)}`` of the record's closed spans;
    self time is a span's duration less its children's."""
    recs = records()
    out: Dict[str, List[int]] = {}
    for name, parent, _, _, t0, t1 in recs:
        if t1 is None:
            continue
        agg = out.setdefault(name, [0, 0, 0])
        agg[0] += 1
        agg[1] += t1 - t0
        agg[2] += t1 - t0
        if parent >= 0 and recs[parent][5] is not None:   # counted already
            out[recs[parent][0]][2] -= t1 - t0
    return {k: tuple(v) for k, v in out.items()}


def write_json(path) -> None:
    """The record and its totals as JSON: ``{"fields", "records",
    "totals"}``."""
    Path(path).write_text(json.dumps({"fields": FIELDS, "records": records(),
                                      "totals": totals()}))
