"""The program's own phase spans of the traced slice, for the per-layer
metrics that read them (``metrics/d_region_host_ms_per_round.py``,
``g_region_host_ms_per_round.py``, ``host_us_per_launch.py``).

The port records its spans (``engine.round``, ``engine.d_step``, ...) in
memory while a ``torch.profiler`` session runs on the thread, and starts
the record anew at the first span of a profiled run after an unprofiled
one: after a ``--trace 1`` run, rank 0's record is its traced slice
(``mdgan_tpu_torch.obs.spans.totals()``, read in rank 0's process).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple


def totals(r) -> Optional[Dict[str, Tuple[int, int, int]]]:
    """``{span: (count, total_ns, self_ns)}`` of the traced slice, or None
    where the slice drove no device (on the CPU the spans time the
    arithmetic itself, not the host's dispatch of it), where the program
    records no spans (a version without them), or where the record is not
    of this slice: its count of ``engine.round`` differs from the slice's
    rounds."""
    if not r.summary["launches"]:
        return None
    try:
        from mdgan_tpu_torch.obs import spans
    except ImportError:
        return None
    read = getattr(spans, "totals", None)
    if read is None:
        return None
    got = read()
    if got.get("engine.round", (0,))[0] != r.rounds:
        return None
    return got


def total_ns(got: Dict[str, Tuple[int, int, int]], *names: str) -> int:
    """The spans ``names``' total ns (0 for a name the record lacks)."""
    return sum(got[n][1] for n in names if n in got)
