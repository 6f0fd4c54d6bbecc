"""Reading a ``torch.profiler`` trace of the traced slice.

The slice runs inside a ``record_function(SPAN)`` span that ends after a
device synchronize, so the span's host interval holds all of its device
work.  From the profiler's raw events (``kineto_results.events()``, which
skips the building of ``FunctionEvent`` trees):

* device activity: the events on the device's track (kernels, memcpys,
  memsets), less the mirrors of host-side annotations and the
  synchronization markers, counted and summed by name;
* ``busy_ns``: the union of their intervals, within the span;
* idle gaps: the span less that union, each charged to the innermost
  operator the host thread that ran the slice was in when the gap opened,
  or, between operators, to "before <op>", the next one it entered.
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, List, Tuple

from torch.autograd import DeviceType

SPAN = "perfbench.slice"
NO_OP = "no host op"
# device-track events that are no device work: CUPTI's synchronization records
SYNC_MARKERS = ("Context Sync", "Event Sync", "Stream Sync", "Stream Wait Event", "Device Sync")
# host events that are CUDA runtime or driver calls, not operators
_RUNTIME = re.compile(r"^(cuda[A-Z_]|cu[A-Z])")


def events(prof) -> list:
    return prof.profiler.kineto_results.events()


def _on_device(e) -> bool:
    return e.device_type() == DeviceType.CUDA


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _innermost(ops: List[Tuple[int, int, str]]) -> Tuple[List[int], List[str]]:
    """A step function: from times[i] on, the innermost running op is
    labels[i]."""
    times: List[int] = []
    labels: List[str] = []
    stack: List[Tuple[int, int, str]] = []

    def pop_until(t):
        while stack and stack[-1][1] <= t:
            end = stack.pop()[1]
            times.append(end)
            labels.append(stack[-1][2] if stack else NO_OP)

    for s, e, name in sorted(ops):
        pop_until(s)
        stack.append((s, e, name))
        times.append(s)
        labels.append(name)
    pop_until(float("inf"))
    return times, labels


def summarize(evs) -> Dict:
    """``window_ns``, ``busy_ns``, ``launches`` (device events), ``by_name``
    ({name: [count, ns]}) and ``gaps`` ({host op: idle ns}) of the slice."""
    span = [e for e in evs if e.name() == SPAN and not _on_device(e)]
    if len(span) != 1:
        raise RuntimeError(f"expected one {SPAN!r} span in the trace, found {len(span)}")
    s0 = span[0].start_ns()
    s1, tid = s0 + span[0].duration_ns(), span[0].start_thread_id()
    # a host-side annotation (the slice's span, c10d's "nccl:all_reduce")
    # is mirrored on the device's track under the same name: no device work
    host_names = {e.name() for e in evs if not _on_device(e)}
    device, ops = [], []
    by_name: Dict[str, List[float]] = {}
    for e in evs:
        name, start = e.name(), e.start_ns()
        end = start + e.duration_ns()
        if _on_device(e):
            if name in host_names or name in SYNC_MARKERS:
                continue
            a, b = max(start, s0), min(end, s1)
            if b <= a:
                continue
            device.append((a, b))
            rec = by_name.setdefault(name, [0, 0])
            rec[0] += 1
            rec[1] += end - start
        elif name != SPAN and e.start_thread_id() == tid and not _RUNTIME.match(name):
            ops.append((start, end, name))
    busy = _union(device)
    times, labels = _innermost(ops)
    gaps: Dict[str, int] = {}
    edge = s0
    for s, e in busy + [(s1, s1)]:
        if s > edge:
            i = bisect.bisect_right(times, edge) - 1
            label = labels[i] if i >= 0 else NO_OP
            if label == NO_OP and i + 1 < len(labels):
                label = f"before {labels[i + 1]}"
            gaps[label] = gaps.get(label, 0) + (s - edge)
        edge = max(edge, e)
    return {"window_ns": s1 - s0, "busy_ns": sum(e - s for s, e in busy),
            "launches": len(device), "by_name": by_name, "gaps": gaps}


def top(items: Dict[str, float], n: int = 10, width: int = 160) -> List[list]:
    """The ``n`` largest entries as [[name, seconds]], names cut to ``width``."""
    ranked = sorted(items.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:width], ns / 1e9] for name, ns in ranked]
