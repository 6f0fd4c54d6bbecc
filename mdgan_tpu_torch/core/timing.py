"""Device timing of CUDA work with the host's issue hidden, and byte/op bounds.

Used by ``chip_smoke.py`` and the port's CLI tools.  A small kernel
finishes on the device long before the host has issued the next launch, so
CUDA events around a host loop measure the host's issue interval.
:func:`time_ms` queues the timed calls behind a device sleep that outlasts
their issue, so the device runs them back to back and the events see device
time only.  :func:`card_line` reads the card's name and power limit, which
every time kept is written beside.  Nothing here runs at import.
"""

from __future__ import annotations

import functools
import subprocess
import time
from typing import Optional

HBM_BYTES_PER_S = 3.35e12   # H100 SXM (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores


def card_line() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` gives them ("NVIDIA
    H100 80GB HBM3, 700.00 W"), or None where it cannot be read."""
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = proc.stdout.strip().splitlines()
    return lines[0] if proc.returncode == 0 and lines else None


def bound_ms(nbytes: float, ops: float):
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


@functools.lru_cache(maxsize=None)
def sleep_cycles_per_ms() -> float:
    """``torch.cuda._sleep``'s rate on this card, measured once."""
    import torch

    cycles = 20_000_000
    torch.cuda._sleep(cycles // 10)  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def time_ms(fn, iters: int, warmup: int = 3) -> dict:
    """Device milliseconds per call of ``fn``, with the host's issue hidden,
    and the host's issue time per call (``host_us_per_call``).

    The timed calls are queued behind a ``torch.cuda._sleep`` that outlasts
    their issue, so the device runs their launches back to back and the CUDA
    events around them see device time only.  Whether the sleep was still
    running when the host had issued the last call is checked with
    ``Event.query``; the sleep grows until it was, at most 4 times, and a
    reading that the host's issue could still reach raises.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    issue_ms = (time.perf_counter() - t) * 1e3  # an upper bound on the issue time
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = int(sleep_cycles_per_ms() * (2 * issue_ms + 1.0))
    for _ in range(4):
        torch.cuda._sleep(cycles)
        start.record()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        host_s = time.perf_counter() - t
        end.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if covered:
            return {"ms": start.elapsed_time(end) / iters,
                    "host_us_per_call": host_s / iters * 1e6}
        cycles *= 4
    raise RuntimeError(f"time_ms: a {cycles // 4}-cycle sleep did not outlast the issue "
                       f"of {iters} calls; no device time was read")
