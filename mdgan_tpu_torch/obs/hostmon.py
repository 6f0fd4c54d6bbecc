"""Host resource monitoring to CSV.

Copy of ``mdgan_tpu/obs/hostmon.py:1-100`` (the module imports no JAX).

The reference's infra-level observability is Google Cloud Monitoring CSV
exports — CPU utilization, memory, disk, network bytes per run
(reference ``gce_stats/gce_stats.ipynb`` + ``gce_stats/data/.../{cpu,net,
sent,recv}.csv``).  This is the self-contained analogue: a background thread
samples ``/proc`` at a fixed period and appends rows to a CSV with the same
kinds of columns, so the same style of analysis applies without any cloud
dependency.
"""

from __future__ import annotations

import csv
import threading
import time
from pathlib import Path
from typing import Optional


def _read_cpu_times():
    with open("/proc/stat") as f:
        parts = f.readline().split()[1:]
    vals = [int(x) for x in parts]
    idle = vals[3] + (vals[4] if len(vals) > 4 else 0)
    return sum(vals), idle


def _read_meminfo():
    total = avail = 0
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                total = int(line.split()[1])
            elif line.startswith("MemAvailable:"):
                avail = int(line.split()[1])
    return total, avail


def _read_netdev():
    rx = tx = 0
    with open("/proc/net/dev") as f:
        for line in f.readlines()[2:]:
            name, data = line.split(":", 1)
            if name.strip() == "lo":
                continue
            cols = data.split()
            rx += int(cols[0])
            tx += int(cols[8])
    return rx, tx


class HostMonitor:
    """Samples cpu%, memory, and network byte counters to a CSV."""

    COLUMNS = ["time", "cpu_percent", "mem_used_mb", "mem_total_mb",
               "net_recv_mb", "net_sent_mb"]

    def __init__(self, path, period_s: float = 5.0):
        self.path = Path(path)
        self.period = period_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._file = open(self.path, "a", newline="", encoding="utf-8")
        self._writer = csv.DictWriter(self._file, fieldnames=self.COLUMNS)
        if self._file.tell() == 0:
            self._writer.writeheader()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        prev_total, prev_idle = _read_cpu_times()
        rx0, tx0 = _read_netdev()
        while not self._stop.wait(self.period):
            total, idle = _read_cpu_times()
            dt_total, dt_idle = total - prev_total, idle - prev_idle
            prev_total, prev_idle = total, idle
            cpu = 100.0 * (1 - dt_idle / dt_total) if dt_total else 0.0
            mem_total, mem_avail = _read_meminfo()
            rx, tx = _read_netdev()
            self._writer.writerow({
                "time": time.time(),
                "cpu_percent": round(cpu, 2),
                "mem_used_mb": round((mem_total - mem_avail) / 1024, 1),
                "mem_total_mb": round(mem_total / 1024, 1),
                "net_recv_mb": round((rx - rx0) / 1024**2, 3),
                "net_sent_mb": round((tx - tx0) / 1024**2, 3),
            })
            self._file.flush()

    def stop(self):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=self.period + 1)
            self._file.close()
            self._thread = None
