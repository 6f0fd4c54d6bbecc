"""A rank past the first of a cell on several cards, started by
``perfbench/run.py`` (``harness.ranked``); prints nothing.

    python3 perfbench/rank.py '<json: job, cell, overrides, device, rank, world, port>'
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parents[1])

from perfbench import harness, spec  # noqa: E402


def main() -> int:
    a = json.loads(sys.argv[1])
    rk = harness.Rank(spec.cell(a["cell"], a["overrides"]), a["device"], a["rank"], a["world"],
                      a["port"])
    harness.drive(rk, a["job"], T_START)
    rk.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
