"""Runs one cell at small sizes on the CPU in a process of its own and
prints the result and the loaded forbidden modules as one JSON line:

    python perfbench/tests/runner.py <cell> <seed> <trace> [<hook>]
"""

import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
sys.path[0] = str(Path(__file__).resolve().parents[2])

from perfbench import harness  # noqa: E402
from perfbench.tests import tiny  # noqa: E402


def main() -> int:
    cell, seed, trace = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    hook = sys.argv[4] if len(sys.argv) > 4 else ""
    result, lines = harness.run(cell, seed, 0.2, trace, "cpu", T_START, tiny.overrides(cell), hook)
    print(json.dumps({"result": result, "lines": lines,
                      "forbidden": harness.forbidden_modules(),
                      "port_loaded": "mdgan_tpu_torch" in sys.modules}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
