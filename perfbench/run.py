"""One run of one benchmark cell on the card; the last line of standard
output is the result (perfbench/README.md).

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root, not this folder, heads the path: a module here must
# not shadow one of the standard library's
sys.path[0] = str(ROOT)
# kernel caches at fixed paths inside the checkout (the program's own nvcc
# build goes to <checkout>/build as well)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
# one host thread for CPU operators: the round's host work is the main
# thread's issue, and idle pool threads would only contend with it
os.environ["OMP_NUM_THREADS"] = "1"

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(harness.main(sys.argv[1:], T_START))
