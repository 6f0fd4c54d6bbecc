"""The readings a cell's limits are set from (``perfbench/limits/<cell>.json``),
on the card at the cell's own sizes; the benchmark's runs never call this.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,...,12 --control 3

For every seed: the program's check rounds (set-up only: training needs no
measured window) against the reference, as a run reads them.  For the first
``--control`` seeds also, each against the same reference:

* ``control``: the reference in the program's place with every convolution
  and matrix product's operands rounded to float8 e4m3 (the precision below
  the configurations' bfloat16);
* ``fault_half``: half of each real batch left out, the mean over the rest;
* ``fault_loss``: the discriminator loss reported as its real term alone;
* ``fault_gather``: every round of a check chunk fed its first round's
  real rows (a gather that reads the wrong round);
* ``fault_exchange`` (cells on several ranks): the generator hears only
  rank 0's workers.

A state returned unchanged reads 1 on ``change_gap`` by its definition and
needs no run.  Prints one JSON line a seed and reading, then a summary line:
the largest program reading of each number (the lower reading) and the
smallest of the control's and of each fault's.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parents[1])

from perfbench import check, harness  # noqa: E402


def readings(cell_name: str, seeds, n_control: int, device: str = "cuda", overrides=None,
             emit=print) -> dict:
    got, cell, rk = harness.ranked(cell_name, {"kind": "readings", "seeds": list(seeds)},
                                   device, T_START, overrides)
    ranks = cell.traffic.get("ranks", 1)
    faults = {"fault_half": "half", "fault_loss": "loss", "fault_gather": "gather"}
    if ranks > 1:
        faults["fault_exchange"] = ("exchange", 0, cell.traffic["num_workers"] // ranks)
    table: dict = {}
    for i, (seed, prog) in enumerate(zip(seeds, got["readings"])):
        ref = harness.reference(cell, seed, rk.dev)
        rows = {"program": prog}
        if i < n_control:
            rows["control"] = harness.reference(cell, seed, rk.dev, "fp8")
            for name, fault in faults.items():
                rows[name] = harness.reference(cell, seed, rk.dev, "float32", fault)
        for kind, side in rows.items():
            numbers = check.numbers(side, ref)
            values = {k: v for k, (v, _) in numbers.items()}
            emit(json.dumps({"seed": seed, "kind": kind, **values,
                             "worst": {k: at for k, (_, at) in numbers.items()}}))
            table.setdefault(kind, []).append(values)
    summary = {"program_max": {k: max(r[k] for r in table["program"]) for k in table["program"][0]}}
    for kind, rows_ in table.items():
        if kind != "program":
            summary[f"{kind}_min"] = {k: min(r[k] for r in rows_) for k in rows_[0]}
    return summary


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--control", type=int, default=3, help="seeds that also read the control "
                                                           "and the faults")
    args = p.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    print(json.dumps({"summary": readings(args.workload, seeds, args.control)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
