"""On the H100 at the cells' own sizes (marked ``card``; they skip without a
card): each one-card cell's program within its limits on fresh seeds, and
its control and planted faults (in the reference put in the program's place)
outside them; then a short run of the cell with ``correct`` true.

    python -m pytest perfbench/tests -m card -q
"""

import time

import pytest

from perfbench import calibrate, check, harness, spec
from perfbench.tests import tiny

SINGLE = [c for c in tiny.cells() if spec.cell(c).chips == 1]


@pytest.mark.card
@pytest.mark.parametrize("name", SINGLE)
def test_limits_separate_program_and_control(card, name):
    rows = []
    calibrate.readings(name, [2 ** 31 + 501, 2 ** 31 + 502, 2 ** 31 + 503], 3,
                       emit=lambda line: rows.append(line))
    import json

    cell = spec.cell(name)
    for row in map(json.loads, rows):
        values = {k: (row[k], "") for k in row["worst"]}
        assert check.verdict(values, cell.limits) == (row["kind"] == "program"), row


@pytest.mark.card
@pytest.mark.parametrize("name", SINGLE)
def test_short_run_is_correct(card, name):
    result, _ = harness.run(name, 2 ** 31 + 601, 2.0, 0, "cuda", time.perf_counter())
    assert result["correct"] and result["failed"] == 0
