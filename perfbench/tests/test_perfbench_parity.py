"""The reference against the program at small sizes on the CPU, both in
float32: one cell's set-up and check rounds, read as a run reads them; and
the control (the reference in float8) coming out as not correct."""

import pytest
import torch

from perfbench import check, harness, spec
from perfbench.tests import tiny

SINGLE = [c for c in tiny.cells() if spec.cell(c).chips == 1]


@pytest.fixture(scope="module")
def readings():
    """(cell, the program's readings, the reference's, the control's) a
    one-card cell, seed 3."""
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # one summation order on both sides
    for name in SINGLE:
        cell = spec.cell(name, tiny.overrides(name))
        rk = harness.Rank(cell, "cpu")
        prog = rk.prepare(3)
        rk.free()
        dev = torch.device("cpu")
        out[name] = (cell, prog, harness.reference(cell, 3, dev),
                     harness.reference(cell, 3, dev, "fp8"))
    torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("name", SINGLE)
def test_first_round_agrees(readings, name):
    cell, prog, ref, _ = readings[name]
    values = {k: v for k, (v, _) in check.numbers(prog, ref).items()}
    # the first round starts from the same weights and inputs: float32
    # rounding only (Adam's first step, sign-like, amplifies it after)
    assert values["first_loss_gap"] < 1e-5, values
    assert values["grad_gap"] < 1e-4 and values["median_grad_err"] < 1e-4, values
    assert check.verdict(check.numbers(prog, ref), cell.limits)


@pytest.mark.parametrize("name", SINGLE)
def test_control_is_not_correct(readings, name):
    cell, _, ref, control = readings[name]
    assert not check.verdict(check.numbers(control, ref), cell.limits)


@pytest.mark.parametrize("name", SINGLE)
def test_gather_fault_is_not_correct(readings, name):
    """Every round of the multi-round check chunk fed its first round's rows."""
    cell, _, ref, _ = readings[name]
    fault = harness.reference(cell, 3, torch.device("cpu"), "float32", "gather")
    assert not check.verdict(check.numbers(fault, ref), cell.limits)


def test_leaf_gap_measures():
    ref = {"g/a": 1.0, "g/b": 4.0, "g/c": 0.001, "d0/a": 2.0}
    prog = {"g/a": 1.1, "g/b": 4.0, "g/c": 0.002, "d0/a": 2.0}
    # g/c is tiny: its gap counts against the median generator leaf (1.0)
    assert check.leaf_gap(prog, ref) == (pytest.approx(0.1), "g/a")
    assert check.leaf_gap({}, ref)[0] == 1.0
    assert check.moving_leaves({"g/a": 1.0, "g/b": 1e-4, "g/c": 2.0}) == ["g/a", "g/c"]
    losses = [{"l": [1.0, 2.0]}]
    assert check.loss_gap([{"l": [1.0, 2.2]}], losses) == (pytest.approx(0.1), "round 1 l[1]")
    assert check.loss_gap([{"l": [float("nan"), 2.0]}], losses)[0] == float("inf")
