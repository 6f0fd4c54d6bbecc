"""The readers of the program's phase spans (``perfbench/phases.py``) on a
made-up record: the metrics under their ``.device`` names in both cells,
and None where the record is empty, is not of the slice, or the slice
drove no device."""

import pytest

from perfbench import harness, spec

NAMES = ("d_region_host_ms_per_round", "g_region_host_ms_per_round", "host_us_per_launch")
# {span: (count, total_ns, self_ns)} of a made-up 4-round slice
RECORD = {
    "engine.chunk": (1, 40_000_000, 1_000_000),
    "engine.sample": (1, 100_000, 100_000),
    "engine.round": (4, 38_000_000, 2_000_000),
    "engine.generate": (4, 4_000_000, 4_000_000),
    "engine.d_step": (4, 20_000_000, 20_000_000),
    "engine.feedback": (4, 8_000_000, 8_000_000),
    "engine.g_update": (4, 4_000_000, 4_000_000),
    "engine.metrics": (1, 500_000, 500_000),
}


def reading(cell_name, rounds=4, launches=1000):
    summary = {"window_ns": 10 ** 8, "busy_ns": 10 ** 7, "launches": launches, "by_name": {},
               "gaps": {}}
    return harness.Reading(spec.cell(cell_name), {
        "rounds": 100, "window_s": 2.0,
        "ranks": [{"summary": summary, "traced_rounds": rounds, "device_busy_ns": 10 ** 7}]})


def values(r, suffix):
    return {n: spec.metric_reader(n + suffix).read(r) for n in NAMES}


@pytest.fixture
def record(monkeypatch):
    from mdgan_tpu_torch.obs import spans

    got = {}
    monkeypatch.setattr(spans, "totals", lambda: dict(got))
    return got


@pytest.mark.parametrize("cell", ["dcgan32_standalone", "dcgan32_mdgan_n8"])
def test_readers_on_a_made_up_record(record, cell):
    record.update(RECORD)
    got = values(reading(cell), ".device")
    assert got["d_region_host_ms_per_round"] == (20 + 8) / 4
    assert got["g_region_host_ms_per_round"] == (4 + 4) / 4
    assert got["host_us_per_launch"] == 40_000 / 1000


def test_standalone_cell_reports_the_readers():
    assert {n + ".device" for n in NAMES} <= {m["name"] for m in
                                              spec.cell("dcgan32_standalone").per_layer}


def test_standalone_record_without_feedback(record):
    record.update({k: v for k, v in RECORD.items() if k != "engine.feedback"})
    assert values(reading("dcgan32_standalone"), ".device")["d_region_host_ms_per_round"] == 20 / 4


@pytest.mark.parametrize("case", ["empty", "other rounds", "no device"])
def test_none_where_the_record_is_not_the_slices(record, case):
    if case != "empty":
        record.update(RECORD)
    r = reading("dcgan32_mdgan_n8", rounds=5 if case == "other rounds" else 4,
                launches=0 if case == "no device" else 1000)
    assert values(r, ".device") == {n: None for n in NAMES}


def test_none_from_a_program_without_phase_spans(monkeypatch):
    """The parent commit's program has no ``totals``: nothing is read, and
    nothing raises."""
    from mdgan_tpu_torch.obs import spans

    monkeypatch.delattr(spans, "totals")
    assert values(reading("dcgan32_standalone"), ".device") == {n: None for n in NAMES}
