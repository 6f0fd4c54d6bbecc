"""Reading a trace: busy and idle time, gaps by host operator, and the
per-layer metrics' readers, on made-up events."""

import pytest
from torch.autograd import DeviceType

from perfbench import harness, roofline, spec, trace


class Event:
    def __init__(self, name, start, dur, device=False, tid=1):
        self._n, self._s, self._d, self._dev, self._t = name, start, dur, device, tid

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return DeviceType.CUDA if self._dev else DeviceType.CPU

    def start_thread_id(self):
        return self._t


EVENTS = [
    Event(trace.SPAN, 0, 1000),
    Event("aten::mul", 10, 100),
    Event("cudaLaunchKernel", 20, 10),
    Event("aten::add", 300, 200),
    Event("aten::mul_", 320, 20),
    Event("other thread op", 600, 100, tid=2),
    Event("mdgan_adam_f32 adam_f32_kernel", 100, 100, device=True),
    Event("sample_normalize_kernel", 150, 100, device=True),
    Event("void cudnn::nchwToNhwcKernel", 400, 100, device=True),
    Event("Memset (Device)", 700, 50, device=True),
    Event("Stream Sync", 800, 100, device=True),
    Event(trace.SPAN, 0, 1000, device=True),
    Event("nccl:all_reduce", 900, 50),
    Event("nccl:all_reduce", 900, 50, device=True),
]


def test_summary_of_made_up_events():
    s = trace.summarize(EVENTS)
    assert s["window_ns"] == 1000 and s["launches"] == 4
    assert s["busy_ns"] == 150 + 100 + 50
    assert s["by_name"]["sample_normalize_kernel"] == [1, 100]
    # idle: [0,100) before aten::mul opens at 10 -> "no host op" until the
    # first op; [250,400) between ops, before aten::add; [500,700) and
    # [750,1000) after the last op
    assert sum(s["gaps"].values()) == 1000 - s["busy_ns"]
    assert s["gaps"]["before aten::add"] == 150
    assert trace.top({"a": 2e9, "b": 1e9}, n=1) == [["a", 2.0]]


def test_readers_on_made_up_events():
    cell = spec.cell("dcgan32_standalone")
    s = trace.summarize(EVENTS)
    got = {"rounds": 100, "window_s": 2.0,
           "ranks": [{"summary": s, "traced_rounds": 1}]}
    r = harness.Reading(cell, got)
    value = {m["name"]: spec.metric_reader(m["name"]).read(r) for m in cell.per_layer}
    assert value["wall_rounds_per_s"] == 50.0
    assert value["launches_per_round.device"] == 4
    assert value["layout_ms_per_round.device"] == 100 / 1e6
    adam_bytes = roofline.adam_bytes(cell.config["g_params"] + cell.config["d_params"], "float32")
    assert value["adam_roofline.device"] == 100 * adam_bytes / roofline.HBM_BYTES_PER_S / 100e-9
    flops = cell.mode.flops_per_round(cell.config, cell.traffic)
    busy_s = s["busy_ns"] / 1e9
    assert value["mfu.device"] == 100 * flops / busy_s / roofline.PEAK_FLOPS["bfloat16"]


@pytest.mark.parametrize("cell_name", ["dcgan32_mdgan_n8", "dcgan32_standalone"])
def test_device_metrics_on_made_up_events(cell_name):
    """Each cell's per-layer readers (the ``.device`` split read by the
    files of the names' first parts, ``mfu.device`` over busy time) and
    its end-to-end ``device_ms_per_round``."""
    cell = spec.cell(cell_name)
    s = trace.summarize(EVENTS)
    got = {"rounds": 100, "window_s": 2.0,
           "ranks": [{"summary": s, "traced_rounds": 2, "device_busy_ns": 3e6}]}
    r = harness.Reading(cell, got)
    value = {m["name"]: spec.metric_reader(m["name"]).read(r) for m in cell.per_layer}
    assert set(value) == {"wall_rounds_per_s", "mfu.device", "launches_per_round.device",
                          "adam_roofline.device", "sampling_roofline.device",
                          "layout_ms_per_round.device", "d_region_host_ms_per_round.device",
                          "g_region_host_ms_per_round.device", "host_us_per_launch.device"}
    assert value["wall_rounds_per_s"] == 50.0
    assert value["launches_per_round.device"] == 2
    flops = cell.mode.flops_per_round(cell.config, cell.traffic)
    busy_s = s["busy_ns"] / 1e9 / 2
    assert value["mfu.device"] == 100 * flops / busy_s / roofline.PEAK_FLOPS["bfloat16"]
    assert harness.e2e_value("device_ms_per_round", got) == 1.5
    assert [m["name"] for m in cell.end_to_end] == ["device_ms_per_round", "setup_s"]
