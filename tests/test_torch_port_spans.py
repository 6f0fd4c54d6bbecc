"""The port's phase spans (``mdgan_tpu_torch/obs/spans.py`` ``phase``): off
without a profiler, recorded under one, on the profiler's clock, and
without effect on the round's arithmetic.  CPU, small widths."""

import json
import statistics
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mdgan_tpu_torch.core.config import TrainConfig
from mdgan_tpu_torch.core.registry import get as get_spec
from mdgan_tpu_torch.data import builtin, sampler
from mdgan_tpu_torch.engine.mdgan import MDGANEngine
from mdgan_tpu_torch.engine.standalone import StandaloneEngine
from mdgan_tpu_torch.obs import spans

WIDTH, B, ROUNDS, EPOCHS, N = 8, 4, 2, 2, 2
# spans a 2-round chunk records, by engine (local_epochs 2)
COUNTS = {
    "mdgan": {"engine.chunk": 1, "engine.sample": 1, "engine.round": ROUNDS,
              "engine.generate": ROUNDS, "engine.d_step": ROUNDS * EPOCHS,
              "engine.feedback": ROUNDS, "engine.g_update": ROUNDS, "engine.metrics": 1,
              # DCGAN-32's discriminators run stacked: 2 forwards a local
              # epoch and 1 a feedback
              "engine.d_stacked": ROUNDS * (2 * EPOCHS + 1)},
    "standalone": {"engine.chunk": 1, "engine.sample": 1, "engine.round": ROUNDS,
                   "engine.generate": ROUNDS, "engine.d_step": ROUNDS * EPOCHS,
                   "engine.g_update": ROUNDS * EPOCHS, "engine.metrics": 1},
}


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


class Run:
    """An engine at small widths, its data and sampler, and fresh states."""

    def __init__(self, mode: str):
        cfg = TrainConfig(batch_size=B, local_epochs=EPOCHS, compute_dtype="float32",
                          device="cpu")
        kw = {"ngf": WIDTH, "ndf": WIDTH}
        data = builtin.synthesize((32, 32, 3), 48, seed=32)[0]
        if mode == "mdgan":
            self.eng = MDGANEngine(get_spec("Synthetic32"), cfg, N, model_kwargs=kw)
            self.data = self.eng.shard_data(data.reshape(N, -1, 32, 32, 3))
            self.workers = N
        else:
            self.eng = StandaloneEngine(get_spec("Synthetic32"), cfg, model_kwargs=kw)
            self.data = self.eng.put_data(data)
            self.workers = 1

    def chunk(self, st, seed: int = 0):
        smp = sampler.ShardSampler(self.workers, self.data.shape[1], B, seed=seed)
        return self.eng.run_rounds(st, self.data, smp, ROUNDS)


def profiled(fn):
    """``fn()`` under a profiler, after a span without one: the record then
    holds this run alone (two sessions with no span between them share
    one)."""
    with spans.phase("engine.idle"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.mark.parametrize("mode", ["mdgan", "standalone"])
def test_off_records_nothing_and_opens_no_range(mode, monkeypatch):
    calls = {"record_function": 0, "time_ns": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    import torch.autograd.profiler as profiler

    monkeypatch.setattr(profiler, "record_function",
                        counted("record_function", profiler.record_function))
    monkeypatch.setattr(spans, "time_ns", counted("time_ns", spans.time_ns))
    run = Run(mode)
    before = spans.records()
    run.chunk(run.eng.init_state(1))
    assert spans.records() == before
    assert calls == {"record_function": 0, "time_ns": 0}
    # the same counters see the chunk's spans when a profiler runs
    profiled(lambda: run.chunk(run.eng.init_state(1)))
    assert calls["record_function"] == len(spans.records()) > 0 and calls["time_ns"] > 0


@pytest.mark.parametrize("mode", ["mdgan", "standalone"])
def test_profiled_chunk_records_each_phase(mode):
    run = Run(mode)
    st = run.eng.init_state(1)
    profiled(lambda: run.chunk(st))
    recs = spans.records()
    got = spans.totals()
    assert {k: v[0] for k, v in got.items()} == COUNTS[mode]
    assert [r[2] for r in recs if r[0] == "engine.round"] == [0, 1]
    assert [r[2] for r in recs if r[0] == "engine.chunk"] == [0]
    for name, parent, _, tid, t0, t1 in recs:
        assert t0 <= t1
        if parent >= 0:
            p = recs[parent]
            assert p[4] <= t0 and t1 <= p[5] and p[3] == tid, name
        else:
            assert name == "engine.chunk"
    for count, total, self_ns in got.values():
        assert 0 <= self_ns <= total
    # the round's children: a chunk's rounds are inside it, its phases
    # inside the rounds
    names = [r[0] for r in recs]
    assert all(names[p] == "engine.round" for n, p, *_ in recs
               if n in ("engine.generate", "engine.d_step", "engine.feedback",
                        "engine.g_update"))


@pytest.mark.parametrize("mode", ["mdgan", "standalone"])
def test_records_match_profiler_events_on_its_clock(mode):
    run = Run(mode)
    st = run.eng.init_state(1)
    _, prof = profiled(lambda: run.chunk(st))
    recs = spans.records()
    names = {r[0] for r in recs}
    events = sorted((e for e in prof.profiler.kineto_results.events() if e.name() in names),
                    key=lambda e: e.start_ns())
    assert [e.name() for e in events] == [r[0] for r in recs]
    gaps = [abs(r[4] - e.start_ns()) for r, e in zip(recs, events)]
    assert statistics.median(gaps) < 50_000


@pytest.mark.parametrize("mode", ["mdgan", "standalone"])
def test_recording_changes_no_arithmetic(mode):
    run = Run(mode)
    off_st, on_st = run.eng.init_state(3), run.eng.init_state(3)
    off = run.chunk(off_st, seed=5)
    on, _ = profiled(lambda: run.chunk(on_st, seed=5))
    assert spans.totals()["engine.round"][0] == ROUNDS
    for key, v in off.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, on[key]), key
    for net in ("g", "d"):
        for arena in ("params", "stats", "mu", "nu"):
            assert torch.equal(getattr(getattr(off_st, net), arena),
                               getattr(getattr(on_st, net), arena)), (net, arena)


def test_profiled_run_after_an_unprofiled_one_starts_anew():
    run = Run("standalone")
    st = run.eng.init_state(1)
    profiled(lambda: run.chunk(st))
    first = spans.records()
    run.chunk(st)                       # no profiler: the record stays
    assert spans.records() == first
    profiled(lambda: run.chunk(st))
    recs = spans.records()
    assert [r[2] for r in recs if r[0] == "engine.chunk"] == [2 * ROUNDS]
    assert spans.totals()["engine.round"][0] == ROUNDS
    # consecutive profiled chunks add to one record
    profiled(lambda: (run.chunk(st), run.chunk(st)))
    assert [r[2] for r in spans.records() if r[0] == "engine.chunk"] == [3 * ROUNDS, 4 * ROUNDS]


def test_write_json_round_trips(tmp_path):
    run = Run("mdgan")
    st = run.eng.init_state(1)
    profiled(lambda: run.chunk(st))
    path = tmp_path / "spans.json"
    spans.write_json(path)
    got = json.loads(path.read_text())
    assert tuple(got["fields"]) == spans.FIELDS
    assert [tuple(r) for r in got["records"]] == spans.records()
    assert {k: tuple(v) for k, v in got["totals"].items()} == spans.totals()


def test_trainer_span_logger_opens_a_phase(tmp_path):
    tmpl = spans.server_row_template(0, 1.0, 1.0)
    logger = spans.SpanLogger(tmp_path / "s.csv", tmpl)
    logger.begin_row(tmpl)

    def swap():
        with logger.span("swap"):
            with spans.phase("engine.swap"):
                pass

    profiled(swap)
    row = logger.take_row()
    logger.close()
    assert row["start.swap"] <= row["end.swap"]
    recs = spans.records()
    assert [(r[0], r[1]) for r in recs] == [("trainer.swap", -1), ("engine.swap", 0)]


def test_threads_without_the_profiler_leave_the_record_whole():
    """A profiler runs on the thread that started it: spans opened at the
    same time on other threads record nothing and neither clear nor break
    that thread's record."""
    import sys

    threads, per = 4, 300
    start = threading.Barrier(threads + 1)

    def work():
        start.wait(timeout=30)
        for i in range(per):
            with spans.phase("engine.round", i):
                with spans.phase("engine.d_step"):
                    pass

    def chunks():
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        start.wait(timeout=30)
        for i in range(per):
            with spans.phase("engine.chunk", i):
                with spans.phase("engine.metrics"):
                    pass
        for t in pool:
            t.join(timeout=60)
        return pool

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool, _ = profiled(chunks)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in pool)
    recs = spans.records()
    assert {k: v[0] for k, v in spans.totals().items()} == {"engine.chunk": per,
                                                             "engine.metrics": per}
    assert len({r[3] for r in recs}) == 1
    np.testing.assert_array_equal([r[2] for r in recs if r[0] == "engine.chunk"],
                                  np.arange(per))
    assert all(recs[p][0] == "engine.chunk" for n, p, *_ in recs if n == "engine.metrics")
