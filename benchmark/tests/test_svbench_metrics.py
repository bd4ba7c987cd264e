"""The metric arithmetic: the device trace's reduction on a synthetic
trace, the readers on a synthetic run, and the DP work counted from the
MSA against the DP entry's own inputs."""
import types

import numpy as np
import pytest

from benchmark import devtrace, manifest, peaks
from benchmark.spans import Recorder


def ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def synthetic():
    """Markers at 1000 and 2000 us (host marks at 500 and 1500 us): the
    window is 1000 us; K1 runs 1100-1300 and 1250-1400 (overlap), a copy
    1600-1650, an op before the window is dropped."""
    events = [ev("spin_kernel", 1000, 1), ev("spin_kernel", 2000, 1),
              ev("void poa_row::poa_row_kernel<int>(int*)", 1100, 200),
              ev("void poa_row::poa_row_kernel<int>(int*)", 1250, 150),
              ev("Memcpy HtoD", 1600, 50, "gpu_memcpy"),
              ev("early", 900, 50),
              {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1700,
               "dur": 100}]
    return devtrace.Reduced(events, [500_000, 1_500_000])


def test_trace_reduction():
    r = synthetic()
    assert r.window_s == pytest.approx(1e-3)
    assert r.busy_s() == pytest.approx(350e-6)
    assert r.time_of(["poa_row_kernel"]) == pytest.approx(350e-6)
    assert r.top_ops()[0] == ["void poa_row::poa_row_kernel<int>",
                              pytest.approx(350e-6)]
    # host span "_stage_a" open 450-1100 us host = 950-1600 trace, and
    # inside it "poa_msa_batch" 480-650 = 980-1150
    spans = {"_stage_a": [(450_000, 1_100_000, 1)],
             "poa_msa_batch": [(480_000, 650_000, 1)]}
    idle = dict(map(tuple, r.idle_by_span(spans)))
    # idle 1000-1100 (poa_msa_batch open), 1400-1600 (_stage_a), 1650-2000
    # (none): each instant goes to the innermost span open then
    assert idle["poa_msa_batch"] == pytest.approx(100e-6)
    assert idle["_stage_a"] == pytest.approx(200e-6)
    assert idle["outside spans"] == pytest.approx(350e-6)
    assert sum(idle.values()) == pytest.approx(1e-3 - 350e-6)


def test_idle_goes_to_the_span_open_while_it_lasts():
    """A gap that begins inside a span and outlasts it is split at the
    span's end, not given whole to the span it began in."""
    r = synthetic()
    # "fetch" open 800-950 us host = 1300-1450 trace: it holds only the
    # idle 1400-1450 of the gap 1400-1600; "emit" 960-1080 = 1460-1580
    spans = {"fetch": [(800_000, 950_000, 1)],
             "emit": [(960_000, 1_080_000, 1)],
             "call": [(500_000, 1_500_000, 0)]}
    idle = dict(map(tuple, r.idle_by_span(spans)))
    assert idle["fetch"] == pytest.approx(50e-6)
    assert idle["emit"] == pytest.approx(120e-6)
    assert idle["call"] == pytest.approx(1e-3 - 350e-6 - 170e-6)
    assert "outside spans" not in idle


def test_late_opening_marker_moves_nothing():
    """The profiler's start-up can delay the first marker kernel: the
    window and the labels follow the closing marker."""
    events = [ev("spin_kernel", 1080, 1), ev("spin_kernel", 2000, 1),
              ev("k", 1100, 200)]
    r = devtrace.Reduced(events, [500_000, 1_500_000])
    assert r.t0 == pytest.approx(1000) and r.window_s == pytest.approx(1e-3)
    assert r.start_lag_us == pytest.approx(80)
    assert r.busy_s() == pytest.approx(200e-6)


def fake_run():
    rec = Recorder()
    rec.spans["_stage_a"] = [(0, 2_000_000, 1), (0, 1_000_000, 2)]
    rec.spans["em_cluster_batch_dispatch"] = [(0, 500_000, 1)]
    rec.spans["poa_msa_batch"] = [(0, 3_000_000, 1)]
    # 500-1000 and 1000-1500 us host = 1000-1500 and 1500-2000 trace
    rec.spans["fused_msa_batch"] = [(500_000, 1_000_000, 1),
                                    (1_000_000, 1_500_000, 2)]
    seqs = ["ACGTACGT", "ACGAACGT"]
    rows = ["ACGTACGT", "ACGAACGT"]
    rec.io["poa_msa_batch"] = [(([seqs],), {}, [("ACGTACGT", rows)])]
    return types.SimpleNamespace(
        rec=rec, windows=10, trace=synthetic(), trace_ok=True,
        cfg={"dp_kernels": ["poa_row_kernel"]})


def test_readers():
    run = fake_run()
    read = lambda n: manifest.metric_module(n).read(run)
    assert read("stage_a_ms_per_window") == pytest.approx(0.3)
    assert read("em_dispatch_ms_per_window") == pytest.approx(0.05)
    assert read("poa_msa_ms_per_window") == pytest.approx(0.3)
    # busy 1100-1400 in the first span, 1600-1650 in the second
    assert read("fused_host_work_pct") == pytest.approx(65.0)
    assert read("device_idle_pct") == pytest.approx(65.0)
    # the second sequence against the first's 8 nodes and 7 edges
    ops = 8 * 8 * 8 + 3 * 7 * 8
    bound = peaks.bound_s(2 * 8 + 4 * 7 + 8 + 8 * 16, ops)
    assert read("poa_dp_roofline") == pytest.approx(100 * bound / 350e-6)


def test_readers_find_nothing():
    """A reader with nothing to read returns None, never 0."""
    run = types.SimpleNamespace(rec=Recorder(), windows=0, trace=None,
                                trace_ok=False, cfg={"dp_kernels": ["x"]})
    for m in manifest.load_manifest()["per_layer"]:
        assert manifest.metric_module(m["name"]).read(run) is None


def test_device_readers_refuse_an_incomplete_trace():
    """Where the trace holds fewer of the program's kernels than it
    launched, no metric is read off the trace."""
    run = fake_run()
    run.trace_ok = False
    for name in ("device_idle_pct", "poa_dp_roofline", "fused_host_work_pct"):
        assert manifest.metric_module(name).read(run) is None


def test_trace_counts_against_launch_counters():
    """check_trace compares each group's kernels in the trace with the
    launches its counters took; an unnamed kernel counts in the group
    that names "unnamed kernel"."""
    from benchmark import harness
    run = fake_run()
    run.trace = devtrace.Reduced(
        [ev("spin_kernel", 1000, 1), ev("spin_kernel", 2000, 1),
         ev("void poa_row::poa_row_kernel<int>(int*)", 1100, 200),
         ev("", 1300, 10), ev("pk_prep_kernel(PrepArgs)", 1400, 10),
         ev("Memcpy HtoD", 1600, 50, "gpu_memcpy")],
        [500_000, 1_500_000])
    run.cfg = {"trace_counts": [
        {"trace": ["poa_row_kernel"], "counters": ["c:A"]},
        {"trace": ["pk_prep_kernel", "unnamed kernel"],
         "counters": ["c:B.x", "c:B.y"]}]}
    counters = {"c:A": [3, 4], "c:B.x": [0, 1], "c:B.y": [5, 6]}
    step = [0]
    orig = harness.read_counter
    harness.read_counter = lambda ref: counters[ref][step[0]]
    try:
        before = harness.launches(run.cfg)
        step[0] = 1
        assert harness.check_trace(run, before, lambda s: None)
        counters["c:A"][1] = 5
        assert not harness.check_trace(run, before, lambda s: None)
    finally:
        harness.read_counter = orig


def test_busy_within_spans():
    r = synthetic()
    # host 600-900 us = trace 1100-1400: all busy; 1000-1150 trace
    # (host 500-650): 1100-1150 busy
    assert r.busy_within([(600_000, 900_000)]) == pytest.approx(300e-6)
    assert r.busy_within([(500_000, 650_000), (600_000, 900_000)]) == \
        pytest.approx(350e-6)


def test_dp_work_equals_the_dp_entry_inputs():
    """The useful work read off the MSAs equals bounds.poa_ops over the
    real rows of every K1 call of the per-round device path (its plain
    version on the CPU): padding rows, which repeat row 0, excluded."""
    from svscope_tpu_torch.ops import poa_align, poa_batch
    from svscope_tpu_torch.tools import bounds
    from benchmark import generator
    from benchmark.tests.svbench_common import TINY
    p = dict(TINY, windows_per_call=6,
             edits={"rate": 0.03, "ops": {"sub": 1, "ins": 1, "del": 1}})
    seq_lists = [w.sequences for w in generator.make_batch(p, 123, 0)]
    got, real = [0], [0]
    orig_align, orig_chunk = poa_align.align_batch, poa_batch._DeviceBuild.chunk

    def align(chars, preds, sinks, nn, seqs, lens, *a, **k):
        n = real[0]
        got[0] += bounds.poa_ops(preds[:n], nn[:n], lens[:n])
        return orig_align(chars, preds, sinks, nn, seqs, lens, *a, **k)

    def chunk(self, handles, *a):
        real[0] = len(handles)
        return orig_chunk(self, handles, *a)
    try:
        poa_align.align_batch = align
        poa_batch._DeviceBuild.chunk = chunk
        res = poa_batch.poa_msa_batch(seq_lists, use_device="pallas",
                                      device="cpu")
    finally:
        poa_align.align_batch = orig_align
        poa_batch._DeviceBuild.chunk = orig_chunk
    assert got[0] > 0
    assert peaks.dp_work([(seq_lists, res)])[0] == got[0]


def test_trace_without_both_markers_is_incomplete():
    """CUPTI that lost the window's records (no closing marker, or no op
    between the markers) gives an incomplete trace, whose busy time is
    not a reading."""
    assert synthetic().complete
    lost_end = [ev("spin_kernel", 1000, 1), ev("poa_row_kernel", 1100, 5)]
    assert not devtrace.Reduced(lost_end, [500_000, 1_500_000]).complete
    assert not devtrace.Reduced([], [500_000, 1_500_000]).complete
    empty = [ev("spin_kernel", 1000, 1), ev("spin_kernel", 2000, 1)]
    assert not devtrace.Reduced(empty, [500_000, 1_500_000]).complete


class FakeTracer:
    """A tracer whose first window loses every record, as CUPTI did on one
    run on the card; later windows see one op between the markers."""
    made: list = []

    def __init__(self):
        FakeTracer.made.append(self)

    def start(self):
        import time
        self.t0 = time.perf_counter_ns()

    def stop(self):
        import time
        t1 = time.perf_counter_ns()
        if len(FakeTracer.made) == 1:
            return devtrace.Reduced([], [self.t0, t1])
        a, b = self.t0 / 1e3, t1 / 1e3
        events = [ev("spin_kernel", a, 1), ev("spin_kernel", b, 1),
                  ev("some_kernel", (a + b) / 2, (b - a) / 4)]
        return devtrace.Reduced(events, [self.t0, t1])


def test_incomplete_trace_traces_a_second_window():
    """The harness traces a second window when the first trace is
    incomplete: the device readings and the span metrics come from it
    alone, and every call of both windows is judged."""
    from benchmark.tests.svbench_common import tiny_run
    FakeTracer.made = []
    logged = []
    res, _lines = tiny_run(trace=True, tracer=FakeTracer,
                           log=logged.append)
    assert len(FakeTracer.made) == 2
    assert any(s.startswith("trace incomplete") for s in logged)
    assert res["correct"]
    assert res["device"]["busy_s"] > 0
    assert res["device"]["busy_s"] <= res["device"]["window_s"]
    calls = [s for s in logged if s.startswith("call ")]
    assert len(calls) >= 2
    assert res["attempted"] == 8 * len(calls)
    assert "device_idle_pct" in res["metrics"]
