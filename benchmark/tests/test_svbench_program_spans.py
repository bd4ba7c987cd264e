"""The readers of the program's own spans and counters on a synthetic run:
spans on two threads, some outside the traced window (a warm-up call, a
span that ends past the last call), overlapping host parts for the union
in poa_host_idle_pct, the synthetic device trace of test_svbench_metrics;
and a harness run on the CPU whose result line carries them."""
import types

import pytest

from benchmark import devtrace, manifest
from benchmark.spans import Recorder
from benchmark.tests.test_svbench_metrics import ev, synthetic

NEW = ("stage_a_wait_ms_per_window", "em_fetch_ms_per_window",
       "round_host_ms_per_window", "fused_host_ms_per_window",
       "poa_host_idle_pct", "poa_h2d_kb_per_window")


@pytest.fixture(autouse=True)
def recorder_off():
    """Loading a span reader turns the program's recorder on: off again
    after each test."""
    yield
    from svscope_tpu_torch.utils.spans import TRACE
    TRACE.disable()
    TRACE.clear()


def rec(name, a_us, b_us, thread=1):
    return (name, a_us * 1000, b_us * 1000, thread, 0, None, 1, None)


# host us; the traced window's calls run 600-1400 us host (1100-1900 us
# trace), after a first call at 400-550 us that they leave out
RECORDS = [
    rec("localgraph.stage_a_wait", 410, 440),          # the first call's
    rec("localgraph.stage_a_wait", 600, 650),
    rec("localgraph.stage_a_wait", 1000, 1030),
    rec("mixture.fetch", 420, 500),
    rec("mixture.fetch", 700, 900),
    rec("mixture.fetch", 1100, 1150),
    rec("poa.round.route", 450, 500),                  # the first call's
    rec("poa.round.route", 600, 700, 1),
    rec("poa.chunk.fuse", 650, 800, 2),                # overlaps route
    rec("fused.emit", 900, 1000, 1),
    rec("poa.extract", 950, 1050, 2),                  # overlaps emit
    rec("poa.chunk.launch", 1050, 1200),               # not a host part
    rec("fused.plan", 1300, 1450),                     # ends past the calls
]


class FakeTrace:
    def __init__(self, records):
        self._records = records

    def records(self):
        return list(self._records)


def fake_run(**kw):
    run = types.SimpleNamespace(
        rec=Recorder(), windows=8, first=1, trace=synthetic(), trace_ok=True,
        cfg={"dp_kernels": ["poa_row_kernel"]},
        calls=[(0, 400_000, 550_000, ["r"] * 4),
               (1, 600_000, 1_000_000, ["r"] * 4),
               (0, 1_000_000, 1_400_000, ["r"] * 4)],
        counts={"poa_batch": {"chunks": 3, "h2d_bytes": 6000},
                "poa_fused": {"chunks": 1, "h2d_bytes": 2000}})
    vars(run).update(kw)
    return run


def reader(name, records=RECORDS):
    mod = manifest.metric_module(name)
    if hasattr(mod, "TRACE"):
        mod.TRACE = FakeTrace(records)
    return mod


def test_span_readers():
    run = fake_run()
    # 50 + 30 us over 8 windows; the first call's span left out
    assert reader("stage_a_wait_ms_per_window").read(run) == \
        pytest.approx(0.01)
    assert reader("em_fetch_ms_per_window").read(run) == \
        pytest.approx(0.25 / 8)
    # route 100 + fuse 150 + extract 100 us on two threads, summed
    assert reader("round_host_ms_per_window").read(run) == \
        pytest.approx(0.35 / 8)
    # fused.emit alone: fused.plan ends after the last call
    assert reader("fused_host_ms_per_window").read(run) == \
        pytest.approx(0.1 / 8)


def test_poa_host_idle_pct_takes_the_union_over_threads():
    """Host parts 600-800 us (two threads) = 1100-1300 trace, all busy;
    900-1050 (two threads) = 1400-1550, all idle: 150 us of the window's
    650 idle us; the launch and the span past the last call left out."""
    assert reader("poa_host_idle_pct").read(fake_run()) == \
        pytest.approx(100 * 150 / 650)
    # the same spans counted per span, not as a union, would read 250 us
    twice = RECORDS + [rec("poa.extract", 950, 1050, 3)]
    assert reader("poa_host_idle_pct", twice).read(fake_run()) == \
        pytest.approx(100 * 150 / 650)


def test_device_reader_refuses_an_incomplete_trace():
    assert reader("poa_host_idle_pct").read(fake_run(trace_ok=False)) is None
    assert reader("poa_host_idle_pct").read(fake_run(trace=None)) is None


def test_h2d_reader():
    assert reader("poa_h2d_kb_per_window").read(fake_run()) == \
        pytest.approx(1.0)
    # a program without the counter (the parent of the recorder's PR)
    old = fake_run(counts={"poa_batch": {"chunks": 3},
                           "poa_fused": {"chunks": 1}})
    assert reader("poa_h2d_kb_per_window").read(old) is None


def test_new_readers_find_nothing():
    """No windows: nothing, before the run's calls or counts are read; a
    program without the recorder, or no span of the reader's: nothing."""
    bare = types.SimpleNamespace(rec=Recorder(), windows=0, trace=None,
                                 trace_ok=False, cfg={})
    for name in NEW:
        assert reader(name).read(bare) is None
    for name in NEW[:5]:
        mod = manifest.metric_module(name)
        mod.TRACE = None
        assert mod.read(fake_run()) is None
        assert reader(name, []).read(fake_run()) is None


def test_loading_a_span_reader_turns_the_recorder_on():
    from svscope_tpu_torch.utils.spans import TRACE
    TRACE.disable()
    manifest.metric_module("em_fetch_ms_per_window")
    assert TRACE.on


class WholeTracer:
    """A tracer whose window holds both markers and one op."""

    def start(self):
        import time
        self.t0 = time.perf_counter_ns()

    def stop(self):
        import time
        t1 = time.perf_counter_ns()
        a, b = self.t0 / 1e3, t1 / 1e3
        return devtrace.Reduced(
            [ev("spin_kernel", a, 1), ev("spin_kernel", b, 1),
             ev("some_kernel", (a + b) / 2, (b - a) / 4)], [self.t0, t1])


def test_harness_result_carries_the_program_metrics():
    """A traced run of the default cell on the CPU (the host engine there,
    no pipelined chunks in TINY's 8 windows): the EM's fetch, the idle
    share of the POA host parts (none: 0 %) and the H2D bytes (none: 0)
    are read; the metrics listed for other cells are not."""
    from benchmark.tests.svbench_common import tiny_run
    res, _lines = tiny_run(trace=True, tracer=WholeTracer)
    m = res["metrics"]
    assert res["correct"]
    assert m["em_fetch_ms_per_window"]["value"] > 0
    assert m["poa_h2d_kb_per_window"]["value"] == 0
    assert "poa_host_idle_pct" not in m or \
        m["poa_host_idle_pct"]["value"] == 0
    assert "fused_host_ms_per_window" not in m
    assert "stage_a_wait_ms_per_window" not in m
