"""The port's span recorder (utils/spans.TRACE): nothing recorded or
allocated while it is off; nesting, call ids across the engine's worker
thread, the host clock and the cap while it is on; the engine's records
unchanged by it, every span of the layer boundaries present and nested,
the probes' `timing=` splits taken from it, the H2D byte counters, and the
CLI's Chrome-trace export."""
import json
import os
import threading
import time
import tracemalloc
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from svscope_tpu_torch.engine import localgraph
from svscope_tpu_torch.engine.datamaker import WindowData
from svscope_tpu_torch.ops import poa_batch, poa_fused
from svscope_tpu_torch.utils import spans
from svscope_tpu_torch.utils.spans import NO_SPAN, TRACE, Recorder

torch.set_num_threads(1)

ENGINE_SPANS = {
    "localgraph.batch", "localgraph.stage_a", "localgraph.stage_a_wait",
    "localgraph.em_dispatch", "localgraph.complete", "localgraph.emit",
    "mixture.prep", "mixture.identity", "mixture.ward", "mixture.launch",
    "mixture.fetch", "poa.msa"}
ROUND_SPANS = {"poa.round.route", "poa.round.host_dp", "poa.chunk.pack",
               "poa.chunk.launch", "poa.chunk.wait", "poa.chunk.fuse",
               "poa.extract"}
FUSED_SPANS = {"fused.plan", "fused.arrays", "fused.enqueue", "fused.fetch",
               "fused.emit"}
NAME, T0, T1, THREAD, SID, PARENT, CALL, ATTRS = range(8)


def windows(n, seed, length=80, flank=20, reads=6, ins=20):
    """Small somatic windows: half the reads (tumor) carry an insertion,
    each read loses one base."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(n):
        ref = "".join(rng.choice(list("ACGT"), length + 2 * flank))
        mid = len(ref) // 2
        alt = ref[:mid] + "".join(rng.choice(list("ACGT"), ins)) + ref[mid:]
        seqs = [alt if i < reads // 2 else ref for i in range(reads)]
        seqs = [s[:p] + s[p + 1:]
                for s, p in zip(seqs, rng.integers(1, length, reads))]
        ids = [f"S_{'tumor' if i < reads // 2 else 'normal'}|w{w}r{i}"
               for i in range(reads)]
        start = 1000 * (w + 1)
        out.append(WindowData([ref] + seqs, np.array(ids), ref[:flank],
                              ref[-flank:], f"chr1\t{start}\t{start + length}",
                              "INS"))
    return out


@pytest.fixture
def trace_on():
    TRACE.clear()
    TRACE.enable()
    try:
        yield TRACE
    finally:
        TRACE.disable()
        TRACE.clear()


def covered(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def test_off_records_and_allocates_nothing():
    rec = Recorder()
    assert rec.span("a") is NO_SPAN and rec.call("b") is NO_SPAN
    assert rec.span("c", engine="x") is NO_SPAN
    fn = lambda: None
    assert rec.carry(fn) is fn

    def sites():
        for _ in range(20000):
            with rec.span("a"):
                with rec.span("b") as s:
                    s.set(k=1)
    sites()
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        sites()
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert after - before <= 0
    assert peak - before < 4096          # no per-site allocation
    assert rec.records() == [] and rec.dropped == 0


def test_nesting_calls_threads_and_clock():
    rec = Recorder()
    rec.enable()
    got = {}

    def worker():
        with rec.span("worker", chunk=1):
            got["thread"] = threading.get_ident()

    t_before = time.perf_counter_ns()
    with rec.call("outer") as outer:
        with rec.span("inner", a=1) as inner:
            inner.set(b=2)
        with ThreadPoolExecutor(1) as pool:
            pool.submit(rec.carry(worker)).result()
    with rec.call("outer"):
        pass
    t_after = time.perf_counter_ns()
    with rec.span("loose"):
        pass
    recs = {r[NAME]: r for r in rec.records()}
    first = [r for r in rec.records() if r[NAME] == "outer"]
    assert len(first) == 2 and first[0][CALL] != first[1][CALL]
    i, w, o = recs["inner"], recs["worker"], first[0]
    assert i[PARENT] == o[SID] == outer.sid and i[ATTRS] == {"a": 1, "b": 2}
    assert i[CALL] == o[CALL]
    assert w[CALL] == o[CALL] and w[PARENT] is None
    assert w[ATTRS] == {"chunk": 1} and w[THREAD] == got["thread"]
    assert w[THREAD] != threading.get_ident() == o[THREAD]
    assert recs["loose"][CALL] is None and recs["loose"][PARENT] is None
    for r in (o, i, w):
        assert t_before <= r[T0] <= r[T1] <= t_after
    assert o[T0] <= i[T0] <= i[T1] <= o[T1]


def test_timed_span_reads_the_clock_while_off():
    rec = Recorder()
    seen = []
    with rec.timed("t", sink=seen.append, k=3) as span:
        time.sleep(0.001)
    assert seen == [span] and span.seconds >= 0.001 and span.attrs == {"k": 3}
    assert rec.records() == []
    rec.enable()
    with rec.timed("t2"):
        pass
    assert [r[NAME] for r in rec.records()] == ["t2"]


def test_cap_counts_drops():
    rec = Recorder(cap=3)
    rec.enable()
    for _ in range(5):
        with rec.span("s"):
            pass
    assert len(rec.records()) == 3 and rec.dropped == 2
    rec.clear()
    assert rec.records() == [] and rec.dropped == 0
    assert spans.CAP == TRACE.cap >= 1_000_000


@pytest.mark.parametrize("device_poa", [True, "fused"])
def test_engine_spans(device_poa, trace_on, monkeypatch):
    """Records identical with the recorder off and on; every span of the
    engine's layer boundaries present, children inside their parents, the
    worker's stage-A spans carrying the call's id, and a device build's
    children covering >= 90 % of it."""
    monkeypatch.setattr(localgraph, "PIPELINE_CHUNK", 2)
    wins = windows(4, 7)
    TRACE.disable()
    off = localgraph.process_window_batch(wins, device="cpu",
                                          device_poa=device_poa)
    assert TRACE.records() == []
    TRACE.enable()
    poa_fused.reset_counts()
    on = localgraph.process_window_batch(wins, device="cpu",
                                         device_poa=device_poa)
    assert repr(on) == repr(off)
    assert all(r[-1].endswith("EMOutput") for r in on)
    recs = TRACE.records()
    names = Counter(r[NAME] for r in recs)
    want = ENGINE_SPANS | (ROUND_SPANS if device_poa is True
                           else FUSED_SPANS)
    assert want <= set(names), want - set(names)
    assert names["localgraph.batch"] == 1
    assert names["localgraph.stage_a"] == names["localgraph.stage_a_wait"] == 2
    by_id = {r[SID]: r for r in recs}
    batch = next(r for r in recs if r[NAME] == "localgraph.batch")
    for r in recs:
        assert r[CALL] == batch[CALL]
        assert batch[T0] <= r[T0] <= r[T1] <= batch[T1]
        if r[PARENT] is not None:
            p = by_id[r[PARENT]]
            assert p[THREAD] == r[THREAD]
            assert p[T0] <= r[T0] <= r[T1] <= p[T1]
    stage_a = [r for r in recs if r[NAME] == "localgraph.stage_a"]
    assert sorted(r[ATTRS]["chunk"] for r in stage_a) == [0, 1]
    assert all(r[THREAD] != batch[THREAD] and r[PARENT] is None
               for r in stage_a)
    engine = "pallas" if device_poa is True else "fused"
    builds = [r for r in recs if r[NAME] == "poa.msa"]
    assert builds and all(r[ATTRS] == {"engine": engine} for r in builds)
    if device_poa is True:
        for b in builds:
            kids = [(r[T0], r[T1]) for r in recs if r[PARENT] == b[SID]]
            assert covered(kids) >= 0.9 * (b[T1] - b[T0])
    else:
        emits = [r[ATTRS] for r in recs if r[NAME] == "fused.emit"]
        assert all(set(a) == {"windows"} for a in emits)
        assert sum(a["windows"] for a in emits) == \
            poa_fused.COUNTS["emit_windows"] > 0


def test_fused_fallback_span(trace_on):
    got = poa_batch.poa_msa_batch([["ACGTAC", "ACGRAC", "ACTAC"],
                                   ["ACGTAC", "ACGAC", "ACTAC"]],
                                  use_device="fused", device="cpu")
    assert got[0] == poa_batch.poa_msa_batch(
        [["ACGTAC", "ACGRAC", "ACTAC"]], device="cpu")[0]
    names = [r[NAME] for r in TRACE.records()]
    assert "fused.fallback" in names and "fused.emit" in names
    assert [r[ATTRS] for r in TRACE.records()
            if r[NAME] == "fused.emit"] == [{"windows": 1}]


def test_timing_splits_come_from_the_spans(trace_on):
    """poa_msa_batch(timing=) gives every ROUND_PARTS key with the
    recorder on, its host parts the sums of the spans they are made of;
    the fused build's timing= every phase, as spans `fused.phase`."""
    jobs = [w.sequences for w in windows(2, 3)]
    parts = {}
    got = poa_batch.poa_msa_batch(jobs, use_device=True, device="cpu",
                                  timing=parts)
    assert got == poa_batch.poa_msa_batch(jobs, device="cpu")
    assert set(parts) == set(poa_batch.ROUND_PARTS)
    recs = TRACE.records()
    total = lambda *names: sum(r[T1] - r[T0] for r in recs
                               if r[NAME] in names) / 1e9
    unpack = sum(r[ATTRS]["unpack"] for r in recs
                 if r[NAME] == "poa.chunk.fuse")
    assert parts["pack"] == pytest.approx(total(
        "poa.round.route", "poa.round.host_dp", "poa.chunk.pack"))
    assert parts["d2h"] == pytest.approx(total("poa.chunk.wait"))
    assert parts["unpack"] == pytest.approx(unpack)
    assert parts["fuse"] == pytest.approx(total("poa.chunk.fuse") - unpack)
    TRACE.clear()
    timing = {}
    poa_fused.fused_msa_batch(jobs, device="cpu", timing=timing)
    assert set(timing) == {"upload", "prep", "align", "fusion", "consensus",
                           "download"}
    phases = [r for r in TRACE.records() if r[NAME] == "fused.phase"]
    for k, v in timing.items():
        assert v == pytest.approx(sum(r[T1] - r[T0] for r in phases
                                      if r[ATTRS]["phase"] == k) / 1e9)


def test_h2d_bytes_count_the_chunk_buffers(monkeypatch):
    """poa_batch's h2d_bytes: every bucket chunk's six kernel inputs, whole
    (b_pad rows); poa_fused's: each build's reads and lengths as int32."""
    jobs = [w.sequences for w in windows(3, 5)]
    chunks = []
    orig = poa_batch._DeviceBuild.chunk

    def chunk(self, handles, idx, nb, lb, parts):
        chunks.append((len(handles), nb, lb))
        return orig(self, handles, idx, nb, lb, parts)
    monkeypatch.setattr(poa_batch._DeviceBuild, "chunk", chunk)
    poa_batch.reset_counts()
    poa_batch.poa_msa_batch(jobs, use_device=True, device="cpu")
    row = lambda nb, lb: (nb + nb * poa_batch.MAX_PREDS * 4 + nb + 4 + lb
                          + 4)
    want = sum((poa_batch._bucket(n, poa_batch.B_LADDER) or n) * row(nb, lb)
               for n, nb, lb in chunks)
    assert chunks and poa_batch.COUNTS["h2d_bytes"] == want
    builds = []
    orig_build = poa_fused.build_batch_pk

    def build(seqs, lens, n_seqs, **kw):
        builds.append(seqs.shape)
        return orig_build(seqs, lens, n_seqs, **kw)
    monkeypatch.setattr(poa_fused, "build_batch_pk", build)
    poa_fused.reset_counts()
    poa_fused.fused_msa_batch(jobs, device="cpu")
    assert builds and poa_fused.COUNTS["h2d_bytes"] == sum(
        b * r * (l + 1) * 4 for b, r, l in builds)


def test_cli_trace_spans_writes_a_chrome_trace(tmp_path):
    from svscope_tpu_torch import cli
    from torch_workloads import make_test_pair
    ref, tumor, normal, recs, _ = make_test_pair(str(tmp_path))
    bed = tmp_path / "w.bed"
    bed.write_text("".join(r + "\n" for r in recs))
    path = tmp_path / "spans.json"
    cli.main(["localGraph", "--device", "cpu", "-w", str(bed), "-T", tumor,
              "-N", normal, "-t", "S", "-n", "S", "-r", ref, "-s",
              str(tmp_path / "out"), "--trace-spans", str(path)])
    assert not TRACE.on
    doc = json.loads(path.read_text())
    TRACE.clear()
    events = doc["traceEvents"]
    spans_ = [e for e in events if e["ph"] == "X"]
    assert {"localgraph.batch", "localgraph.stage_a", "mixture.fetch",
            "poa.msa"} <= {e["name"] for e in spans_}
    assert all(e["dur"] >= 0 and e["ts"] >= 0 and e["pid"] == os.getpid()
               for e in spans_)
    counters = {e["name"]: e["args"] for e in events if e["ph"] == "C"}
    assert set(counters) == {"poa_batch", "poa_fused"}
    assert set(counters["poa_batch"]) == set(poa_batch.COUNTS)
    assert doc["baseTimeNanoseconds"] % 10 ** 9 == 0
