"""The C++ engine's emit of a fetched fused-build chunk
(native/poa.pk_emit_batch) against ops/poa_fused.emit_window, its plain
NumPy version, window by window on states the plain kernels build on the
CPU; and fused_msa_batch's emit path: the entry alone, its counter and its
span attribute."""
import random

import numpy as np
import pytest
import torch

from svscope_tpu_torch.native.poa import pk_emit_batch
from svscope_tpu_torch.ops import poa_fused as tpf
from svscope_tpu_torch.utils.spans import TRACE

from test_poa_fused_kernel import window
from test_torch_pk_msa import EDGE_WINDOWS, host

torch.set_num_threads(1)
NAME, ATTRS = 0, 7


def unrelated(rng, n, length):
    """n unrelated reads: the graph outgrows a 128-node bucket (the
    overflow flag)."""
    return ["".join(rng.choice("ACGT") for _ in range(length))
            for _ in range(n)]


def build(windows, r_max, l_max, ncap):
    """One chunk of `windows` built on the CPU, padded to r_max read rows:
    (fetched state, n_seqs)."""
    encoded = {i: [tpf.CODE_OF[np.frombuffer(s.encode(), np.uint8)]
                   for s in seqs] for i, seqs in enumerate(windows)}
    seqs, lens, n_seqs = tpf.chunk_arrays(range(len(windows)), encoded,
                                          r_max, l_max)
    return tpf.build_batch_pk(seqs, lens, n_seqs, ncap=ncap,
                              device="cpu"), n_seqs


def split_consensus(state, w):
    """Move the second half of window w's consensus from back_buf to
    fwd_buf (the layout of a walk that starts mid-graph), which leaves
    its consensus as it was: the built states end their walk at a sink."""
    ncap = state["back_buf"].shape[1]
    b0 = int(state["back_start"][w])
    k = (ncap - b0) // 2
    if k:
        state["fwd_buf"][w, :k] = state["back_buf"][w, ncap - k:]
        state["back_buf"][w, b0 + k:] = state["back_buf"][w, b0:ncap - k]
        state["back_start"][w] = b0 + k
        state["fwd_cnt"][w] = k


def random_windows(seed, n):
    rng = random.Random(seed)
    return [window(rng, rng.randint(2, 7), rng.randint(8, 40),
                   rng.choice([0.02, 0.1, 0.25])) for _ in range(n)]


CASES = {
    # EDGE_WINDOWS holds a window with no reads and one of empty reads
    # (nn == 0) and windows with empty reads among others
    "edge": lambda: EDGE_WINDOWS + [["ACGTACGTAA", "", "ACGTTACGT", ""]],
    "random": lambda: random_windows(20261018, 10),
    "overflow": lambda: random_windows(7, 3)[:2]
    + [unrelated(random.Random(3), 40, 60)] + random_windows(8, 2),
}


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_entry_equals_emit_window(case, threads):
    """Every window's (consensus, rows) from the entry == emit_window's,
    on 64 padded read rows, the paths in the fetch's read-major layout and
    C-contiguous, every other window's consensus split over both walk
    buffers; skipped windows (the overflow flag, and one window more
    whose state is then spoiled) read as None and are never touched."""
    windows = CASES[case]()
    state, n_seqs = build(windows, 64, 64, 129)
    for w in range(0, len(windows), 2):
        split_consensus(state, w)
    skip = state["overflow"].copy()
    assert skip.any() == (case == "overflow")
    skip[1] = True
    for k in ("order", "back_buf", "fwd_buf", "path"):
        state[k][1] = -7
    assert not state["path"].flags.c_contiguous
    got = pk_emit_batch(state, n_seqs, skip, threads)
    assert got == pk_emit_batch(
        dict(state, path=np.ascontiguousarray(state["path"])), n_seqs, skip,
        threads)
    assert len(got) == len(windows)
    assert (state["nn"] == 0).any() == (case == "edge")
    for w, seqs in enumerate(windows):
        if skip[w]:
            assert got[w] is None
            continue
        want = tpf.emit_window(*(state[k][w] for k in (
            "ch", "gm", "nn", "path", "order", "back_buf", "back_start",
            "fwd_buf", "fwd_cnt")), len(seqs))
        assert got[w] == want, w
        assert [r.replace("-", "") for r in got[w][1]] == seqs


def test_entry_refuses_a_node_outside_the_state():
    windows = random_windows(11, 3)
    state, n_seqs = build(windows, 8, 64, 129)
    state["path"][2, 0, 0] = 129
    with pytest.raises(RuntimeError, match="window 2"):
        pk_emit_batch(state, n_seqs, np.zeros(3, bool))


def test_fused_msa_batch_emits_through_the_entry_alone(monkeypatch):
    """With emit_window raising, fused_msa_batch still equals the host
    engine; COUNTS["emit_windows"] and the `fused.emit` spans' `windows`
    count the non-overflow windows."""
    def refuse(*_a, **_k):
        raise AssertionError("emit_window on fused_msa_batch's path")
    monkeypatch.setattr(tpf, "emit_window", refuse)
    rng = random.Random(20260821)
    windows = EDGE_WINDOWS + [unrelated(rng, 40, 60)] + [
        window(rng, rng.randint(3, 6), rng.randint(12, 40),
               rng.choice([0.02, 0.1, 0.25])) for _ in range(12)]
    tpf.reset_counts()
    TRACE.clear()
    TRACE.enable()
    try:
        got = tpf.fused_msa_batch(windows, device="cpu")
        emits = [r for r in TRACE.records() if r[NAME] == "fused.emit"]
    finally:
        TRACE.disable()
        TRACE.clear()
    assert got == host(windows)
    assert tpf.COUNTS["fallbacks"] == 1
    assert tpf.COUNTS["emit_windows"] == tpf.COUNTS["windows"] - 1 > 12
    assert emits and all(set(r[ATTRS]) == {"windows"} for r in emits)
    assert sum(r[ATTRS]["windows"] for r in emits) == \
        tpf.COUNTS["emit_windows"]
