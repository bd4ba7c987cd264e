"""The C++ batch entries of the port's per-round device POA
(csrc/host/poa_engine.cpp: poa_stat_batch, poa_pack_batch,
poa_fuse_batch) against the per-window path they replace (NativePoaGraph
.pack plus the bucket fill, unpack_alignment_arrays plus a per-window
fuse), byte for byte, and device-mode poa_msa_batch on windows that change
route mid-build against the host engine and the JAX package."""
import ctypes as ct

import numpy as np
import pytest
import torch

from svscope_tpu.ops.poa_batch import poa_msa_batch as jax_poa_msa_batch
from svscope_tpu_torch.native.poa import NativePoaGraph, flatten_reads, lib
from svscope_tpu_torch.ops import poa_batch
from svscope_tpu_torch.ops.poa_device import (MAX_PREDS,
                                              align_batch_reference,
                                              to_torch_packed,
                                              unpack_alignment_arrays)

torch.set_num_threads(1)
BASES = list("ACGT")
GARBAGE = 0x5A


def _rand(rng, n):
    return "".join(rng.choice(BASES, n))


def _ptr(a, ctype):
    return a.ctypes.data_as(ct.POINTER(ctype))


def _handles(graphs):
    return np.array([g._h for g in graphs], np.uintp)


def _stat(graphs):
    n = len(graphs)
    nn, indeg = np.empty(n, np.int32), np.empty(n, np.int32)
    lib().poa_stat_batch(_ptr(_handles(graphs), ct.c_void_p), n,
                         _ptr(nn, ct.c_int32), _ptr(indeg, ct.c_int32))
    return nn, indeg


def _pack_batch(graphs, reads, nb, lb, b_pad, threads=2):
    """poa_pack_batch into buffers full of garbage: (rc, arrays)."""
    blob, seq_off, _ = flatten_reads([[r] for r in reads])
    idx = np.arange(len(reads), dtype=np.int64)
    out = {"chars": np.full((b_pad, nb), GARBAGE, np.uint8),
           "preds": np.full((b_pad, nb, MAX_PREDS), GARBAGE, np.int32),
           "sinks": np.full((b_pad, nb), GARBAGE, np.uint8),
           "nn": np.full(b_pad, GARBAGE, np.int32),
           "nor": np.full((b_pad, nb), GARBAGE, np.int32),
           "seqs": np.full((b_pad, lb), GARBAGE, np.uint8),
           "lens": np.full(b_pad, GARBAGE, np.int32)}
    u8, i32, i64 = ct.c_uint8, ct.c_int32, ct.c_int64
    rc = lib().poa_pack_batch(
        _ptr(_handles(graphs), ct.c_void_p), len(graphs), b_pad, nb,
        MAX_PREDS, lb, blob, _ptr(seq_off, i64), _ptr(idx, i64),
        _ptr(out["chars"], u8), _ptr(out["preds"], i32),
        _ptr(out["sinks"], u8), _ptr(out["nn"], i32), _ptr(out["nor"], i32),
        _ptr(out["seqs"], u8), _ptr(out["lens"], i32), threads)
    return rc, out


def _window_fill(graphs, reads, nb, lb, b_pad):
    """The per-window path: NativePoaGraph.pack per window, then the bucket
    fill the device rounds made before the batch entries (padding rows
    repeat row 0)."""
    chars = np.zeros((b_pad, nb), np.uint8)
    preds = np.full((b_pad, nb, MAX_PREDS), -1, np.int32)
    sinks = np.zeros((b_pad, nb), bool)
    nn = np.zeros(b_pad, np.int32)
    nor = np.full((b_pad, nb), -1, np.int32)
    seqs = np.zeros((b_pad, lb), np.uint8)
    lens = np.zeros(b_pad, np.int32)
    for bi, (g, seq) in enumerate(zip(graphs, reads)):
        c, p, s, n, o = g.pack(nb, MAX_PREDS)
        chars[bi], preds[bi], sinks[bi], nn[bi], nor[bi] = c, p, s, n, o
        seqs[bi, :len(seq)] = np.frombuffer(seq.encode(), np.uint8)
        lens[bi] = len(seq)
    k = len(graphs)
    for a in (chars, preds, sinks, nn, nor, seqs, lens):
        a[k:] = a[0]
    return {"chars": chars, "preds": preds, "sinks": sinks.astype(np.uint8),
            "nn": nn, "nor": nor, "seqs": seqs, "lens": lens}


def _edge_graph(rng, n_total, indeg):
    """A graph of n_total nodes whose first node has in-degree `indeg`: a
    chain, then `indeg` one-base reads fused as a new node ahead of it."""
    g = NativePoaGraph()
    chain = _rand(rng, n_total - indeg)
    g.add_sequence(chain)
    for _ in range(indeg):
        g.fuse([(-1, 0), (0, 1)], _rand(rng, 1) + chain[0])
    assert g.n_nodes() == n_total and g.max_indegree() == indeg
    return g


def _small_graph(rng, n_reads=3, length=40):
    g = NativePoaGraph()
    ref = _rand(rng, length)
    for r in range(n_reads):
        b = list(ref)
        b[int(rng.integers(len(b)))] = str(rng.choice(BASES))
        g.add_sequence("".join(b) if r else ref)
    return g


@pytest.mark.parametrize("indeg", [8, 9])
@pytest.mark.parametrize("n_total", [128, 129, 512, 513])
def test_pack_batch_equals_window_pack(n_total, indeg):
    """poa_pack_batch writes every byte of a chunk as NativePoaGraph.pack
    and the bucket fill did, padding rows included; poa_stat_batch gives
    the node counts and in-degrees that route a window, and a window past
    8 in-slots (which stat sends to the host) fails the pack."""
    rng = np.random.default_rng(n_total * 10 + indeg)
    graphs = [_small_graph(rng), _edge_graph(rng, n_total, indeg),
              _small_graph(rng, 4, 60)]
    reads = [_rand(rng, 40), _rand(rng, 64), ""]
    nb = poa_batch._bucket(n_total, poa_batch.N_LADDER)
    lb, b_pad = 64, 8
    nn, deg = _stat(graphs)
    assert nn.tolist() == [g.n_nodes() for g in graphs]
    assert deg.tolist() == [g.max_indegree() for g in graphs]
    if indeg > MAX_PREDS:
        assert graphs[1].pack(nb, MAX_PREDS) is None
        rc, _ = _pack_batch(graphs, reads, nb, lb, b_pad)
        assert rc == 2
        graphs, reads = graphs[::2], reads[::2]
    rc, got = _pack_batch(graphs, reads, nb, lb, b_pad)
    assert rc == 0
    want = _window_fill(graphs, reads, nb, lb, b_pad)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pack_batch_rejects_a_long_read():
    rng = np.random.default_rng(1)
    graphs = [_small_graph(rng), _small_graph(rng)]
    rc, _ = _pack_batch(graphs, [_rand(rng, 10), _rand(rng, 65)], 128, 64, 8)
    assert rc == 2


def _fuse_windows(seed=5, n=10):
    rng = np.random.default_rng(seed)
    out = []
    for w in range(n):
        ref = _rand(rng, 30 + 3 * w)
        rows = [ref]
        for r in range(6):
            b = list(ref if r % 2 else ref[:10] + "GATTA" + ref[10:])
            b[int(rng.integers(1, len(b) - 1))] = str(rng.choice(BASES))
            if r == 3:
                del b[5:8]
            rows.append("".join(b))
        out.append(rows)
    return out


@pytest.mark.parametrize("threads", [1, 2, 8])
def test_fuse_batch_equals_window_fuse(threads):
    """poa_fuse_batch on plain K1's outputs gives the graphs, MSAs and
    consensus that per-window unpack_alignment_arrays + fuse give."""
    wins = _fuse_windows()
    batch = [NativePoaGraph() for _ in wins]
    single = [NativePoaGraph() for _ in wins]
    for g, h, seqs in zip(batch, single, wins):
        g.add_sequence(seqs[0])
        h.add_sequence(seqs[0])
    nb, lb = 128, 64
    for r in range(1, len(wins[0])):
        reads = [seqs[r] for seqs in wins]
        b_pad = poa_batch._bucket(len(wins), poa_batch.B_LADDER)
        rc, p = _pack_batch(batch, reads, nb, lb, b_pad, threads)
        assert rc == 0
        an, asp, ke, _ = (t.numpy() for t in align_batch_reference(
            *to_torch_packed(p["chars"], p["preds"], p["sinks"], p["nn"],
                             p["seqs"], p["lens"], "cpu"), lb))
        blob, seq_off, _ = flatten_reads([[s] for s in reads])
        idx = np.arange(len(reads), dtype=np.int64)
        secs = np.full(2, -1.0)
        i32, i64 = ct.c_int32, ct.c_int64
        an, asp, ke = (np.ascontiguousarray(a, np.int32)
                       for a in (an, asp, ke))
        rc = lib().poa_fuse_batch(
            _ptr(_handles(batch), ct.c_void_p), len(batch), _ptr(an, i32),
            _ptr(asp, i32), an.shape[1], _ptr(ke, i32), _ptr(p["nor"], i32),
            nb, blob, _ptr(seq_off, i64), _ptr(idx, i64), threads,
            _ptr(secs, ct.c_double))
        assert rc == 0 and (secs >= 0).all()
        for bi, (h, seq) in enumerate(zip(single, reads)):
            nor = h.pack(nb, MAX_PREDS)[4]
            nodes, spos = unpack_alignment_arrays(an[bi], asp[bi], ke[bi],
                                                  nor)
            h.fuse(list(zip(nodes.tolist(), spos.tolist())), seq)
        assert [g.n_nodes() for g in batch] == [h.n_nodes() for h in single]
    assert [(g.consensus(), g.msa()) for g in batch] == \
        [(h.consensus(), h.msa()) for h in single]


def test_fuse_batch_rejects_a_rank_past_the_bucket():
    rng = np.random.default_rng(2)
    g = _small_graph(rng)
    an = np.array([[-2, 0, 200]], np.int32)
    asp = np.array([[-2, 0, 1]], np.int32)
    ke = np.array([0], np.int32)
    nor = np.arange(128, dtype=np.int32)[None]
    blob, seq_off, _ = flatten_reads([["AC"]])
    idx = np.zeros(1, np.int64)
    secs = np.zeros(2)
    n_before = g.n_nodes()
    rc = lib().poa_fuse_batch(
        _ptr(_handles([g]), ct.c_void_p), 1, _ptr(an, ct.c_int32),
        _ptr(asp, ct.c_int32), 3, _ptr(ke, ct.c_int32),
        _ptr(nor, ct.c_int32), 128, blob, _ptr(seq_off, ct.c_int64),
        _ptr(idx, ct.c_int64), 2, _ptr(secs, ct.c_double))
    assert rc == 1 and g.n_nodes() == n_before


def _route_windows(seed=7):
    """Windows whose routes change within one build: window 0 gains a node
    of in-degree 9 (deletions of 1..12 bases before a shared suffix) and
    turns host-only mid-build; window 1's reads fall in a second length
    bucket; windows 2-3 hold empty reads (one first); window 4 has no
    reads; window 5 one read; window 6 fewer reads than the others."""
    rng = np.random.default_rng(seed)
    x, y = _rand(rng, 30), _rand(rng, 20)
    indeg = [x + y] + [x[:-j] + y for j in range(1, 13)] + [x + y, x[:-3] + y]
    long_ref = _rand(rng, 100)
    longer = [long_ref] + [long_ref[:40] + _rand(rng, 1) + long_ref[41:]
                           for _ in range(11)]
    mid = _rand(rng, 45)
    return [indeg, longer,
            [mid, "", mid[:20] + "T" + mid[21:], "", mid, mid[1:]] * 2,
            ["", mid, mid[2:], ""],
            [],
            [mid],
            [mid, mid[:30]]]


def test_route_windows_change_route_mid_build():
    """The windows of the next test do what it names: window 0 passes 8
    in-slots before its last read, and one round holds two buckets.  The
    in-degree the engine keeps as its graph grows (poa_stat_batch's)
    equals the JAX package's engine's scan after every read."""
    from svscope_tpu.native.poa import NativePoaGraph as JaxGraph
    wins = _route_windows()
    g, jg = NativePoaGraph(), JaxGraph()
    turned = None
    for r, seq in enumerate(wins[0]):
        if turned is None and g.n_nodes() and g.max_indegree() > MAX_PREDS:
            turned = r
        g.add_sequence(seq)
        jg.add_sequence(seq)
        assert g.max_indegree() == jg.max_indegree()
        assert _stat([g])[1][0] == jg.max_indegree()
    assert turned is not None and turned < len(wins[0]) - 1
    assert poa_batch._bucket(len(wins[1][1]), poa_batch.L_LADDER) != \
        poa_batch._bucket(len(wins[2][2]), poa_batch.L_LADDER)


def test_device_mode_routes_equal_host_and_jax():
    """Device-mode poa_msa_batch (plain K1 on the CPU) == the host engine
    == the JAX package on windows that turn host-only mid-build, two
    buckets a round and empty reads; no window is packed or fused one at
    a time, and the batch entries ran."""
    wins = _route_windows()
    poa_batch.reset_counts()
    got = poa_batch.poa_msa_batch(wins, use_device=True, device="cpu",
                                  threads=3)
    counts = dict(poa_batch.COUNTS)
    assert counts["window_packs"] == counts["window_fuses"] == 0
    assert counts["chunks"] > 0
    want = poa_batch.poa_msa_batch(wins, use_device=False, device="cpu")
    assert got == want
    assert want == jax_poa_msa_batch(wins, use_device=False)


def test_device_builds_from_many_threads():
    """Device builds in more Python threads than cores share the engine's
    one thread pool and poa_batch.COUNTS: every build gives the host
    engine's MSAs, no count is lost, and every thread ends in time."""
    import sys
    import threading
    wins = _fuse_windows(seed=9, n=2)
    wins = [w[:3] for w in wins]
    want = poa_batch.poa_msa_batch(wins, use_device=False, device="cpu")
    n_threads, builds = 12, 2
    bad = []

    def work(k):
        for _ in range(builds):
            got = poa_batch.poa_msa_batch(wins, use_device=True,
                                          device="cpu", threads=1 + k % 4)
            if got != want:
                bad.append(k)

    interval = sys.getswitchinterval()
    poa_batch.reset_counts()
    try:
        sys.setswitchinterval(1e-6)
        pool = [threading.Thread(target=work, args=(k,))
                for k in range(n_threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    assert bad == []
    # each build: reads 1 and 2 of both windows, one chunk a round
    assert poa_batch.COUNTS["chunks"] == n_threads * builds * 2
