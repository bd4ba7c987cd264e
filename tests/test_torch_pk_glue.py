"""K6 and K7 of the fused `pk` build on the CPU: the model of each kernel's
per-window loop (tests/torch_glue_model.py) against the JAX package's
`_toposort`, `_toposort_ref`, `_pk_round_prep` (its operands without the
TPU chain flags and packing) and `_consensus_walk`, and against the port's
batched plain versions (ops/poa_fused.toposort_reference,
pk_round_prep_reference, consensus_walk_reference), on the same seeded
states: chip_smoke.glue_edge_case's thirteen windows (an empty graph,
one node, 8 full in-slots, cyclic states, an empty read, ncap - 1 nodes, a
head with over 32 blockers, duplicate edges, a run of over 32 columns over
holes, one long chain, weights past 2^10) at ncap 129, 1025 and 3073, and
real rounds of the port's own build.  Every output is an integer: exact
equality (against JAX's _consensus_walk only within JAX's stated key
range: its int32 keys wrap past weights of 2^10).  The kernels themselves
run only on the card (tests/test_torch_cuda.py, chip_smoke.py's pk-glue
phase)."""
import functools
import random

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import torch_glue_model as model
from svscope_tpu.ops import poa_fused as jpf
from svscope_tpu_torch.ops import poa_fused as tpf
from svscope_tpu_torch.ops import poa_fused_kernel as tpk

from test_poa_fused_kernel import window
from test_torch_pk_build import encode

torch.set_num_threads(1)
NCAPS = (129, 1025, 3073)
L_MAX = 64
B = len(chip_smoke.GLUE_EDGE_CASES)
CYCLIC = [b in chip_smoke.GLUE_CYCLIC for b in range(B)]
FIELDS = ("pn", "pw", "pt", "gc", "ch", "gm", "nn", "tctr", "ovf")


@functools.lru_cache(maxsize=None)
def edge(ncap):
    return chip_smoke.glue_edge_case(ncap, L_MAX)


def state(c):
    return tpk.GraphState(*[torch.from_numpy(c[f].copy()) for f in FIELDS])


@functools.lru_cache(maxsize=None)
def prep_models(ncap):
    c = edge(ncap)
    return [model.prep_window(c["pn"][b], c["gm"][b], c["nn"][b], c["ch"][b],
                              c["seq"][b], c["slen"][b]) for b in range(B)]


@functools.lru_cache(maxsize=None)
def jax_sorts(ncap):
    """JAX's _toposort and _toposort_ref of the edge windows."""
    c = edge(ncap)
    out = {}
    for fn in (jpf._toposort, jpf._toposort_ref):
        res = jax.jit(jax.vmap(lambda p, g, n, fn=fn: fn(p, g, n, ncap)))(
            c["pn"], c["gm"], c["nn"])
        out[fn.__name__] = [np.asarray(x) for x in res]
    return out


@pytest.mark.parametrize("ncap", NCAPS)
def test_k6_model_order_matches_jax(ncap):
    c = edge(ncap)
    sorts = jax_sorts(ncap)
    j_order, j_rank, j_cyc = sorts["_toposort"]
    r_order, r_rank, r_cyc = sorts["_toposort_ref"]
    for b, m in enumerate(prep_models(ncap)):
        assert m["cyclic"] == bool(j_cyc[b]) == bool(r_cyc[b]) == CYCLIC[b]
        np.testing.assert_array_equal(m["order"], j_order[b], err_msg=str(b))
        np.testing.assert_array_equal(m["rank"], j_rank[b], err_msg=str(b))
        if not m["cyclic"]:
            n = c["nn"][b]
            np.testing.assert_array_equal(m["order"][:n], r_order[b][:n])
    assert prep_models(ncap)[6]["steps"] > 1


@pytest.mark.parametrize("ncap", NCAPS)
def test_k6_model_round_prep_matches_jax(ncap):
    c = edge(ncap)
    # JAX packs chain flags 8 windows at a time: pad the batch to 16
    c = {k: np.concatenate([v, v[:16 - B]]) for k, v in c.items()}
    gs, nn, _tctr, _ovf = tpk.graph_state_to_jax(state(c))
    ops, cyc = jax.jit(lambda g, n, s, sl: jpf._pk_round_prep(
        g, n, s, sl, ncap, L_MAX))(gs, nn, c["seq"], c["slen"])
    (chars, sinks, packed, _chain_all, _chainw, gminr, seqv, lb,
     nn_eff) = [np.asarray(o) for o in ops]
    predsp = packed.reshape(16, -1, 8)[:, :ncap]
    for b, m in enumerate(prep_models(ncap)):
        for name, want in (("charsr", chars), ("sinksr", sinks),
                           ("predsp", predsp), ("gminr", gminr),
                           ("seqv", seqv)):
            np.testing.assert_array_equal(m[name], want[b],
                                          err_msg=f"{name} window {b}")
        assert m["lb"] == lb[b, 0] and m["nn_eff"] == nn_eff[b, 0]
        assert m["cyclic"] == bool(np.asarray(cyc)[b])
    assert prep_models(ncap)[4]["nn_eff"] == 0          # the empty read
    assert (prep_models(ncap)[2]["predsp"] >= 0).all(1).any()


@pytest.mark.parametrize("ncap", NCAPS)
def test_k6_model_matches_plain(ncap):
    c = edge(ncap)
    st = state(c)
    order, rank, cyclic = tpf.toposort_reference(st.pn, st.gm, st.nn)
    ops, cyc2 = tpf.pk_round_prep_reference(st, torch.from_numpy(c["seq"]),
                                            torch.from_numpy(c["slen"]))
    names = ("charsr", "sinksr", "predsp", "seqv", "lb", "nn_eff", "gminr")
    for b, m in enumerate(prep_models(ncap)):
        np.testing.assert_array_equal(order[b].numpy(), m["order"])
        np.testing.assert_array_equal(rank[b].numpy(), m["rank"])
        assert bool(cyclic[b]) == bool(cyc2[b]) == m["cyclic"]
        for name, o in zip(names, ops):
            np.testing.assert_array_equal(o[b].numpy(), m[name],
                                          err_msg=f"{name} window {b}")
    # the build's call: the same operands, and ovf set on the cyclic windows
    again, _ = tpf.pk_round_prep(st, torch.from_numpy(c["seq"]),
                                 torch.from_numpy(c["slen"]),
                                 update_ovf=True)
    assert all(torch.equal(a, b) for a, b in zip(again, ops))
    assert st.ovf.tolist() == [int(x) for x in CYCLIC]


@functools.lru_cache(maxsize=None)
def consensus_models(ncap):
    c = edge(ncap)
    steps = int(c["nn"].max())
    return [model.consensus_window(c["pn"][b], c["pw"][b], c["pt"][b],
                                   c["nn"][b], m["order"], steps)
            for b, m in enumerate(prep_models(ncap))]


@pytest.mark.parametrize("ncap", NCAPS)
def test_k7_model_matches_jax(ncap):
    c = edge(ncap)
    order = jax_sorts(ncap)["_toposort"][0]
    want = jax.jit(jax.vmap(lambda ch, pn, pw, pt, nn, o: jpf._consensus_walk(
        ch, pn, pw, pt, nn, o, ncap)))(c["ch"], c["pn"], c["pw"], c["pt"],
                                       c["nn"], order)
    want = [np.asarray(x) for x in want]
    for b, got in enumerate(consensus_models(ncap)):
        if b == chip_smoke.GLUE_WIDE:
            continue                      # past JAX's int32 key range
        for name, g, w in zip(("back_buf", "back_start", "fwd_buf",
                               "fwd_cnt"), got, want):
            np.testing.assert_array_equal(g, w[b], err_msg=f"{name} {b}")
    length = [ncap - m[1] + m[3] for m in consensus_models(ncap)]
    assert length[0] == 0 and length[1] == 1
    assert length[6] > ncap // 8              # along the backbone


@pytest.mark.parametrize("ncap", NCAPS)
def test_k7_model_matches_plain(ncap):
    c = edge(ncap)
    st = state(c)
    order = torch.from_numpy(np.stack([m["order"]
                                       for m in prep_models(ncap)]))
    got = tpf.consensus_walk_reference(st.ch, st.pn, st.pw, st.pt, st.nn,
                                       order)
    for b, m in enumerate(consensus_models(ncap)):
        for g, w in zip(got, m):
            np.testing.assert_array_equal(g[b].numpy(), w)


def test_glue_model_on_real_rounds():
    """Every round of the port's own round loop (plain versions, 8
    windows, ncap 65): the model's prep == the round's operands; after the
    last round the model's order and consensus == the plain versions' and
    == build_batch_pk's."""
    rng = random.Random(7)
    wins = [window(rng, 4, 24, 0.1) for _ in range(8)]
    seqs, lens, nseq = encode(wins, 4, 48)
    ncap = 65
    st = tpk.GraphState.empty(8, ncap, "cpu")
    names = ("charsr", "sinksr", "predsp", "seqv", "lb", "nn_eff", "gminr")
    for r in range(4):
        seq = torch.from_numpy(seqs[:, r].astype(np.int32))
        slen = torch.from_numpy(lens[:, r].copy())
        s = {f: getattr(st, f).numpy().copy() for f in FIELDS}
        ops, _cyc = tpf.pk_round_prep(st, seq, slen, update_ovf=True)
        for b in range(8):
            m = model.prep_window(s["pn"][b], s["gm"][b], s["nn"][b],
                                  s["ch"][b], seq[b].numpy(), lens[b, r])
            for name, o in zip(names, ops):
                np.testing.assert_array_equal(o[b].numpy(), m[name],
                                              err_msg=f"{name} {r} {b}")
        an, asx, ke = tpk.align_tb(*ops[:6])
        tpk.fusion(an, asx, ke, ops[6], seq, st)
    order, _rank, cyclic = tpf.toposort(st.pn, st.gm, st.nn)
    walk = tpf.consensus_walk(st.ch, st.pn, st.pw, st.pt, st.nn, order)
    tpf.reset_counts()
    built = tpf.build_batch_pk(seqs, lens, nseq, ncap=ncap, device="cpu")
    # the plain versions count their steps and host checks
    assert tpf.COUNTS["host_syncs"] > 0 and tpf.COUNTS["kahn_steps"] > 0
    s = {f: getattr(st, f).numpy() for f in FIELDS}
    assert (s["nn"] > 24).all() and not cyclic.any()
    steps = int(s["nn"].max())
    for b in range(8):
        m = model.prep_window(s["pn"][b], s["gm"][b], s["nn"][b])
        np.testing.assert_array_equal(order[b].numpy(), m["order"])
        np.testing.assert_array_equal(built["order"][b], m["order"])
        got = model.consensus_window(s["pn"][b], s["pw"][b], s["pt"][b],
                                     s["nn"][b], m["order"], steps)
        for name, w, g in zip(("back_buf", "back_start", "fwd_buf",
                               "fwd_cnt"), walk, got):
            np.testing.assert_array_equal(w[b].numpy(), g, err_msg=name)
            np.testing.assert_array_equal(built[name][b], g, err_msg=name)


@pytest.mark.parametrize("ncap", NCAPS)
def test_edge_windows_stress_the_new_design(ncap):
    """The windows added for the warp-driven Kahn loop and the 32-bit score
    chain ask what they were built to ask: a head column with over 32
    distinct blockers, a column pair named by several edges and a row
    naming a tail twice, a run of over 32 columns whose span holds placed
    columns and alternatives, one long chain placed in one step, and one
    window (only that one) past the 32-bit keys; and K7's score pass stops
    at each window's own node count, the cyclic windows included."""
    c = edge(ncap)
    m = prep_models(ncap)
    assert m[8]["blockers"] > 32
    assert m[9]["duplicates"] > 0
    rows = c["pn"][9][:c["nn"][9]]
    assert any(len(set(r[r >= 0])) < (r >= 0).sum() for r in rows)
    assert m[10]["max_run"] > 32 and m[10]["max_span"] > m[10]["max_run"]
    assert m[10]["steps"] == 2 and m[10]["max_words"] > 1
    assert m[11]["steps"] == 1 and m[11]["max_run"] == ncap - 1
    batch = int(c["nn"].max())
    plans = [model.score_plan(c["pn"][b], c["pw"][b], c["nn"][b],
                              m[b]["order"], batch) for b in range(B)]
    assert [p[0] for p in plans] == c["nn"].tolist()
    assert [p[1] for p in plans] == [64 if b == chip_smoke.GLUE_WIDE else 32
                                     for b in range(B)]
    assert (c["pw"][chip_smoke.GLUE_WIDE] >= 1 << 10).any()


@pytest.mark.parametrize("ncap", NCAPS)
def test_k7_model_key_widths_agree(ncap):
    """Where 32-bit keys hold, the score pass with 64-bit keys (the plain
    version's) gives the same walk: the max key's two fields are the
    winner's weight and tail score."""
    c = edge(ncap)
    batch = int(c["nn"].max())
    for b, m in enumerate(prep_models(ncap)):
        if b == chip_smoke.GLUE_WIDE:
            continue
        args = (c["pn"][b], c["pw"][b], c["pt"][b], c["nn"][b], m["order"],
                batch)
        for g, w in zip(model.consensus_window(*args, key_bits=32),
                        model.consensus_window(*args, key_bits=64)):
            np.testing.assert_array_equal(g, w, err_msg=str(b))


@pytest.mark.parametrize("ncap", NCAPS[:2])
def test_k7_model_any_order_matches_plain(ncap):
    """On orders that are not K6's (a seeded permutation a window, so
    active nodes sit past a window's node count), the model's score pass,
    which stops past the last rank holding an active node, == the plain
    version, which runs to the batch's largest node count."""
    c = edge(ncap)
    st = state(c)
    rng = np.random.default_rng(ncap)
    order = np.stack([rng.permutation(ncap) for _ in range(B)])
    got = tpf.consensus_walk_reference(st.ch, st.pn, st.pw, st.pt, st.nn,
                                       torch.from_numpy(order))
    batch = int(c["nn"].max())
    steps = []
    for b in range(B):
        want = model.consensus_window(c["pn"][b], c["pw"][b], c["pt"][b],
                                      c["nn"][b], order[b], batch)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), w, err_msg=str(b))
        steps.append(model.score_plan(c["pn"][b], c["pw"][b], c["nn"][b],
                                      order[b], batch)[0])
    assert any(s > n for s, n in zip(steps, c["nn"]))


@pytest.mark.parametrize("ncap", NCAPS[:2])
def test_bounds_count_the_kernels_kahn_steps(ncap):
    """tools/bounds.kahn_work's steps are the ones K6's loop runs (the
    model's), and K6's and K7's bounds come out positive."""
    from svscope_tpu_torch.tools import bounds
    st = state(edge(ncap))
    steps, edges, cols = bounds.kahn_work(st.pn, st.gm, st.nn)
    assert steps.tolist() == [m["steps"] for m in prep_models(ncap)]
    assert (edges[2:] > 0).all() and (cols >= steps).all()
    for b in (bounds.prep_bound(st.pn, st.gm, st.nn, L_MAX)[0],
              bounds.prep_bound(st.pn, st.gm, st.nn, L_MAX, True)[0],
              bounds.consensus_bound(st.pn, st.nn, ncap)):
        assert b[0] > 0 and b[1] in ("bytes", "operations")
