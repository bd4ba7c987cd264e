"""The port's group-Kahn toposort and consensus walk (ops/poa_fused.py)
against the JAX package's `_toposort`, `_toposort_ref` and
`_consensus_walk` on the same states."""
import random

import jax
import numpy as np
import pytest
import torch

from svscope_tpu.ops import poa_fused as jpf
from svscope_tpu_torch.ops import poa_fused as tpf
from svscope_tpu_torch.ops.poa_fused_kernel import (GraphState, align_tb,
                                                    fusion)

torch.set_num_threads(1)
NCAP = 64
P = 8


def random_state(rng, cyclic: bool):
    """A chain backbone with random forward edges and aligned columns (the
    JAX package's test_fast_toposort_matches_reference_kahn states); with
    `cyclic`, one back edge closes a cycle through two columns."""
    n = rng.randint(4, 60)
    pred = np.full((NCAP, P), -1, np.int32)
    gm = np.arange(NCAP, dtype=np.int32)
    for v in range(1, n):
        pred[v, 0] = v - 1
    for _ in range(rng.randint(0, 10)):
        a = rng.randint(0, n - 2)
        b = rng.randint(a + 1, n - 1)
        free = np.flatnonzero(pred[b] < 0)
        if not (pred[b] == a).any() and free.size:
            pred[b, free[0]] = a
    for _ in range(rng.randint(0, 6)):
        a = rng.randint(0, n - 2)
        b = rng.randint(a + 1, n - 1)
        if gm[b] == b and gm[a] == a:
            gm[b] = a
    if cyclic:
        a = rng.randint(0, n - 3)
        b = rng.randint(a + 2, n - 1)
        free = np.flatnonzero(pred[a] < 0)
        pred[a, free[0]] = b                 # b -> a closes a -> ... -> b
    return pred, gm, n


JAX_SORTS = {fn: jax.jit(lambda p, g, nn, fn=fn: fn(p, g, nn, NCAP))
             for fn in (jpf._toposort, jpf._toposort_ref)}


def jax_sort(fn, pred, gm, n):
    return [np.asarray(x) for x in JAX_SORTS[fn](pred, gm, np.int32(n))]


@pytest.fixture(scope="module")
def states():
    rng = random.Random(99)
    out = [random_state(rng, cyclic=False) for _ in range(24)]
    out += [random_state(rng, cyclic=True) for _ in range(8)]
    return out


def port_sort(states, **kw):
    pred = torch.from_numpy(np.stack([s[0] for s in states]))
    gm = torch.from_numpy(np.stack([s[1] for s in states]))
    nn = torch.tensor([s[2] for s in states], dtype=torch.int32)
    return [t.numpy() for t in tpf.toposort(pred, gm, nn, **kw)]


def test_toposort_matches_jax_toposort(states):
    order, rank, cyclic = port_sort(states)
    n_cyclic = 0
    for b, (pred, gm, n) in enumerate(states):
        j_order, j_rank, j_cyc = jax_sort(jpf._toposort, pred, gm, n)
        assert bool(cyclic[b]) == bool(j_cyc), b
        np.testing.assert_array_equal(order[b], j_order, err_msg=str(b))
        np.testing.assert_array_equal(rank[b], j_rank, err_msg=str(b))
        n_cyclic += bool(j_cyc)
    assert n_cyclic >= 4          # the cyclic states really are cyclic


def test_toposort_matches_jax_reference_kahn(states):
    order, rank, cyclic = port_sort(states)
    for b, (pred, gm, n) in enumerate(states):
        r_order, r_rank, r_cyc = jax_sort(jpf._toposort_ref, pred, gm, n)
        assert bool(cyclic[b]) == bool(r_cyc), b
        if not r_cyc:
            np.testing.assert_array_equal(order[b][:n], r_order[:n])
            np.testing.assert_array_equal(rank[b][:n], r_rank[:n])


@pytest.mark.parametrize("check_every", [1, 3, 64])
def test_toposort_independent_of_check_interval(states, check_every):
    want = port_sort(states)
    got = port_sort(states, check_every=check_every)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_kahn_steps_past_convergence_change_nothing(states):
    """Once a window places nothing, further steps leave grp_placed and
    it_placed as they are — so the loop may check convergence only every
    k steps."""
    pred = torch.from_numpy(np.stack([s[0] for s in states])).long()
    gm = torch.from_numpy(np.stack([s[1] for s in states])).long()
    nn = torch.tensor([s[2] for s in states])
    B = len(states)
    ids = torch.arange(NCAP)
    active = ids < nn[:, None]
    is_grp = active & (gm == ids)
    tails = gm.gather(1, pred.clamp(0, NCAP - 1).reshape(B, -1))
    heads = gm.repeat_interleave(P, dim=1)
    ev = ((pred >= 0) & active[:, :, None]).reshape(B, -1) & (tails != heads)
    st = (torch.zeros((B, NCAP), dtype=torch.bool),
          torch.full((B, NCAP), tpf.BIG, dtype=torch.long))
    it = 0
    while True:
        st, place = tpf.kahn_step(st, is_grp, ev, tails, heads, ids, it)
        it += 1
        if not place.any():
            break
    assert it < NCAP
    for extra in range(5):
        st2, place = tpf.kahn_step(st, is_grp, ev, tails, heads, ids,
                                   it + extra)
        assert not place.any()
        assert torch.equal(st2[0], st[0]) and torch.equal(st2[1], st[1])


def built_state(seed: int):
    """Graph states of 6 windows after the port's own round loop (CPU)."""
    rng = np.random.default_rng(seed)
    B, R, L, ncap = 6, 5, 40, 97
    seqs = np.zeros((B, R, L), np.uint8)
    lens = np.zeros((B, R), np.int32)
    for b in range(B):
        ref = rng.integers(0, 4, 30)
        for r in range(R):
            row = ref.copy()
            row[rng.integers(0, 30, 3)] = rng.integers(0, 4, 3)
            if r % 2:
                row = np.concatenate([row[:15], rng.integers(0, 4, 4),
                                      row[15:]])
            seqs[b, r, :len(row)] = row
            lens[b, r] = len(row)
    lens[5, 2:] = 0                       # a window with fewer reads
    st = GraphState.empty(B, ncap, "cpu")
    seqs_t = torch.from_numpy(seqs).int()
    for r in range(R):
        ops, cyc = tpf.pk_round_prep(st, seqs_t[:, r],
                                     torch.from_numpy(lens[:, r]))
        an, asx, ke = align_tb(*ops[:6])
        fusion(an, asx, ke, ops[6], seqs_t[:, r], st)
    return st


def test_consensus_walk_matches_jax():
    st = built_state(5)
    order, _rank, cyclic = tpf.toposort(st.pn, st.gm, st.nn)
    assert not cyclic.any()
    got = [t.numpy() for t in tpf.consensus_walk(st.ch, st.pn, st.pw, st.pt,
                                                 st.nn, order)]
    ncap = st.ch.shape[1]
    s = st.numpy()
    want = jax.jit(jax.vmap(
        lambda c, pn, pw, pt, nn, o: jpf._consensus_walk(
            c, pn, pw, pt, nn, o, ncap)))(
        s["ch"], s["pn"], s["pw"], s["pt"], s["nn"],
        order.numpy().astype(np.int32))
    for name, g, w in zip(("back_buf", "back_start", "fwd_buf", "fwd_cnt"),
                          got, want):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    assert (got[1] < ncap - 20).all()      # each walk covers the backbone
