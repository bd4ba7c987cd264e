"""The port's whole `pk` build (ops/poa_fused.build_batch_pk, plain kernel
versions on the CPU) against the JAX package's `_build_batch(engine="pk",
interpret=True)`: node count, chars and column ids on active rows, read
paths, final order, consensus buffers and overflow flags, exactly."""
import random

import jax
import numpy as np
import pytest
import torch

from svscope_tpu.ops import poa_fused as jpf
from svscope_tpu_torch.ops import poa_fused as tpf

from test_poa_fused_kernel import window

torch.set_num_threads(1)


def encode(wins, r_max, l_max):
    B = len(wins)
    seqs = np.zeros((B, r_max, l_max), np.uint8)
    lens = np.zeros((B, r_max), np.int32)
    nseq = np.zeros(B, np.int32)
    for bi, w in enumerate(wins):
        nseq[bi] = len(w)
        for ri, s in enumerate(w):
            c = jpf.CODE_OF[np.frombuffer(s.encode(), np.uint8)]
            seqs[bi, ri, :len(c)] = c
            lens[bi, ri] = len(c)
    return seqs, lens, nseq


def compare(port, jax_res, overflow_ok=False):
    (chars, gm, nn, path, order, back_buf, back_start, fwd_buf, fwd_cnt,
     overflow) = [np.asarray(x) for x in jax_res]
    np.testing.assert_array_equal(port["nn"], nn)
    np.testing.assert_array_equal(port["overflow"], overflow)
    if not overflow_ok:
        assert not overflow.any()
    for b in range(len(nn)):
        if overflow[b]:
            continue                    # the host engine redoes the window
        n = nn[b]
        np.testing.assert_array_equal(port["ch"][b][:n], chars[b][:n])
        np.testing.assert_array_equal(port["gm"][b][:n], gm[b][:n])
        for name, want in (("path", path), ("order", order),
                           ("back_buf", back_buf),
                           ("back_start", back_start),
                           ("fwd_buf", fwd_buf), ("fwd_cnt", fwd_cnt)):
            np.testing.assert_array_equal(port[name][b], want[b],
                                          err_msg=f"{name} window {b}")


@pytest.fixture(scope="module")
def case():
    """The windows of test_poa_fused_kernel.test_pk_matches_xla_engine_state
    and JAX's pk build of them."""
    rng = random.Random(7)
    wins = [window(rng, 4, 24, 0.1) for _ in range(8)]
    ncap, r_max, l_max = 65, 4, 48
    seqs, lens, nseq = encode(wins, r_max, l_max)
    want = jax.device_get(jpf._build_batch(
        seqs, lens, nseq, ncap=ncap, r_max=r_max, l_max=l_max, engine="pk",
        interpret=True))
    return seqs, lens, nseq, ncap, want


@pytest.mark.parametrize("engine", ["lockstep", "seq"])
def test_build_matches_jax_pk_build(case, engine, monkeypatch):
    monkeypatch.setenv("SVSCOPE_PK_FUSION", engine)
    seqs, lens, nseq, ncap, want = case
    got = tpf.build_batch_pk(seqs, lens, nseq, ncap=ncap, device="cpu")
    compare(got, want)
    assert (got["nn"] > 24).all()


def test_build_overflow_flags_match_jax():
    """Divergent windows in a small node bucket: some overflow (the trash
    row fills), the others must still match exactly."""
    rng = random.Random(11)
    wins = [window(rng, 6, 20, rng.choice([0.02, 0.4])) for _ in range(8)]
    wins[0] = ["".join(rng.choice("ACGT") for _ in range(20))
               for _ in range(6)]
    ncap, r_max, l_max = 41, 8, 32
    seqs, lens, nseq = encode(wins, r_max, l_max)
    want = jax.device_get(jpf._build_batch(
        seqs, lens, nseq, ncap=ncap, r_max=r_max, l_max=l_max, engine="pk",
        interpret=True))
    got = tpf.build_batch_pk(seqs, lens, nseq, ncap=ncap, device="cpu")
    compare(got, want, overflow_ok=True)
    assert got["overflow"][0] and not got["overflow"].all()


def test_round_hook_sees_real_operands(case):
    seqs, lens, nseq, ncap, _ = case
    seen = []

    def hook(r, ops, st, an, asx, ke):
        seen.append((r, int(st.nn.max()), an.shape, int(ke.min())))
    tpf.build_batch_pk(seqs, lens, nseq, ncap=ncap, device="cpu",
                       round_hook=hook)
    assert [s[0] for s in seen] == [0, 1, 2, 3]
    assert seen[0][1] == 0 and seen[1][1] > 0
    assert seen[0][2] == (8, ncap - 1 + 48)
    assert all(s[3] < ncap - 1 + 48 - 1 for s in seen)
