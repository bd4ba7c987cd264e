"""One `pk` round of the port against the JAX package's, on operands
recorded from JAX's own rounds: `_pk_round_prep` (XLA), `align_tb_call`
(K3) and `fusion_call` (K4 lockstep, K5 seq) in interpret mode, over the
windows of tests/test_poa_fused_kernel.py::test_pk_matches_xla_engine_state
(ncap 65, l_max 48, 8 windows, 4 rounds).  The port's plain versions run on
the same inputs; every output is an integer and must match exactly."""
import random

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from svscope_tpu.ops import poa_fused as jpf
from svscope_tpu.ops import poa_fused_kernel as jpk
from svscope_tpu_torch.ops import poa_fused as tpf
from svscope_tpu_torch.ops import poa_fused_kernel as tpk

from test_poa_fused_kernel import window

torch.set_num_threads(1)
NCAP, R_MAX, L_MAX, B = 65, 4, 48, 8


def jax_gs0():
    gs = np.zeros((B, NCAP, jpk.GS_LANES), np.int32)
    gs[..., jpk.L_PN:jpk.L_PN + 8] = -1
    gs[..., jpk.L_GC:jpk.L_GC + 8] = -1
    gs[..., jpk.L_GM] = np.arange(NCAP)
    return gs


@pytest.fixture(scope="module")
def rounds():
    """Per round: the round's read, the state before it, JAX's operands,
    K3's output, and the state and path after lockstep fusion."""
    rng = random.Random(7)
    wins = [window(rng, 4, 24, 0.1) for _ in range(B)]
    seqs = np.zeros((B, R_MAX, L_MAX), np.int32)
    lens = np.zeros((B, R_MAX), np.int32)
    for bi, w in enumerate(wins):
        for ri, s in enumerate(w):
            c = jpf.CODE_OF[np.frombuffer(s.encode(), np.uint8)]
            seqs[bi, ri, :len(c)] = c
            lens[bi, ri] = len(c)
    prep = jax.jit(lambda g, n, s, sl: jpf._pk_round_prep(
        g, n, s, sl, NCAP, L_MAX))
    gs = jax_gs0()
    nn = tctr = ovf = np.zeros((B, 1), np.int32)
    out = []
    for r in range(R_MAX):
        seq, slen = seqs[:, r], lens[:, r]
        ops, cyc = prep(gs, nn, seq, slen)
        ops = [np.asarray(o) for o in ops]
        (charsr, sinksr, packed, chain_all, chainw, gminr, seqv, lb,
         nn_eff) = ops
        an, asx, ke = [np.asarray(x) for x in jpk.align_tb_call(
            charsr, sinksr, packed, chain_all, chainw, seqv, lb, nn_eff,
            n_max=NCAP, l_max=L_MAX, interpret=True)]
        ovf_in = ovf | np.asarray(cyc, np.int32).reshape(B, 1)
        res = [np.asarray(x) for x in jpk.fusion_call(
            an, asx, ke, gminr, seq, nn, tctr, ovf_in, gs, ncap=NCAP,
            n_max=NCAP, l_max=L_MAX, interpret=True)]
        out.append({"seq": seq, "slen": slen, "before": (gs, nn, tctr,
                                                          ovf_in),
                    "ops": ops, "cyclic": np.asarray(cyc), "k3": (an, asx,
                                                                  ke),
                    "after": (res[3], res[0], res[1], res[2]),
                    "path": res[4]})
        nn, tctr, ovf, gs = res[0], res[1], res[2], res[3]
    return out


def t32(a):
    return torch.from_numpy(np.array(a, np.int32, order="C"))


def port_state(before):
    gs, nn, tctr, ovf = before
    return tpk.graph_state_from_jax(gs, nn, tctr, ovf)


def assert_state_equal(st, want, what):
    """want = JAX's (gs, nn, tctr, ovf)."""
    for name, g, w in zip(("gs", "nn", "tctr", "ovf"),
                          tpk.graph_state_to_jax(st), want):
        np.testing.assert_array_equal(g, np.asarray(w),
                                      err_msg=f"{what}: {name}")


@pytest.mark.parametrize("r", range(R_MAX))
def test_round_prep_matches_jax(rounds, r):
    rd = rounds[r]
    ops, cyclic = tpf.pk_round_prep(port_state(rd["before"]), t32(rd["seq"]),
                                    t32(rd["slen"]))
    charsr, sinksr, predsp, seqv, lb, nn_eff, gminr = \
        [o.numpy() for o in ops]
    (j_chars, j_sinks, j_packed, _chain_all, j_chainw, j_gminr, j_seqv,
     j_lb, j_nn) = rd["ops"]
    j_predsp = j_packed.reshape(B, -1, 8)[:, :NCAP]
    # the port builds no chain-row flags (only JAX's TPU kernel reads
    # them); chip_smoke.chain_flags rebuilds them from the pk layout for
    # trees whose K3 still takes them
    chainw = chip_smoke.chain_flags(predsp, nn_eff)
    for name, g, w in (("charsr", charsr, j_chars), ("sinksr", sinksr,
                                                     j_sinks),
                       ("predsp", predsp, j_predsp),
                       ("chainw", chainw, j_chainw),
                       ("gminr", gminr, j_gminr), ("seqv", seqv, j_seqv),
                       ("lb", lb, j_lb[:, 0]), ("nn_eff", nn_eff, j_nn[:, 0]),
                       ("cyclic", cyclic.numpy(), rd["cyclic"])):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("r", range(R_MAX))
def test_align_tb_reference_matches_jax_k3(rounds, r):
    (charsr, sinksr, packed, _chain_all, _chainw, _gminr, seqv, lb,
     nn_eff) = rounds[r]["ops"]
    predsp = packed.reshape(B, -1, 8)[:, :NCAP]
    got = tpk.align_tb_reference(
        t32(charsr), t32(sinksr), t32(predsp), t32(seqv), t32(lb[:, 0]),
        t32(nn_eff[:, 0]))
    an, asx, ke = rounds[r]["k3"]
    np.testing.assert_array_equal(got[0].numpy(), an)
    np.testing.assert_array_equal(got[1].numpy(), asx)
    np.testing.assert_array_equal(got[2].numpy(), ke[:, 0])
    assert (ke[:, 0] < an.shape[1] - 1).sum() >= B // 2    # real alignments


@pytest.mark.parametrize("r", range(R_MAX))
def test_fusion_reference_lockstep_matches_jax_k4(rounds, r):
    rd = rounds[r]
    an, asx, ke = rd["k3"]
    st = port_state(rd["before"])
    path = tpk.fusion_reference(t32(an), t32(asx), t32(ke[:, 0]),
                                t32(rd["ops"][5]), t32(rd["seq"]), st,
                                order="lockstep")
    assert_state_equal(st, rd["after"], f"round {r}")
    np.testing.assert_array_equal(path.numpy(), rd["path"])


@pytest.fixture(scope="module")
def jax_seq_fusion(rounds):
    """JAX's K5 (SVSCOPE_PK_FUSION=seq) on the recorded inputs.  fusion_call
    reads FUSION_ENGINE when it is traced, so the jit caches are cleared
    around the switch."""
    saved = jpk.FUSION_ENGINE
    jax.clear_caches()
    jpk.FUSION_ENGINE = "seq"
    try:
        out = []
        for rd in rounds:
            gs, nn, tctr, ovf = rd["before"]
            an, asx, ke = rd["k3"]
            out.append([np.asarray(x) for x in jpk.fusion_call(
                an, asx, ke, rd["ops"][5], rd["seq"], nn, tctr, ovf, gs,
                ncap=NCAP, n_max=NCAP, l_max=L_MAX, interpret=True)])
    finally:
        jpk.FUSION_ENGINE = saved
        jax.clear_caches()
    return out


@pytest.mark.parametrize("r", range(R_MAX))
def test_fusion_reference_seq_matches_jax_k5(rounds, jax_seq_fusion, r):
    rd = rounds[r]
    an, asx, ke = rd["k3"]
    st = port_state(rd["before"])
    path = tpk.fusion_reference(t32(an), t32(asx), t32(ke[:, 0]),
                                t32(rd["ops"][5]), t32(rd["seq"]), st,
                                order="seq")
    nn, tctr, ovf, gs, jpath = jax_seq_fusion[r]
    assert_state_equal(st, (gs, nn, tctr, ovf), f"round {r} seq")
    np.testing.assert_array_equal(path.numpy(), jpath)


def test_graph_state_round_trip(rounds):
    for rd in rounds:
        for gs, nn, tctr, ovf in (rd["before"], rd["after"]):
            st = tpk.graph_state_from_jax(gs, nn, tctr, ovf)
            back = tpk.graph_state_to_jax(st)
            for a, b in zip(back, (gs, nn, tctr, ovf)):
                np.testing.assert_array_equal(a, np.asarray(b))
            again = tpk.graph_state_from_jax(*back)
            for a, b in zip(again.tensors(), st.tensors()):
                assert torch.equal(a, b)
    empty = tpk.GraphState.empty(B, NCAP, "cpu")
    np.testing.assert_array_equal(tpk.graph_state_to_jax(empty)[0],
                                  jax_gs0())
