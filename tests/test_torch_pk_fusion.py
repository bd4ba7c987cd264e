"""K4's parallel fusion round on the CPU.  The torch model of its phases
(tests/torch_fusion_model.py) against the serial fusion — the port's plain
`fusion_reference` in both orders and JAX's `fusion_call` in interpret mode
(FUSION_ENGINE lockstep and seq) — on the four recorded rounds of
tests/test_torch_pk_round.py and on hand-built edge states
(chip_smoke.fusion_edge_case, one case per window); the windows the model
flags; and K4's shared-memory plan at every pk bucket.  The CUDA kernels
themselves run in tests/test_torch_cuda.py.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_pk_fusion.py -q
"""
from dataclasses import fields

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import torch_fusion_model as tfm
from svscope_tpu.ops import poa_fused_kernel as jpk
from svscope_tpu_torch.ops import poa_align
from svscope_tpu_torch.ops import poa_fused as tpf
from svscope_tpu_torch.ops import poa_fused_kernel as tpk

# the recorded rounds and JAX's seq fusion of them are that file's fixtures
from test_torch_pk_round import (R_MAX, assert_state_equal,  # noqa: F401
                                 jax_seq_fusion, port_state, rounds, t32)

torch.set_num_threads(1)
NCAP, L_MAX = 48, 40                  # fusion_edge_case's shape
CASES = chip_smoke.FUSION_EDGE_CASES


def serial_and_model(an, asx, ke, gminr, seqs5, st):
    """fusion_reference in both orders and the model, each on its own copy
    of `st`: ({"lockstep" | "seq" | "model": (path, state)}, the model's
    flagged windows)."""
    out = {}
    for order in tpk.FUSION_ENGINES:
        s = st.clone()
        out[order] = (tpk.fusion_reference(an, asx, ke, gminr, seqs5, s,
                                           order), s)
    s = st.clone()
    path, flagged = tfm.fuse_parallel(an, asx, ke, gminr, seqs5, s)
    out["model"] = (path, s)
    return out, flagged


def assert_same(got, want, what, w=slice(None)):
    names = ("path",) + tuple(f.name for f in fields(tpk.GraphState))
    for name, a, b in zip(names, [got[0]] + got[1].tensors(),
                          [want[0]] + want[1].tensors()):
        np.testing.assert_array_equal(a[w].numpy(), b[w].numpy(),
                                      err_msg=f"{what}: {name}")


@pytest.fixture(scope="module")
def recorded(rounds):
    out = []
    for rd in rounds:
        an, asx, ke = rd["k3"]
        out.append(serial_and_model(t32(an), t32(asx), t32(ke[:, 0]),
                                    t32(rd["ops"][5]), t32(rd["seq"]),
                                    port_state(rd["before"])))
    return out


@pytest.mark.parametrize("r", range(R_MAX))
def test_model_matches_serial_lockstep_and_jax_k4(rounds, recorded, r):
    out, flagged = recorded[r]
    assert not flagged.any()
    assert_same(out["model"], out["lockstep"], f"round {r}")
    assert_state_equal(out["model"][1], rounds[r]["after"], f"round {r}")
    np.testing.assert_array_equal(out["model"][0].numpy(), rounds[r]["path"])


@pytest.mark.parametrize("r", range(R_MAX))
def test_model_matches_serial_seq_and_jax_k5(jax_seq_fusion, recorded, r):
    out, _flagged = recorded[r]
    assert_same(out["model"], out["seq"], f"round {r} seq")
    nn, tctr, ovf, gs, jpath = jax_seq_fusion[r]
    assert_state_equal(out["model"][1], (gs, nn, tctr, ovf), f"round {r}")
    np.testing.assert_array_equal(out["model"][0].numpy(), jpath)


@pytest.fixture(scope="module")
def edge():
    """fusion_edge_case's round: its arrays, the serial and model results,
    the model's flagged windows, and JAX's fusion_call (interpret) under
    each FUSION_ENGINE, which fusion_call reads when it is traced (the jit
    caches are cleared around the switch)."""
    ops, state = chip_smoke.fusion_edge_case(NCAP, L_MAX)
    st = tpk.GraphState(*[torch.from_numpy(a) for a in state])
    out, flagged = serial_and_model(*[torch.from_numpy(a) for a in ops], st)
    an, asx, ke, gminr, seqs5 = ops
    gs, nn, tctr, ovf = tpk.graph_state_to_jax(st)
    saved = jpk.FUSION_ENGINE
    jax_out = {}
    try:
        for eng in tpk.FUSION_ENGINES:
            jax.clear_caches()
            jpk.FUSION_ENGINE = eng
            jax_out[eng] = [np.asarray(x) for x in jpk.fusion_call(
                an, asx, ke[:, None], gminr, seqs5, nn, tctr, ovf, gs,
                ncap=NCAP, n_max=NCAP, l_max=L_MAX, interpret=True)]
    finally:
        jpk.FUSION_ENGINE = saved
        jax.clear_caches()
    return ops, state, out, flagged, jax_out


def test_edge_states_are_the_cases(edge):
    (an, asx, ke, gminr, seqs5), state, out, _f, _j = edge
    pn, _pw, _pt, gc, ch, _gm, nn, _tctr, ovf = state
    trash = NCAP - 1

    def entries(w):
        return an[w, ke[w] + 1:], asx[w, ke[w] + 1:]
    a, s = entries(0)          # ranks 5 and 6: one column, one new base
    i5, i6 = list(a).index(5), list(a).index(6)
    c5 = seqs5[0, s[i5]]
    assert gminr[0, 5] == gminr[0, 6] == 5 and seqs5[0, s[i6]] == c5
    assert gc[0, 5, c5] == -1
    a, s = entries(1)
    assert nn[1] == trash - 3 and ((a < 0) & (s >= 0)).sum() == 5
    assert ovf.tolist() == [0, 0, 1, 0, 0, 0, 0, 0]
    a, s = entries(3)          # an insertion, then the node with 8 preds
    assert (pn[3, 8] >= 0).all() and a[0] == -1 and a[1] == 8
    a, s = entries(4)          # one substitution on a re-walked chain
    assert ((a >= 0) & (s >= 0)).all()
    assert (seqs5[4, s] != ch[4, a]).sum() == 1
    a, s = entries(5)          # two runs of gaps
    gaps = (a >= 0) & (s == -1)
    assert gaps.sum() == 9 and (np.diff(gaps.astype(int)) == 1).sum() == 2
    assert ke[6] == an.shape[1] - 1
    a, s = entries(7)
    assert (s >= 0).sum() == 30 and nn[7] == 8
    # the serial result: overflow from the trash row, on entry, by an edge
    assert out["lockstep"][1].ovf.tolist() == [0, 1, 1, 1, 0, 0, 0, 0]


def test_model_flags_exactly_cases_1_to_3(edge):
    """A duplicate key, the trash row reached and overflow set on entry
    are flagged; every other case is fused by the parallel phases."""
    assert edge[3].tolist() == [True] * 3 + [False] * 5


@pytest.mark.parametrize("w", range(len(CASES)), ids=CASES)
def test_model_matches_serial_on_edge_states(edge, w):
    out = edge[2]
    assert_same(out["model"], out["lockstep"], CASES[w], w)
    assert_same(out["seq"], out["lockstep"], CASES[w], w)


@pytest.mark.parametrize("w", range(len(CASES)), ids=CASES)
def test_serial_matches_jax_on_edge_states(edge, w):
    """The port's serial fusion == JAX's fusion_call, lockstep and seq.
    One exception: JAX's seq kernel keeps what a creator's row held where
    the port's creator writes its whole row (as JAX's lockstep kernel
    does), so after two creators land on window 1's trash row that row
    differs; the window overflows and goes to the host engine, which never
    reads its state."""
    path, st = edge[2]["lockstep"]
    gs, nn, tctr, ovf = tpk.graph_state_to_jax(st)
    for eng, (j_nn, j_tctr, j_ovf, j_gs, j_path) in edge[4].items():
        rows = slice(0, NCAP - 1) if (eng, w) == ("seq", 1) else slice(None)
        np.testing.assert_array_equal(gs[w, rows], j_gs[w, rows],
                                      err_msg=eng)
        assert (nn[w], tctr[w], ovf[w]) == (j_nn[w], j_tctr[w], j_ovf[w])
        np.testing.assert_array_equal(path[w].numpy(), j_path[w],
                                      err_msg=eng)


@pytest.mark.parametrize("ncap,l_max", [(n + 1, l) for n in tpf.N_LADDER
                                        for l in tpf.L_LADDER])
def test_every_pk_bucket_has_a_k4_launch(ncap, l_max):
    """K4 stages all of a window's entries — K3's buffer of n_max - 1 +
    l_max, up to 3072 + 2048 — as four int32 each, beside bitmaps over the
    keys, the curs and the read positions, in one block's shared memory."""
    out_len = ncap - 1 + l_max
    smem = tpk.fusion_smem_bytes(ncap, l_max, out_len)
    bits = -(-ncap * tpk.ALPHA5 // 32) + -(-ncap // 32) + -(-l_max // 32)
    assert smem == 4 * (4 * out_len + bits)
    assert smem <= poa_align.SMEM_MAX
