"""The port's fusion-body probe against the JAX probe: `build_states`
gives the JAX probe's seven arrays, and every variant's (nn_out, graph
state, path) equals the JAX probe's Pallas kernel
(`tools/probe/fusebody_probe.make_kernel`, run in interpret mode with the
probe's block specs) on them, the state compared in the JAX lane layout
(`graph_state_to_jax`)."""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from svscope_tpu_torch.ops.poa_device import MAX_PREDS
from svscope_tpu_torch.ops.poa_fused_kernel import graph_state_to_jax
from svscope_tpu_torch.tools.probe import fusebody_probe as tfb

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jfb():
    spec = importlib.util.spec_from_file_location(
        "jax_fusebody_probe",
        os.path.join(REPO, "tools", "probe", "fusebody_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def states(jfb):
    return jfb.build_states()


def _jax_run(jfb, variant, states):
    """run()'s pallas_call, in interpret mode."""
    gs, an, asx, seqs5, order, gminr, nn = states
    sm, vm = pltpu.SMEM, pltpu.VMEM
    bs = pl.BlockSpec
    f = pl.pallas_call(
        jfb.make_kernel(variant),
        in_specs=[bs(memory_space=vm), bs(memory_space=vm),
                  bs(memory_space=sm), bs(memory_space=sm),
                  bs(memory_space=sm), bs(memory_space=sm),
                  bs(memory_space=vm)],
        out_specs=[bs(memory_space=sm), bs(memory_space=vm),
                   bs(memory_space=vm)],
        out_shape=[jax.ShapeDtypeStruct((jfb.W, 1), jnp.int32),
                   jax.ShapeDtypeStruct((jfb.W, jfb.NCAP, jfb.GS_LANES),
                                        jnp.int32),
                   jax.ShapeDtypeStruct((jfb.W, jfb.L_MAX), jnp.int32)],
        interpret=True)
    return [np.asarray(x) for x in f(an, asx, seqs5, order, gminr, nn, gs)]


def test_build_states_matches_jax(jfb, states):
    assert (tfb.W, tfb.NCAP, tfb.L_MAX, tfb.OUT_LEN) == \
        (jfb.W, jfb.NCAP, jfb.L_MAX, jfb.OUT_LEN)
    got = tfb.build_states()
    assert len(got) == len(states) == 7
    for a, b in zip(got, states):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_state_round_trip(states):
    """device_inputs' GraphState maps back to the replayed gs exactly."""
    *_ops, st = tfb.device_inputs(states)
    np.testing.assert_array_equal(graph_state_to_jax(st)[0], states[0])


@pytest.mark.parametrize("variant", tfb.VARIANTS)
def test_variant_matches_jax_probe(jfb, states, variant):
    nn_want, gs_want, path_want = _jax_run(jfb, variant, states)
    *ops, st = tfb.device_inputs(states)
    before = dict(tfb.LAUNCHES)
    nn_out, path = tfb.fusebody(variant, *ops, st)
    assert tfb.LAUNCHES == before                  # the CPU runs no kernel
    np.testing.assert_array_equal(nn_out.numpy(), nn_want[:, 0])
    np.testing.assert_array_equal(path.numpy(), path_want)
    np.testing.assert_array_equal(graph_state_to_jax(st)[0], gs_want)
    # the writing variants change the state; the others leave it
    assert (gs_want != states[0]).any() == (variant in ("full", "noread"))
    # the bound's bytes: the entries' reads, the state elements the JAX
    # variant changed, nn in, nn_out and path out
    *_ops, st0 = tfb.device_inputs(states)
    changed = int((gs_want != states[0]).sum())
    assert tfb.variant_bytes(variant, st0, st) == 4 * (
        tfb.W * tfb.STEPS * tfb.ENTRY_READS[variant] + changed
        + tfb.W * (tfb.L_MAX + 2))


def test_main_on_cpu_and_bad_input(capsys):
    res = tfb.main(["empty", "logic", "--device", "cpu", "--reps", "1"])
    assert set(res) == {"empty", "logic"}
    assert "us/step" in capsys.readouterr().out
    *ops, st = tfb.device_inputs(tfb.build_states())
    with pytest.raises(ValueError):
        tfb.fusebody("nope", *ops, st)
    with pytest.raises(ValueError):
        tfb.fusebody_cuda("full", *ops, st, 0)      # CPU tensors


def _serial_walk(variant, an, asx, seqs5, gminr, nn, st, k0):
    """The probe's body, one window after the other, one entry after the
    other, in plain Python on numpy copies (the JAX body's order and
    stand-in constants).  Returns (nn_out, path, state arrays)."""
    an, asx, seqs5, gminr, nn = (t.numpy() for t in (an, asx, seqs5, gminr,
                                                       nn))
    s = {k: v.copy() for k, v in st.numpy().items()}
    B, out_len = an.shape
    ncap, n_max, l_max = s["ch"].shape[1], gminr.shape[1], seqs5.shape[1]
    trash = ncap - 1
    reads = variant in ("full", "nowrite")
    nn_out = nn.copy()
    path = np.full((B, l_max), 0 if variant == "noveccarry" else -1,
                   np.int32)
    for w in range(B):
        if variant in ("empty", "scal16", "noveccarry"):
            if variant == "noveccarry":
                nn_out[w] = out_len - k0
            continue
        pn, pw, pt, gc = (s[k][w] for k in ("pn", "pw", "pt", "gc"))
        n, tc, prev = int(nn[w]), 0, -1
        for k in range(k0, out_len):
            aspv = k % 400 if variant == "logic" else int(asx[w, k])
            anv = k % 700 if variant == "logic" else int(an[w, k])
            valid = aspv >= 0
            sposc = min(max(aspv, 0), l_max - 1)
            c5 = int(seqs5[w, sposc])
            has_node = valid and anv >= 0
            anc = min(max(anv, 0), n_max - 1)
            gid_old = int(gminr[w, anc])
            if reads:
                pre = int(gc[min(max(gid_old, 0), trash), c5]) \
                    if has_node else -1
            else:
                pre = anc if has_node and c5 > 2 else -1
            creator = valid and pre < 0
            newid = min(n, trash)
            cur = newid if creator else pre
            gid = gid_old if has_node else newid
            if variant == "full" and creator:
                s["ch"][w, newid] = c5
                s["gm"][w, newid] = gid
                if gid == newid:
                    gc[newid, c5] = newid
            n = min(n + int(creator), trash)
            add_e = valid and prev >= 0
            curc = min(max(cur, 0), trash)
            if reads:
                row = [int(x) for x in pn[curc]]
                eslot = row.index(prev) if prev in row else None
                nvalid = sum(x >= 0 for x in row)
                has_e = add_e and eslot is not None
                newe = add_e and not has_e and nvalid < MAX_PREDS
                slot = eslot if has_e else min(nvalid, MAX_PREDS - 1)
                w_old = int(pw[curc, slot])
            else:
                has_e = add_e and c5 < 3
                slot = min(c5, MAX_PREDS - 1)
                w_old = tc
                newe = add_e and not has_e
            if variant in ("full", "noread") and (has_e or newe):
                pn[curc, slot] = prev
                pw[curc, slot] = w_old + 1 if has_e else 1
                if newe:
                    pt[curc, slot] = tc
            tc += int(newe)
            if valid:
                path[w, sposc] = cur
                prev = cur
        nn_out[w] = n
    return nn_out, path, s


@pytest.mark.parametrize("variant", tfb.VARIANTS)
@pytest.mark.parametrize("entries", chip_smoke.FUSEBODY_EDGE_ENTRIES)
def test_reference_at_tile_edges_is_the_serial_walk(states, entries,
                                                    variant):
    """fusebody_reference over the last `entries` entries (the edges of the
    kernel's 256-entry tiles, and all OUT_LEN) equals a straight serial
    walk of the same entries."""
    k0 = tfb.OUT_LEN - entries
    *ops, st = tfb.device_inputs(states)
    nn_want, path_want, st_want = _serial_walk(variant, *ops, st, k0)
    nn_out, path = tfb.fusebody_reference(variant, *ops, st, k0)
    np.testing.assert_array_equal(nn_out.numpy(), nn_want)
    np.testing.assert_array_equal(path.numpy(), path_want)
    for k, v in st.numpy().items():
        np.testing.assert_array_equal(v, st_want[k], err_msg=k)


def test_pred_rows_are_contiguous_16_byte_words(states):
    """The kernel reads a pred row (pn) and its weights (pw) as two 16-byte
    words: in the GraphState the probe gets, and in the clones it is timed
    on, each row is 8 contiguous int32 (32 bytes) and the tensor starts at
    a 16-byte-aligned address, so every row's words are aligned too."""
    *_ops, st = tfb.device_inputs(states)
    for s in (st, st.clone()):
        for t in (s.pn, s.pw):
            assert t.is_contiguous() and t.dtype == torch.int32
            assert t.shape == (tfb.W, tfb.NCAP, MAX_PREDS)
            assert t.stride() == (tfb.NCAP * MAX_PREDS, MAX_PREDS, 1)
            assert t.data_ptr() % 16 == 0
            assert (MAX_PREDS * t.element_size()) % 16 == 0
