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
