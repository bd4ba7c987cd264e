"""The port's row probe against the JAX probe: every variant's hN equals
the JAX probe's Pallas kernel (`tools/probe/row_probe.make_kernel`, run in
interpret mode with the probe's block specs) on the same inputs, B=8."""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from svscope_tpu_torch.ops import poa_align
from svscope_tpu_torch.tools.probe import row_probe as trp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 8


def _jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_row_probe", os.path.join(REPO, "tools", "probe", "row_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jrp():
    return _jax_probe()


def _jax_run(jrp, chars, seqs, variant):
    """run_padded's pallas_call, in interpret mode."""
    f = pl.pallas_call(
        jrp.make_kernel(variant), grid=(B // jrp.W,),
        in_specs=[pl.BlockSpec((jrp.W, jrp.NROWS), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((jrp.W, jrp.L1), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((jrp.W, jrp.L1), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((B, jrp.L1), jnp.int32),
        scratch_shapes=[pltpu.VMEM((jrp.NROWS + 1, jrp.W, jrp.L1),
                                   jnp.int32)],
        interpret=True)
    return np.asarray(f(chars, seqs))


def test_constants_match_jax_probe(jrp):
    assert (trp.W, trp.NROWS, trp.LM, trp.L1, trp.NEG, trp.GAP) == \
        (jrp.W, jrp.NROWS, jrp.LM, jrp.L1, int(jrp.NEG), jrp.GAP)


@pytest.mark.parametrize("variant", trp.VARIANTS)
def test_variant_matches_jax_probe(jrp, variant):
    chars, seqs = trp.make_inputs(B)
    want = _jax_run(jrp, chars.numpy(), seqs.numpy(), variant)
    before = dict(trp.LAUNCHES)
    got = trp.row_probe(chars, seqs, variant)
    assert trp.LAUNCHES == before                  # the CPU runs no kernel
    assert got.dtype == torch.int32 and got.shape == (B, trp.L1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_inputs_are_the_jax_probes():
    """main() of the JAX probe draws chars then seqs from default_rng(0)."""
    rng = np.random.default_rng(0)
    chars = rng.integers(65, 69, (B, trp.NROWS)).astype(np.int32)
    seqs = rng.integers(65, 69, (B, trp.L1)).astype(np.int32)
    c, s = trp.make_inputs(B)
    np.testing.assert_array_equal(c.numpy(), chars)
    np.testing.assert_array_equal(s.numpy(), seqs)


def test_main_on_cpu_and_bad_input(capsys):
    res = trp.main(["loop", "row", "--device", "cpu", "--reps", "1"])
    assert set(res) == {"loop", "row"}
    assert all(r["max_abs_err"] == 0 for r in res.values())
    assert "us/row" in capsys.readouterr().out
    chars, seqs = trp.make_inputs(2)
    with pytest.raises(ValueError):
        trp.row_probe(chars, seqs, "nope")
    with pytest.raises(ValueError):
        trp.row_probe_cuda(chars, seqs, "loop")     # CPU tensors


@pytest.mark.parametrize("l1", [1, 33, trp.L1, 1025, 4096])
def test_launch_config_is_k1s(l1):
    """The kernel's CTA is K1's for l_max = l1 - 1: its columns a thread and
    thread count, whole warps covering the l1 columns (at 1025: 3 columns
    a thread, the last thread's tile partial; at 4096, K1's widest row,
    4 columns on 1024 threads)."""
    tiles, threads = trp.launch_config(l1)
    assert (tiles, threads) == (poa_align.launch_tiles(l1 - 1),
                                poa_align.launch_threads(l1 - 1))
    assert threads % 32 == 0 and tiles * threads >= l1
    assert tiles * (threads - 32) < l1                  # no idle warp
    if l1 == 1025:
        assert tiles == 3 and l1 % tiles != 0
    if l1 == 4096:
        assert (tiles, threads) == (poa_align.MAX_TILES, 1024)
    with pytest.raises(ValueError):
        trp.launch_config(0)
