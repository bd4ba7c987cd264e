"""The port's int16 probe against the JAX probe: the five int16 ops equal
the JAX probe's Pallas kernels (`tools/probe/int16_mosaic_probe.make_kernel`,
interpret mode) on its inputs; the packed s16x2 ops equal numpy on pairs
of neighbouring int16; `main` exits non-zero on a FAIL."""
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from svscope_tpu_torch.tools.probe import int16_probe as tip

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jip():
    spec = importlib.util.spec_from_file_location(
        "jax_int16_probe",
        os.path.join(REPO, "tools", "probe", "int16_mosaic_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("op", tip.OPS)
def test_op_matches_jax_probe(jip, op):
    x, y, z = tip.probe_inputs()
    want = np.asarray(pl.pallas_call(
        jip.make_kernel(op),
        out_shape=jax.ShapeDtypeStruct((16, 128), jnp.int16),
        interpret=True)(x.numpy(), y.numpy()))
    before = dict(tip.LAUNCHES)
    got = tip.int16_op(op, x, y, z)
    assert tip.LAUNCHES == before                  # the CPU runs no kernel
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)


def _pairs_numpy(op, x, y, z):
    """The s16x2 intrinsic on 32-bit words, halfword by halfword."""
    def half(w, h):
        return ((w >> (16 * h)) & 0xFFFF).astype(np.uint16).view(
            np.int16).astype(np.int32)
    xw, yw, zw = (np.ascontiguousarray(a).view(np.uint32) for a in (x, y, z))
    out = np.zeros_like(xw)
    for h in (0, 1):
        a, b, c = half(xw, h), half(yw, h), half(zw, h)
        if op == "vmaxs2":
            r = np.maximum(a, b)
        elif op == "vimax3_s16x2":
            r = np.maximum(np.maximum(a, b), c)
        else:
            r = np.maximum(a + b, c)
        out |= r.astype(np.int16).view(np.uint16).astype(np.uint32) \
            << np.uint32(16 * h)
    return out.view(np.int16).reshape(x.shape)


@pytest.mark.parametrize("op", tip.DPX_OPS)
@pytest.mark.parametrize("inputs", ["probe", "large"])
def test_packed_op_matches_numpy(op, inputs):
    x, y, z = tip.probe_inputs() if inputs == "probe" else \
        tip.large_inputs(32)
    want = _pairs_numpy(op, x.numpy(), y.numpy(), z.numpy())
    np.testing.assert_array_equal(tip.int16_op(op, x, y, z).numpy(), want)


def test_large_inputs_keep_sums_in_int16():
    x, y, _z = tip.large_inputs(64)
    s = x.int() + y.int()
    assert int(s.max()) < 32768 and int(s.min()) >= -32768
    assert tip.op_bytes("viaddmax_s16x2", 64) == 4 * 64 * 128 * 2


def test_main_on_cpu_and_exit_code(capsys):
    res = tip.main(["--device", "cpu", "--rows", "64", "--reps", "1"])
    out = capsys.readouterr().out
    assert set(res) == set(tip.ALL_OPS) and all(r["ok"] for r in res.values())
    assert res["max16"]["library_ms"] is not None
    assert res["eq16"]["library_ms"] is None
    assert out.count(" OK\n") == len(tip.ALL_OPS) and "ALL OK" in out
    x, y, z = tip.probe_inputs()
    with pytest.raises(ValueError):
        tip.int16_op("nope", x, y, z)
    with pytest.raises(ValueError):
        tip.int16_op_cuda("eq16", x, y, z)          # CPU tensors
    # a FAIL is no pass: the tool exits non-zero (one op made to disagree)
    script = ("import sys, torch\n"
              "from svscope_tpu_torch.tools.probe import int16_probe as t\n"
              "ref = t.int16_op_reference\n"
              "t.int16_op = lambda op, x, y, z: ref(op, x, y, z) + "
              "(op == 'le16')\n"
              "res = t.main(['--device', 'cpu', '--rows', '8', '--reps', '1'])"
              "\nsys.exit(0 if all(r['ok'] for r in res.values()) else 1)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1, r.stderr[-2000:]
    assert "le16             FAIL" in r.stdout and "ALL OK" not in r.stdout
