"""The port's attached_bench against the JAX tool: the same per-round
workload arrays, and its `main` runs on the CPU (the plain versions)."""
import importlib.util
import os

import numpy as np
import torch

from svscope_tpu_torch.ops import poa_align
from svscope_tpu_torch.tools import attached_bench as tab

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_attached_bench", os.path.join(REPO, "tools", "attached_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_round_workload_matches_jax_tool():
    want = _jax_tool().build_round_workload(16, np.random.default_rng(0))
    got = tab.build_round_workload(16, np.random.default_rng(0))
    assert len(want) == len(got) == 8
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), np.asarray(g))
        assert np.asarray(w).dtype == np.asarray(g).dtype


def test_main_runs_on_cpu(capsys):
    before = (poa_align.LAUNCHES, poa_align.LAUNCHES16)
    res = tab.main(["--device", "cpu", "--b", "16", "--reps", "1"])
    out = capsys.readouterr().out
    assert set(res) == {"align_batch int32", "align_batch int16",
                        "align_batch_reference int32",
                        "align_batch_reference int16"}
    assert all(ms > 0 for ms in res.values())
    assert "plain version" in out and out.count("[windows/s]") == 4
    # the CPU runs no kernel
    assert (poa_align.LAUNCHES, poa_align.LAUNCHES16) == before


def test_skip_int16_and_round_outputs_agree():
    """--skip-int16 drops the int16 engines; on the workload itself int16 and
    int32 give the same alignments and scores (every window has a sink)."""
    rows = tab.engines(512, skip_int16=True)
    assert [r[0] for r in rows] == ["align_batch int32",
                                    "align_batch_reference int32"]
    *arrs, N, L = tab.build_round_workload(4, np.random.default_rng(0))
    args = tab.to_torch_packed(*arrs, "cpu")
    a32 = poa_align.align_batch(*args, L)
    a16 = poa_align.align_batch(*args, L, int16_mode=True)
    for x, y in zip(a32, a16):
        assert torch.equal(x, y)
