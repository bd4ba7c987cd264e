"""The port's roofline table, the one H100 bound that it and chip_smoke.py
share (svscope_tpu_torch/tools/bounds.py), and the engine A/B gate
(tools/probe/engine_ab.py), on the CPU at their smallest sizes."""
import importlib.util
import os

import numpy as np
import pytest
import torch

import chip_smoke
from svscope_tpu_torch.tools import bounds, roofline
from svscope_tpu_torch.tools.probe import engine_ab

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_roofline", os.path.join(REPO, "tools", "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_and_roofline_share_one_bound():
    for name in ("bound", "tensor_bytes", "poa_ops", "k1_bound", "k2_bound",
                 "k2_bound_all", "fusion_bound", "INT16X2_OPS_PER_S"):
        assert getattr(chip_smoke, name) is getattr(bounds, name)
    assert bounds.bound(3.35e9, 0) == pytest.approx((1.0, "bytes"))
    assert bounds.bound(0, 16.7e9)[1] == "operations"
    assert bounds.bound(0, 2 * bounds.INT32_OPS_PER_S / 1e3) == \
        pytest.approx((2.0, "operations"))


def test_k1_bound_counts_the_workload():
    """K1's bound on the roofline batch: inputs and outputs once, 8 ops a
    cell plus 3 a (pred edge, column)."""
    from svscope_tpu_torch.ops.poa_device import to_torch_packed
    arrs = roofline.k1_workload(2, np.random.default_rng(0))
    args = to_torch_packed(*arrs, "cpu")
    outs = [torch.zeros((2, 1024), dtype=torch.int32)] * 2
    edges = int(((arrs[1] >= 0)
                 & (np.arange(roofline.K1_N)[None, :, None] < 500)).sum())
    ops = 2 * 500 * 450 * 8 + edges * 450 * 3
    nbytes = sum(a.nbytes for a in arrs) + 2 * 2 * 1024 * 4
    assert bounds.poa_ops(arrs[1], arrs[3], arrs[5]) == ops
    assert bounds.k1_bound(args, outs) == bounds.bound(nbytes, ops)


def test_k2_bound_all_sums_the_bucket_launches():
    """The all-bucket K2 bound that roofline's K2 row and chip_smoke's
    misscore4096 total print: every launch's bytes and ops summed."""
    from svscope_tpu_torch.tools.workloads import misscore4096_pairs, pad_pairs
    pairs = misscore4096_pairs(n=6)
    launches = [([torch.from_numpy(x) for x in pad_pairs(sub, l_max)], sub)
                for sub, l_max in ((pairs[:2], 4096), (pairs[2:], 4096))]
    work = [bounds.k2_work(a, p) for a, p in launches]
    assert bounds.k2_bound_all(launches) == bounds.bound(
        sum(b for b, _ in work), sum(o for _, o in work))
    assert bounds.k2_bound_all(launches[:1]) == bounds.k2_bound(*launches[0])
    cells = sum(len(a) * len(b) for a, b in pairs)
    assert sum(o for _, o in work) == cells * bounds.K2_OPS_PER_CELL


class _Captured(Exception):
    pass


def _capture(monkeypatch, module, name, stop=True):
    """Replace module.name by a recorder of its first call's arguments."""
    seen = []

    def record(*args, **kw):
        seen.append(args)
        if stop:
            raise _Captured
        return [("", [])] * len(args[0])
    monkeypatch.setattr(module, name, record)
    return seen


def test_workloads_are_the_jax_tools(monkeypatch):
    """The native-POA windows, the K1 batch and the EM windows are the
    inputs the JAX tool builds (captured at its calls)."""
    import svscope_tpu.models.mixture as jmix
    import svscope_tpu.native.poa as jpoa
    import svscope_tpu.ops.poa_device as jdev
    jax_tool = _jax_tool()
    seen = _capture(monkeypatch, jpoa, "poa_msa_batch_native", stop=False)
    jax_tool.native_poa()
    assert seen[1][0] == roofline.msa_windows(64, np.random.default_rng(0))
    seen = _capture(monkeypatch, jdev, "align_batch")
    with pytest.raises(_Captured):
        jax_tool.device_aligners()
    want = [np.asarray(a) for a in seen[0][:6]]
    got = roofline.k1_workload(256, np.random.default_rng(0))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    seen = _capture(monkeypatch, jmix, "em_cluster_batch")
    with pytest.raises(_Captured):
        jax_tool.em_stage()
    for w, g in zip(seen[0][0], roofline.em_windows(
            256, np.random.default_rng(1))):
        np.testing.assert_array_equal(w, g)


def test_roofline_runs_on_cpu(capsys):
    res = roofline.main(["--device", "cpu", "--windows", "4", "--b", "1",
                         "--pairs", "2", "--em-windows", "4"])
    out = capsys.readouterr().out
    assert res["native_poa"]["gcups_core"] > 0
    assert res["K1"]["name"] == "K1 plain (CPU)" and res["K1"]["gcups"] > 0
    assert res["K2"]["name"] == "K2 plain (CPU)"
    assert res["K1"]["bound_ms"] is None       # no device row on the CPU
    assert res["em_windows_per_s"] > 0
    assert "native C++ POA MSA" in out and "EM phasing" in out


def test_engine_ab_same_source_is_identical():
    res = engine_ab.run(windows=8, trials=2, device="cpu",
                        log=lambda *_: None)
    assert res["identical"] and len(res["a_s"]) == len(res["b_s"]) == 2


def test_engine_invariant_check_keeps_the_engine_output():
    """The port's engine, whose Graph::join_group checks its invariant (the
    node is the newest, an edgeless singleton group) and aborts on a
    violation, gives the bytes of the JAX package's engine source
    (native/poa_engine.cpp, which has no check) on the bench windows."""
    res = engine_ab.run(os.path.join(REPO, "native", "poa_engine.cpp"),
                        windows=16, trials=1, device="cpu",
                        log=lambda *_: None)
    assert res["identical"]


FAKE_ENGINE = r"""
#include <cstdint>
extern "C" int poa_msa_batch(const char*, const int64_t*, int64_t,
                             const int64_t*, int64_t n_win, uint8_t* out,
                             int64_t cap, int64_t* out_len, int32_t) {
    for (int64_t w = 0; w < n_win; ++w) {
        out[w * cap] = 'X';
        out[w * cap + 1] = '\n';
        out_len[w] = 2;
    }
    return 0;
}
"""


def test_engine_ab_reports_a_different_output(tmp_path, capsys):
    fake = tmp_path / "fake_engine.cpp"
    fake.write_text(FAKE_ENGINE)
    rc = engine_ab.main([os.path.join(engine_ab.HOST_SRC, "poa_engine.cpp"),
                         str(fake), "--windows", "4", "--device", "cpu"])
    assert rc == 1
    assert "outputs byte-identical: False" in capsys.readouterr().out
