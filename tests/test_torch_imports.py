"""The port stands alone: it imports nothing of JAX or of the JAX package,
builds and loads its own host C++ engines, and its JAX-free test helpers
draw the inputs that bench.py and tests/synth.py draw."""
import ctypes
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import localgraph_golden as lgg
import torch_workloads as tw
from svscope_tpu_torch import native
from svscope_tpu_torch.native import _build, hcluster
from svscope_tpu_torch.native import bam as native_bam
from svscope_tpu_torch.native import poa as native_poa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def test_port_and_smoke_import_nothing_of_jax_package():
    """Every module of the port (the scale-out's and the measurement
    tools' among them), chip_smoke.py and the card-side helpers, with jax
    and svscope_tpu blocked, then the scale-out dry run on two CPU
    devices, the small WGS sweep against its golden, a synth-pair
    AlnFeature run and a DataPrepare --saveData + localGraph_npz replay;
    no
    `jax` or `svscope_tpu(.*)` module may be loaded, and no library under
    svscope_tpu/ may be mapped."""
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["svscope_tpu"] = None
        import torch
        torch.set_num_threads(1)
        import svscope_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            svscope_tpu_torch.__path__, "svscope_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        scale_out = {"svscope_tpu_torch.parallel.dataparallel",
                     "svscope_tpu_torch.parallel.mesh",
                     "svscope_tpu_torch.parallel.shard",
                     "svscope_tpu_torch.ops.poa_sharded",
                     "svscope_tpu_torch.graft_entry",
                     "svscope_tpu_torch.tools.dist_worker",
                     "svscope_tpu_torch.tools.multihost_demo"}
        assert scale_out <= set(names), scale_out - set(names)
        tools = {"svscope_tpu_torch.tools." + m for m in (
            "bench", "genome_bench", "wgs_bench", "roofline", "bounds",
            "probe.core_scaling_probe", "probe.engine_ab",
            "probe.stage_probe", "probe.pipeline_probe",
            "probe.pk_phase_probe", "probe.e2e_probe", "probe.fused_probe")}
        assert tools <= set(names), tools - set(names)
        import genome_golden
        from svscope_tpu_torch.tools import wgs_bench
        res = wgs_bench.run(**genome_golden.WGS_SMALL, device="cpu",
                            log=lambda *_: None)
        assert res["sha256"] == genome_golden.load_golden()["wgs_small"][
            "sha256"]
        from svscope_tpu_torch import graft_entry
        graft_entry.dryrun_multichip(2, devices=("cpu", "cpu"))
        import chip_smoke, torch_workloads, localgraph_golden
        import alnfeature_golden as ag
        import dataprepare_golden as dg
        raw = ag.load_golden()["synth_pair"]["raw_bed"]
        out = ag.port_aln_outputs(raw, "cpu")
        assert out == ag.load_golden()["synth_pair"]["outputs"]
        assert dg.port_npz_replay("cpu") == \
            dg.load_golden()["npz_replay"]["raw_bed"]
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "svscope_tpu") and sys.modules[m] is not None]
        assert not bad, bad
        maps = open("/proc/self/maps").read()
        assert "svscope_tpu/native/" not in maps
        assert "svscope_tpu_torch/csrc/_build/libbamscan.so" in maps
        print("ok", len(names))
    """)
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith("ok")


@pytest.mark.parametrize("name", sorted(lgg.WORKLOADS))
def test_helpers_draw_bench_payloads(name):
    assert lgg.payload_sha256(lgg.make_workload(name)) == \
        lgg.payload_sha256(lgg.bench_workload(name))


def test_helpers_write_synth_bams(tmp_path):
    from synth import make_test_pair
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    want = make_test_pair(str(tmp_path / "a"))
    got = tw.make_test_pair(str(tmp_path / "b"))
    assert got[3:] == want[3:]
    for p, q in zip([*got[:3], got[0] + ".fai"], [*want[:3], want[0] + ".fai"]):
        with open(p, "rb") as f, open(q, "rb") as g:
            assert f.read() == g.read()


def test_host_engines_build_into_the_port():
    """libpoa, libhcluster and libbamscan come from csrc/host/ and live in
    csrc/_build/, never under svscope_tpu/."""
    for lib, src in ((native_poa.lib(), "poa_engine.cpp"),
                     (hcluster.lib(), "hcluster.cpp"),
                     (native_bam.lib(), "bam_scan.cpp")):
        assert os.path.dirname(lib._name) == native.BUILD_DIR
        with open(lib._name + ".meta.json") as f:
            meta = json.load(f)
        assert meta["src_sha256"] == _build._src_hash(
            os.path.join(native.HOST_SRC, src))
    assert native.BUILD_DIR.endswith(os.path.join("svscope_tpu_torch", "csrc",
                                                  "_build"))


def test_build_policy_rebuilds_on_source_change(tmp_path):
    src = tmp_path / "k.cpp"
    lib = str(tmp_path / "build" / "libk.so")
    src.write_text('extern "C" int k() { return 1; }\n')
    assert _build.ensure_lib(str(src), lib) == lib
    assert ctypes.CDLL(lib).k() == 1
    mtime = os.stat(lib).st_mtime_ns
    _build.ensure_lib(str(src), lib)                 # fresh: no rebuild
    assert os.stat(lib).st_mtime_ns == mtime
    src.write_text('extern "C" int k() { return 2; }\n')
    _build.ensure_lib(str(src), lib)
    with open(lib + ".meta.json") as f:
        assert json.load(f)["src_sha256"] == _build._src_hash(str(src))
    assert not [p for p in os.listdir(tmp_path / "build")
                if p.endswith(".tmp")]
    os.remove(str(src))
    assert _build.ensure_lib(str(src), lib) == lib   # no source: load as is
    os.remove(lib)
    with pytest.raises(RuntimeError):
        _build.ensure_lib(str(src), lib)


def test_misscore4096_pairs_shape():
    pairs = tw.misscore4096_pairs(n=64)
    assert len(pairs) == 64
    assert all(max(len(a), len(b)) <= 4000 for a, b in pairs)
    assert pairs == tw.misscore4096_pairs(n=64)
    assert np.mean([len(a) for a, _b in pairs]) > 1000
