"""run_local_graph and the `localGraph` CLI of the port against the JAX
package's run_local_graph on the synthetic tumor/normal pair: the Raw.bed
files must be byte-identical.  Also proves the port never imports jax."""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from svscope_tpu.engine.localgraph import run_local_graph as jax_run
from svscope_tpu.parallel.dataparallel import set_data_mesh
from svscope_tpu_torch.engine.localgraph import run_local_graph

from synth import make_test_pair

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair_and_jax_bed(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pair"))
    ref, tumor, normal, recs, _ = make_test_pair(d)
    try:
        out = jax_run(recs, ref, [tumor], [normal], ["S"], ["S"],
                      os.path.join(d, "jax"), offset=50)
    finally:
        set_data_mesh(None)
    with open(out, "rb") as f:
        return (ref, tumor, normal, recs), f.read()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


@pytest.mark.parametrize("device_poa", [None, True])
def test_run_local_graph_byte_identical(pair_and_jax_bed, tmp_path,
                                        device_poa):
    (ref, tumor, normal, recs), want = pair_and_jax_bed
    out = run_local_graph(recs, ref, [tumor], [normal], ["S"], ["S"],
                          str(tmp_path), offset=50, device="cpu",
                          device_poa=device_poa)
    assert os.path.basename(out) == "S.vs.S.TandemRepeat.Raw.bed"
    with open(out, "rb") as f:
        assert f.read() == want


def test_run_local_graph_resume(pair_and_jax_bed, tmp_path):
    (ref, tumor, normal, recs), want = pair_and_jax_bed
    d = str(tmp_path)
    run_local_graph(recs[:1], ref, [tumor], [normal], ["S"], ["S"], d,
                    offset=50, device="cpu")
    out = run_local_graph(recs, ref, [tumor], [normal], ["S"], ["S"], d,
                          offset=50, device="cpu", continue_run=True)
    with open(out, "rb") as f:
        assert f.read() == want


def test_cli_local_graph_byte_identical(pair_and_jax_bed, tmp_path):
    (ref, tumor, normal, recs), want = pair_and_jax_bed
    bed = tmp_path / "windows.bed"
    bed.write_text("".join(r + "\n" for r in recs))
    out_dir = tmp_path / "out"
    res = subprocess.run(
        [sys.executable, "-m", "svscope_tpu_torch.cli", "localGraph",
         "--device", "cpu", "-w", str(bed), "-T", tumor, "-N", normal,
         "-t", "S", "-n", "S", "-r", ref, "-s", str(out_dir)],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert (out_dir / "S.vs.S.TandemRepeat.Raw.bed").read_bytes() == want


def test_cli_unported_options_raise(pair_and_jax_bed, tmp_path):
    from svscope_tpu_torch import cli
    (ref, tumor, normal, recs), _ = pair_and_jax_bed
    bed = tmp_path / "windows.bed"
    bed.write_text(recs[0] + "\n")
    base = ["localGraph", "--device", "cpu", "-w", str(bed), "-T", tumor,
            "-N", normal, "-t", "S", "-n", "S", "-r", ref, "-s",
            str(tmp_path / "o")]
    with pytest.raises(NotImplementedError):
        cli.main(base + ["--device-poa", "fused"])
    with pytest.raises(NotImplementedError):
        cli.main(base + ["--oversize-sharded"])


def test_port_never_imports_jax():
    """Block jax, import every module of the port, run a 4-window batch
    through the device-POA path (plain kernel version on the CPU)."""
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import svscope_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            svscope_tpu_torch.__path__, "svscope_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        assert "svscope_tpu_torch.ops.poa_align" in names
        from bench import make_window_payloads
        from svscope_tpu_torch.engine.localgraph import process_window_batch
        wins = make_window_payloads(4, np.random.default_rng(3))
        recs = process_window_batch(wins, device_poa=True, device="cpu")
        assert len(recs) == 4 and all(len(r) == 10 for r in recs)
        assert sys.modules["jax"] is None
        print("ok", len(names))
    """)
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith("ok")
