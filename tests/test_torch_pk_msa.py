"""The port's fused MSA (ops/poa_fused.fused_msa_batch, plain kernel
versions on the CPU) against the host C++ engine on the windows of
tests/test_poa_fused_kernel.py, plus the host fallbacks with their counter,
the dispatchers' refusals and the import check (no jax)."""
import os
import random
import subprocess
import sys
import textwrap

import pytest
import torch

from svscope_tpu.native.poa import poa_msa_batch_native
from svscope_tpu_torch.ops import poa_batch
from svscope_tpu_torch.ops import poa_fused as tpf
from svscope_tpu_torch.ops import poa_fused_kernel as tpk

from test_poa_fused_kernel import window

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGE_WINDOWS = [
    ["ACGT"],
    ["ACGT", "ACGT", "ACGT"],
    ["ACGT", "", "AGT"],
    ["", "ACGTA"],                 # graph inits on the second read
    ["A", "T"],
    ["ACGTACGT", "TGCATGCA"],
    [],
    ["", ""],
]


def host(windows):
    return [poa_msa_batch_native([w])[0] if w else ("", [])
            for w in windows]


@pytest.mark.parametrize("engine", ["lockstep", "seq"])
def test_fused_edge_cases_match_host(engine, monkeypatch):
    monkeypatch.setenv("SVSCOPE_PK_FUSION", engine)
    assert tpf.fused_msa_batch(EDGE_WINDOWS, device="cpu") == \
        host(EDGE_WINDOWS)


@pytest.mark.parametrize("engine", ["lockstep", "seq"])
def test_fused_random_windows_match_host(engine, monkeypatch):
    monkeypatch.setenv("SVSCOPE_PK_FUSION", engine)
    rng = random.Random(20260821)
    windows = [window(rng, rng.randint(3, 6), rng.randint(12, 40),
                      rng.choice([0.02, 0.1, 0.25]))
               for _ in range(12)]
    tpf.reset_counts()
    assert tpf.fused_msa_batch(windows, device="cpu") == host(windows)
    assert tpf.COUNTS["fallbacks"] == 0
    assert tpf.COUNTS["windows"] == 12


def test_poa_msa_batch_fused_engine():
    rng = random.Random(5)
    windows = [window(rng, 5, 30, 0.1) for _ in range(4)]
    assert poa_batch.poa_msa_batch(windows, use_device="fused",
                                   device="cpu") == host(windows)


def test_overflow_falls_back_to_host_and_is_counted():
    # 40 unrelated reads outgrow the node estimate: the overflow flag
    # sends the window to the C++ engine, with an exact result
    rng = random.Random(3)
    seqs = ["".join(rng.choice("ACGT") for _ in range(60))
            for _ in range(40)]
    assert tpf.estimate_nodes(seqs) <= 256
    ok = window(rng, 4, 30, 0.05)
    tpf.reset_counts()
    got = tpf.fused_msa_batch([seqs, ok], device="cpu")
    assert got == host([seqs, ok])
    assert tpf.COUNTS["fallbacks"] == 1 and tpf.COUNTS["windows"] == 2


def test_non_acgtn_and_oversize_windows_fall_back():
    iupac = ["ACGRTACGT", "ACGRTACT", "ACGRTAGGT"]
    too_long = ["ACGT" * 520, "ACGT" * 519]          # past the L ladder
    ok = ["ACGTAC", "ACGAC"]
    tpf.reset_counts()
    got = tpf.fused_msa_batch([iupac, too_long, ok], device="cpu")
    assert got == host([iupac, too_long, ok])
    assert tpf.COUNTS["fallbacks"] == 2 and tpf.COUNTS["windows"] == 1


def test_window_bytes_and_chunking(monkeypatch):
    # bench bucket and heavy bucket footprints; a tiny budget splits a
    # bucket into one-window chunks with identical results
    assert 2 << 20 < tpf.window_bytes(1025, 512, 32) < 4 << 20
    assert 8 << 20 < tpf.window_bytes(3073, 512, 512) < 12 << 20
    rng = random.Random(8)
    windows = [window(rng, 4, 24, 0.1) for _ in range(3)]
    monkeypatch.setattr(tpf, "BUDGET_BYTES", 1)
    tpf.reset_counts()
    assert tpf.fused_msa_batch(windows, device="cpu") == host(windows)
    assert tpf.COUNTS["chunks"] == 3


def test_fusion_engine_is_read_at_call_time(monkeypatch):
    monkeypatch.delenv("SVSCOPE_PK_FUSION", raising=False)
    assert tpk.fusion_engine() == "lockstep"
    monkeypatch.setenv("SVSCOPE_PK_FUSION", "seq")
    assert tpk.fusion_engine() == "seq"
    monkeypatch.setenv("SVSCOPE_PK_FUSION", "bogus")
    with pytest.raises(ValueError):
        tpk.fusion_engine()


def test_dispatchers_refuse_other_devices():
    meta = torch.empty((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tpk.align_tb(meta, meta, meta, meta, meta[:, 0], meta[:, 0])
    st = tpk.GraphState.empty(2, 4, "meta")
    with pytest.raises(ValueError):
        tpk.fusion(meta, meta, meta[:, 0], meta, meta, st)
    cpu = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        tpk.align_tb_cuda(cpu, cpu, cpu, cpu, cpu[:, 0], cpu[:, 0])
    with pytest.raises(ValueError):
        tpk.fusion_cuda(cpu, cpu, cpu[:, 0], cpu, cpu,
                        tpk.GraphState.empty(2, 4, "cpu"))
    launches = dict(tpk.LAUNCHES)
    tpf.fused_msa_batch([["ACGT", "ACT"]], device="cpu")
    assert tpk.LAUNCHES == launches       # CPU tensors: plain versions


def test_fused_modules_never_import_jax():
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import torch
        torch.set_num_threads(1)
        from svscope_tpu_torch.ops import poa_fused, poa_fused_kernel
        got = poa_fused.fused_msa_batch([["ACGTAC", "ACGAC", "ACTAC"]],
                                        device="cpu")
        assert got[0][1][0].replace("-", "") == "ACGTAC", got
        assert sys.modules["jax"] is None
        print("ok")
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "ok"
